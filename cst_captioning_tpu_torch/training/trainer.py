"""One training stage, XE, WXE or CST (counterpart of the reference's
``training/trainer.py``, single device).

The stage runs an epoch loop over the training split: one update per
batch, validation at every epoch boundary (greedy decode by default,
``language_eval``'s scores; ``--eval_metric`` selects the model and
``--fast_val 1`` scores CIDEr and that metric only), a scored checkpoint
of the step at every epoch boundary (``training/checkpoint.py``), and an
early stop after ``max_patience`` epochs without improvement (not before
``min_epochs``).  The learning rate decays by ``learning_rate_decay_rate``
every ``learning_rate_decay_every`` epochs, counted in updates as the
reference counts them.

CST runs one of two paths (``rl_iteration``):

- ``--device_rewards 1`` (the default, as in the reference): the fused
  step (``steps.fused_cst_step``) with the on-device CIDEr-D tables built
  once here (``_setup_fused_rl``), rows in dataset video order;
- ``--device_rewards 0``: the host reward (``RewardComputer`` on the
  native C++ CIDEr-D, ``--native_cider 1``, or the Python one) driven by
  ``RewardPipeline`` at depth ``--overlap_rewards`` (2 by default).

The divergence guard (``--divergence_guard 1``, the default) folds a
finite-check into every update and counts bad steps on the host with a
lag of one step; after ``--divergence_max_bad`` consecutive bad steps the
stage rolls back to a host copy of the state taken at the last
checkpoint save, drops the pipeline's in-flight rollouts and re-seeds
the rollout noise (``rollout_seed``).

Resilience, after the reference's trainer:

- **resume.**  A stage started into a directory that holds checkpoints
  resumes from the newest verified step: parameters, the optimizer's
  count and moments, the states of the dropout and rollout-noise
  generators (the port's own hazard: the reference folds the step into a
  stateless key, the port draws from stateful device generators), the
  divergence guard's salt, the best score and its step, the patience and
  the validation history; then the loader replays the draws of the steps
  already taken (``CaptionLoader.skip_batches``).  A resumed stage ends
  bit-identical to an uninterrupted run of the same seed.  One exception,
  the reference's too: on the host-reward path (``--device_rewards 0``)
  a mid-epoch preemption drains the pipeline, which the uninterrupted
  run does not, so that path is bit-identical only when it is preempted
  at an epoch boundary.  A stage that already stopped early does nothing
  when it is run again.
- **saves.**  ``--save_every_steps`` and ``--save_interval_secs`` add
  recovery saves between epoch boundaries; each save refreshes the
  divergence guard's rollback snapshot and fsyncs ``metrics.jsonl``.
- **preemption.**  With a ``PreemptionHandler`` (``train.py`` installs
  one), SIGTERM or a first SIGINT is honored at the next step boundary:
  drain, a verified save unless the newest checkpoint already holds the
  step, then ``PreemptedExit`` (exit 75).
- **the watchdog.**  ``--wedge_timeout`` arms a ``ProgressWatchdog``
  before the first CUDA call; a loop that stops beating exits 124.
- **drills.**  ``--fault_plan`` (``resilience/faults.py``): ``preempt``
  sends this process a real SIGTERM, ``wedge`` blocks the loop,
  ``nan_grad`` feeds NaN inputs, ``ckpt_torn`` tears a saved step.
- **metrics.**  ``metrics.jsonl`` takes a train record every
  ``--log_every`` steps (the reference's keys) and a val record per
  epoch; ``telemetry.json`` on ``close()`` holds the counters, the
  checkpoint save and verify milliseconds, ``preempt_exit_ms`` and the
  kernels' launch counts of this process.
- ``--abort_on_negative_advantage_window``: the reference's five-step
  detector of the negative-advantage regime warns once, or raises
  ``NegativeAdvantageAbort`` (exit 4).

Data are in-memory synthetic splits (``data/synthetic.py``), drawn
through the ordered prefetcher (``--loader_workers`` threads; the
``loader_err`` drill fails a read, which it retries); with
``--device_feats 1`` every training video's features stay on the card
and batches gather them by ``Batch.video_ix``.  ``--use_bfloat16 1``
builds the model at ``dtype=bfloat16`` (parameters, gradients and
optimizer state stay float32) and draws the rollout noise in bfloat16;
features travel and reside in the dtype ``feat_dtype`` resolves from
``--bf16_feats`` (default: follow ``--use_bfloat16``).  Random streams are
explicit generators seeded from ``--seed``: the weights (CPU), the
dropout masks and the rollout noise (on the device).
"""

from __future__ import annotations

import logging
import os
import signal
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import default_device
from ..data.loader import (Batch, CaptionLoader, feat_dtype, host_feats,
                           prefetch_to_device)
from ..data.shapes import parse_feat_shapes
from ..data.synthetic import Split, SyntheticSpec, generate
from ..metrics.coco_eval import KNOWN_EVAL_METRICS, score_key
from ..metrics.consensus import normalize_weights
from ..metrics.tokenizer import tokenize_corpus
from ..models.captioner import CaptionModel
from ..ops import launch_counts_by_dtype
from ..ops.device_ciderd import (auto_ref_chunk, match_tensor_bytes,
                                 table_bytes)
from ..ops.sampling import gumbel_noise
from ..resilience.faults import FaultPlan
from ..resilience.guard import DivergenceGuard
from ..resilience.preemption import PreemptedExit, PreemptionHandler
from ..telemetry.registry import JsonlSink, MetricsRegistry
from ..utils.watchdog import ProgressWatchdog
from ..weights import init_like_flax_
from . import checkpoint
from .device_rewards import build_device_tables
from .evaluation import eval_split
from .pipeline import RewardPipeline
from .rewards import RewardComputer, host_scorer, scb_gt_value
from .state import Optimizer
from .steps import fused_cst_step, rl_grad_step, rollout, xe_step

log = logging.getLogger(__name__)

#: One completed update: (its step index, its metrics).
Completed = List[Tuple[int, Dict[str, Any]]]

#: The metrics of a train record in ``metrics.jsonl``, where the step has
#: them (the keys of the reference's records; ``lr`` and
#: ``captions_per_sec`` are added).
TRAIN_RECORD_KEYS = ("advantage", "baseline", "grad_norm", "loss", "reward",
                     "sample_len")


class NegativeAdvantageAbort(RuntimeError):
    """``--abort_on_negative_advantage_window 1`` and the detector fired;
    ``train.py`` maps it to exit 4."""


def rollout_seed(seed: int, salt: int = 0) -> int:
    """Seed of the rollout noise generator.  Salt 0 is ``seed + 1``; each
    divergence rollback bumps the salt, and salt k >= 1 adds
    ``(1_000_003 + k) << 32``, a seed no unsalted run of a 32-bit
    ``--seed`` uses: the port's counterpart of the reference's
    ``fold_in(rng, 1_000_003 + salt)``, a fresh noise stream for the
    replayed steps."""
    return seed + 1 + (((1_000_003 + salt) << 32) if salt else 0)


class PhaseMarks:
    """Named boundaries of a step, as CUDA events on a CUDA device (no
    host sync when recorded) or host clock readings on the CPU.  ``ms()``
    -> the time from each boundary to the next, keyed by the later
    boundary's name (it waits for the last event)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[Tuple[str, Any]] = []

    def __call__(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> Dict[str, float]:
        if self.cuda and self.marks:
            self.marks[-1][1].synchronize()
        return {b: (ea.elapsed_time(eb) if self.cuda else (eb - ea) * 1e3)
                for (_, ea), (b, eb) in zip(self.marks, self.marks[1:])}


def phase_ms(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Per-phase milliseconds of a CST step's metrics (both paths)."""
    out: Dict[str, float] = {}
    for marks in metrics.get("phase_marks", ()):
        out.update(marks.ms())
    return out


def build_splits(opt, train_features: bool = True) -> Tuple[Split, Split]:
    """The train and val splits of the options' synthetic spec; the train
    split carries consensus scores when WXE or the scb-gt baseline needs
    them.  ``train_features=False`` builds the train split for its
    vocabulary alone (evaluation and serving)."""
    shapes = parse_feat_shapes(opt.feat_shapes)

    def spec(n):
        return SyntheticSpec(
            num_videos=n, captions_per_video=opt.captions_per_video,
            max_len=opt.max_length, feat_dims=tuple(d for _, d in shapes),
            feat_times=tuple(t for t, _ in shapes), seed=opt.synthetic_seed,
            rich_vocab=opt.synthetic_rich_vocab)

    need_consensus = bool(opt.use_consensus_weights) or (
        opt.use_rl and opt.rl_baseline == "scb-gt")
    train = generate("train", spec(opt.synthetic_videos),
                     consensus=need_consensus and train_features,
                     features=train_features)
    val = generate("val", spec(opt.synthetic_val_videos), vocab=train.vocab,
                   consensus=False)
    return train, val


def build_model(opt, vocab_size: int, feat_dims) -> CaptionModel:
    return CaptionModel(
        vocab_size, feat_dims, embed_size=opt.input_encoding_size,
        hidden_size=opt.rnn_size, attn_size=opt.att_size,
        use_kernel_attention=bool(opt.pallas_attention),
        decode_kernel=opt.decode_kernel, drop_prob=opt.drop_prob,
        dtype=torch.bfloat16 if opt.use_bfloat16 else torch.float32)


class Trainer:
    """One stage on one device.  ``splits`` (train, val) may be passed in
    to skip building them from the options; ``preemption`` is the
    installed ``PreemptionHandler`` whose flag the loop honors (None: the
    loop reads no signal flag)."""

    def __init__(self, opt, splits: Optional[Tuple[Split, Split]] = None,
                 preemption: Optional[PreemptionHandler] = None):
        if opt.eval_metric not in KNOWN_EVAL_METRICS:
            # At start-up, not after the first epoch's validation scores
            # 0.0 for ever.
            raise ValueError(f"--eval_metric {opt.eval_metric!r} is not one "
                             f"of {KNOWN_EVAL_METRICS}")
        self.opt = opt
        self._preempt = preemption
        self.registry = registry = MetricsRegistry()
        self.registry.declare("preempt_signals", "preempt_saves",
                              "negative_advantage_aborts")
        self._sink_open = False
        # The loop's step, mirrored on the host for the watchdog thread.
        self._progress = progress = {"loop_step": -1}
        # Armed before the first CUDA call: a card that hangs while its
        # context is created must still end in 124.  describe and payload
        # read host state only, and close over the registry and
        # ``progress``, not the trainer: a trainer in no reference cycle
        # frees its device memory as soon as it is dropped.
        ck = os.path.abspath(opt.checkpoint_path)
        self._watchdog = ProgressWatchdog(
            opt.wedge_timeout,
            describe=lambda: (f"last loop step {progress['loop_step']}; "
                              f"checkpoints in {ck}"),
            heartbeat_path=os.path.join(ck, "heartbeat.json"),
            payload=lambda: {**progress, **registry.heartbeat_payload()}
        ).start()
        try:
            self._init(opt, splits)
        except BaseException:
            self._watchdog.stop()
            raise

    def _init(self, opt, splits) -> None:
        self._faults = FaultPlan.parse(opt.fault_plan)
        if self._faults is not None:
            self._faults.bind_metrics(self.registry)
            # Firings persist beside the checkpoints, so a drill that
            # kills its process does not fire again in its resume.
            os.makedirs(opt.checkpoint_path, exist_ok=True)
            self._faults.bind_state(os.path.join(
                opt.checkpoint_path, "fault_plan_state.jsonl"))
            log.warning("FAULT INJECTION ARMED: %s; this run breaks itself "
                        "on purpose", self._faults)
        self.device = default_device(opt.device)
        self.train_split, self.val_split = splits or build_splits(opt)
        self._watchdog.beat()
        self.vocab = self.train_split.vocab
        self.model = build_model(
            opt, self.vocab.size_with_pad,
            [f.shape[-1] for f in self.train_split.feats])
        init_like_flax_(self.model, torch.Generator().manual_seed(opt.seed))
        if opt.start_from:
            prev = checkpoint.load(opt.start_from)
            self.model.load_state_dict(prev["model"])
            log.info("warm-started from %s (step %s, score %s)",
                     opt.start_from, prev["step"], prev["best_score"])
        self.model.to(self.device)
        self._watchdog.beat()
        self.feat_dtype = feat_dtype(opt.use_bfloat16, opt.bf16_feats)
        log.info("compute dtype %s (parameters float32), features %s",
                 self.model.dtype, self.feat_dtype)

        weights = None
        if opt.use_consensus_weights:
            weights = normalize_weights(self.train_split.consensus,
                                        temperature=opt.consensus_temperature)
        self.loader = CaptionLoader(self.train_split, opt.batch_size,
                                    seq_per_img=opt.seq_per_img,
                                    seed=opt.seed, consensus_weights=weights,
                                    fault_plan=self._faults)
        #: The prefetched training stream, started at the first batch.
        self._batches: Optional[Iterator[Batch]] = None
        self.val_loader = CaptionLoader(
            self.val_split, opt.eval_batch_size or opt.batch_size,
            seq_per_img=1, shuffle=False)
        self.optimizer = Optimizer(
            self.model.parameters(), optim=opt.optim,
            learning_rate=opt.learning_rate, grad_clip=opt.grad_clip,
            decay_rate=opt.learning_rate_decay_rate,
            decay_every_steps=(opt.learning_rate_decay_every
                               * self.loader.batches_per_epoch))
        self.dropout_gen = torch.Generator(self.device).manual_seed(opt.seed)
        self._rng_salt = 0
        self.noise_gen = torch.Generator(self.device).manual_seed(
            rollout_seed(opt.seed))
        self.noise = gumbel_noise(self.noise_gen, dtype=self.model.dtype)
        self.guard = (DivergenceGuard(opt.divergence_max_bad,
                                      opt.divergence_max_rollbacks)
                      if opt.divergence_guard else None)
        self._good_state: Optional[Tuple[int, dict, dict]] = None
        self.feat_tables = (self._load_device_feats() if opt.device_feats
                            else None)
        self.reward_computer: Optional[RewardComputer] = None
        #: The CST reward's scorer: "device" (the fused path), "native"
        #: or "python" (the host path); None outside CST.
        self.cst_scorer: Optional[str] = None
        self.pipeline: Optional[RewardPipeline] = None
        self.fused: Optional[Dict[str, Any]] = None
        #: What the fused path's setup built (times, bytes, the chunking).
        self.reward_setup: Dict[str, Any] = {}
        if opt.use_rl:
            if opt.device_rewards:
                self._setup_fused_rl()
            else:
                self._setup_host_rl()
        self._watchdog.beat()
        self.step = 0
        self.last_rollout_steps = 0
        self.history: List[Dict[str, float]] = []
        self.best, self.best_step, self.patience = float("-inf"), None, 0
        self._captions = 0          # dispatched since the last train record
        self._last_saved_step = -1
        self._last_save_monotonic = time.monotonic()
        self.ckpt = checkpoint.CheckpointManager(
            opt.checkpoint_path, max_to_keep=opt.max_checkpoints,
            fault_plan=self._faults, registry=self.registry)
        resume = self.ckpt.latest_verified_step
        if resume is not None:
            latest = self.ckpt.latest_step
            if latest != resume:
                log.warning("newest checkpoint (step %d) failed integrity "
                            "verification; resuming from the last verified "
                            "step %d instead", latest, resume)
            self._restore(self.ckpt.load(step=resume))
            log.info("resumed from step %d in %s", resume,
                     opt.checkpoint_path)
        elif self.ckpt.latest_step is not None:
            log.warning("every checkpoint in %s failed integrity "
                        "verification; starting this stage from scratch",
                        opt.checkpoint_path)

    def _restore(self, payload: Dict[str, Any]) -> None:
        """Resume from a checkpoint payload: the state, the generators,
        the run's bookkeeping, then the loader's stream and the rollback
        snapshot."""
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        self.dropout_gen.set_state(payload["rng"]["dropout"])
        self.noise_gen.set_state(payload["rng"]["noise"])
        self._rng_salt = payload["rng"]["salt"]
        run = payload["run"]
        self.best, self.best_step = run["best"], run["best_step"]
        self.patience, self.history = run["patience"], run["history"]
        self.step = self._last_saved_step = payload["step"]
        self.loader.skip_batches(self.step)
        self._snapshot_good_state(payload)

    # -- set-up --------------------------------------------------------------

    def _load_device_feats(self) -> List[torch.Tensor]:
        """Every training video's features on the device, one tensor per
        modality in ``feat_dtype`` (cast on the host first), refused over
        ``--device_feats_max_gb``."""
        itemsize = torch.finfo(self.feat_dtype).bits // 8
        size = sum(f.size * itemsize for f in self.train_split.feats)
        budget = float(self.opt.device_feats_max_gb) * 1e9
        if size > budget:
            raise ValueError(
                f"--device_feats table is {size / 1e9:.1f} GB "
                f"({self.train_split.num_videos} videos), over the "
                f"--device_feats_max_gb {budget / 1e9:.1f} GB budget: use "
                "--device_feats 0 or raise the budget if the card fits it")
        tables = [t.to(self.device) for t in
                  host_feats(self.train_split.feats, self.feat_dtype)]
        log.info("device_feats: %d videos x %d modalities on the device "
                 "(%.3f GB, %s)", self.train_split.num_videos, len(tables),
                 size / 1e9, self.feat_dtype)
        return tables

    def _setup_host_rl(self) -> None:
        """The host reward: the native C++ CIDEr-D under ``--native_cider
        1`` (the default), the Python scorer when it is 0 or the library
        cannot be built (a warning, as the reference does)."""
        opt = self.opt
        refs = tokenize_corpus(self.train_split.refs)
        scorer, self.cst_scorer = host_scorer(refs, self.vocab.word_to_ix,
                                              native=bool(opt.native_cider))
        self.registry.set_info("cst_scorer", self.cst_scorer)
        self.reward_computer = RewardComputer(
            self.vocab, scorer,
            refs, seq_per_img=opt.seq_per_img, baseline=opt.rl_baseline,
            consensus_scores=self.train_split.consensus,
            scb_captions=opt.scb_captions)
        self.pipeline = RewardPipeline(
            self._pipeline_rollout, self._pipeline_grad,
            lambda ctx, s, g: self.reward_computer(ctx["video_ids"], s, g),
            depth=opt.overlap_rewards)
        log.info("RL reward: host CIDEr-D (%s scorer), pipeline depth %d",
                 self.cst_scorer, self.pipeline.depth)

    def _setup_fused_rl(self) -> None:
        """The fused path's tables: the reference CIDEr-D tables in
        dataset video order (``Batch.video_ix`` indexes them), the scb-gt
        baseline per video, and the match envelope with its ``ref_chunk``
        against ``--device_cider_chunk_mb``."""
        opt = self.opt
        split = self.train_split
        refs = tokenize_corpus(split.refs)
        try:
            refs = {v: refs[v] for v in split.video_ids}
        except KeyError as e:
            raise ValueError(
                f"video {e.args[0]!r} has no reference captions; "
                "--device_rewards needs references for every training video"
            ) from None
        t0 = time.perf_counter()
        corpus, tables, _ = build_device_tables(
            refs, self.vocab.word_to_ix, device=self.device)
        build_s = time.perf_counter() - t0
        scb_gt = None
        if opt.rl_baseline == "scb-gt":
            if split.consensus is None:
                raise ValueError("scb-gt baseline needs consensus scores")
            missing = [v for v in split.video_ids
                       if v not in split.consensus]
            if missing:
                log.warning("scb-gt baseline: %d video(s) have no consensus "
                            "scores (e.g. %s); their baseline is 0.0",
                            len(missing), missing[:3])
            scb_gt = torch.tensor(
                [scb_gt_value(split.consensus.get(v, [0.0]),
                              opt.scb_captions) for v in split.video_ids],
                dtype=torch.float32, device=self.device)
        n_hyps = opt.batch_size * opt.seq_per_img
        budget = int(float(opt.device_cider_chunk_mb) * 2 ** 20)
        envelope = match_tensor_bytes(n_hyps, opt.max_length, tables)
        ref_chunk = auto_ref_chunk(n_hyps, opt.max_length, tables,
                                   budget_bytes=budget)
        self.fused = {"corpus": corpus, "tables": tables, "scb_gt": scb_gt,
                      "ref_chunk": ref_chunk}
        self.cst_scorer = "device"
        self.registry.set_info("cst_scorer", self.cst_scorer)
        self.reward_setup = {
            "table_build_s": build_s,
            "table_bytes": table_bytes(corpus, tables),
            "slots": corpus.key1.shape[0],
            "ngrams": int(corpus.occupied.sum()),
            "refs_grams": tuple(tables.slot.shape[1:]),
            "envelope_bytes": envelope, "budget_bytes": budget,
            "ref_chunk": ref_chunk}
        log.info(
            "device rewards: tables for %d videos (%d x %d ref n-grams, "
            "%d n-grams in %d df slots, %.1f MiB) built in %.1f s; match "
            "transient %.1f MiB (batch %d x %d, hyp positions for length "
            "%d)%s",
            tables.slot.shape[0], tables.slot.shape[1], tables.slot.shape[2],
            self.reward_setup["ngrams"], corpus.key1.shape[0],
            self.reward_setup["table_bytes"] / 2 ** 20,
            build_s, envelope / 2 ** 20, opt.batch_size, opt.seq_per_img,
            opt.max_length,
            (f"; chunking over refs at {ref_chunk} to stay under "
             f"{budget / 2 ** 20:.0f} MiB" if ref_chunk is not None
             else " (within budget, one shot)"))

    # -- one update ----------------------------------------------------------

    def _feats(self, batch: Batch) -> List[torch.Tensor]:
        if self.feat_tables is not None:
            ix = torch.from_numpy(batch.video_ix).to(self.device)
            return [t[ix] for t in self.feat_tables]
        return [t.to(self.device)
                for t in host_feats(batch.feats, self.feat_dtype)]

    def xe_iteration(self, batch: Batch) -> Completed:
        """One XE/WXE update; metrics stay on the device."""
        out = xe_step(self.model, self.optimizer, self._feats(batch),
                      torch.from_numpy(batch.labels).long().to(self.device),
                      torch.from_numpy(batch.weights).to(self.device),
                      self.opt.seq_per_img, self.dropout_gen,
                      guard=self.guard is not None)
        self.step += 1
        return [(self.step - 1, out)]

    def _pipeline_rollout(self, feats, ctx):
        marks = PhaseMarks(self.device)
        marks("start")
        out = rollout(self.model, feats, self.opt.max_length,
                      self.opt.seq_per_img, self.noise,
                      temperature=self.opt.temperature,
                      greedy_baseline=self.opt.rl_baseline == "greedy",
                      decode_chunk=self.opt.decode_chunk)
        marks("rollout")
        ctx.update(marks=marks, rollout_steps=out[2])
        return out

    def _pipeline_grad(self, feats, sampled, advantage, ctx):
        marks = PhaseMarks(self.device)
        marks("start")
        m = rl_grad_step(self.model, self.optimizer, feats, sampled,
                         torch.from_numpy(advantage).to(self.device),
                         self.opt.seq_per_img, guard=self.guard is not None)
        marks("grad")
        m.update(phase_marks=(ctx["marks"], marks),
                 rollout_steps=ctx["rollout_steps"])
        return m

    def rl_iteration(self, batch: Batch) -> Completed:
        """One CST dispatch: the fused step (``--device_rewards 1``), or a
        push into the host-reward pipeline, which completes 0 or 1 older
        steps.  -> the completed steps.  ``self.last_rollout_steps`` is
        the decode steps of the rollout dispatched here."""
        opt = self.opt
        feats = self._feats(batch)
        step = self.step
        self.step += 1
        if self.fused is None:
            ctx = {"step": step, "video_ids": batch.video_ids}
            done = self.pipeline.push(feats, ctx)
            self.last_rollout_steps = ctx["rollout_steps"]
            return [(c["step"], m) for c, m in done]
        marks = PhaseMarks(self.device)
        m = fused_cst_step(
            self.model, self.optimizer, feats,
            torch.from_numpy(batch.video_ix).to(self.device), self.noise,
            self.fused["corpus"], self.fused["tables"], opt.max_length,
            opt.seq_per_img, baseline=opt.rl_baseline,
            temperature=opt.temperature,
            scb_gt_baseline=self.fused["scb_gt"],
            ref_chunk=self.fused["ref_chunk"], guard=self.guard is not None,
            decode_chunk=opt.decode_chunk, mark=marks)
        m["phase_marks"] = (marks,)
        self.last_rollout_steps = m["rollout_steps"]
        return [(step, m)]

    def next_batch(self) -> Batch:
        """The next batch of the training stream: the loader through the
        ordered prefetcher (``--loader_workers`` threads, features cast on
        the host there; under ``--device_feats 1`` neither read nor
        threaded: ``_feats`` gathers them on the device), which starts at
        the first call."""
        if self._batches is None:
            self._batches = prefetch_to_device(
                self.loader, size=2,
                feat_dtype=self.feat_dtype,
                registry=self.registry, workers=self.opt.loader_workers,
                read_feats=self.feat_tables is None)
        return next(self._batches)

    def iteration(self) -> Completed:
        """Dispatch one update; -> the updates completed by this call
        (one, or for the host-reward pipeline 0 or 1)."""
        batch = self._nan_fault_inputs(self.step, self.next_batch())
        self._captions += self.opt.batch_size * self.opt.seq_per_img
        if self.opt.use_rl:
            return self.rl_iteration(batch)
        return self.xe_iteration(batch)

    def _nan_fault_inputs(self, step: int, batch: Batch) -> Batch:
        """``nan_grad``: when the plan covers ``step``, the step's host
        inputs become NaN (XE: the caption weights, which multiply into
        the loss; CST: the features), so the device computes a
        non-finite loss and gradient."""
        if self._faults is None or not self._faults.pending("nan_grad"):
            return batch
        if self.opt.use_rl and self.feat_tables is not None:
            raise RuntimeError("nan_grad fault injection needs host-"
                               "streamed features on the CST path; rerun "
                               "the drill with --device_feats 0")
        if not self._faults.fire("nan_grad", step):
            return batch
        log.warning("FAULT: nan_grad at step %d; feeding NaN inputs",
                    step + 1)
        if self.opt.use_rl:
            batch.feats = [torch.full_like(torch.as_tensor(f), float("nan"))
                           for f in batch.feats]
        else:
            batch.weights = np.full_like(batch.weights, np.nan)
        return batch

    def drain(self) -> Completed:
        """Complete the host-reward pipeline's in-flight steps."""
        if self.pipeline is None:
            return []
        return [(c["step"], m) for c, m in self.pipeline.drain()]

    # -- the divergence guard --------------------------------------------------

    def _snapshot_good_state(self, payload: Dict[str, Any]) -> None:
        """Keep the host copy of the state just saved as the rollback
        target (no-op without the guard)."""
        if self.guard is not None:
            self._good_state = (payload["step"], payload["model"],
                                payload["optimizer"])

    def _handle_divergence(self, failed_step: int) -> Optional[int]:
        """Roll back after ``--divergence_max_bad`` consecutive bad steps:
        restore the last snapshot, drop the pipeline's in-flight rollouts,
        re-seed the rollout noise, and return the step to replay from, or
        None when there is no snapshot yet (the guard's skips kept the
        current state finite: continue from it on fresh noise).
        ``DivergenceUnrecoverable`` propagates once the rollback budget is
        spent."""
        self.guard.note_rollback()
        if self.pipeline is not None:
            dropped = self.pipeline.abort()
            if dropped:
                log.warning("divergence rollback: dropped %d in-flight "
                            "rollout(s) drawn from the diverged parameters",
                            dropped)
        self._rng_salt += 1
        self.noise_gen.manual_seed(rollout_seed(self.opt.seed,
                                                self._rng_salt))
        if self._good_state is None:
            log.warning("divergence guard: rollback requested at step %d but "
                        "no checkpoint exists yet; continuing from the "
                        "current (skip-protected) state with re-seeded "
                        "rollout noise (salt %d)", failed_step + 1,
                        self._rng_salt)
            return None
        good_step, model_state, opt_state = self._good_state
        self.model.load_state_dict(model_state)
        self.optimizer.load_state_dict(opt_state)
        log.warning("divergence guard: rolled back from step %d to the "
                    "known-good state of step %d (rollback %d/%d); replaying "
                    "with re-seeded rollout noise (salt %d)",
                    failed_step + 1, good_step, self.guard.rollbacks,
                    self.guard.max_rollbacks, self._rng_salt)
        return good_step

    # -- validation, checkpoints, the loop -----------------------------------

    def validate(self) -> Dict[str, float]:
        """Score the val split.  ``--fast_val 1`` scores CIDEr and the
        selection metric only (selecting on a metric that is not scored
        would give every epoch 0.0 and blind the early stop)."""
        scorers = None
        if self.opt.fast_val:
            sel = ("Bleu" if self.opt.eval_metric.startswith("Bleu")
                   else self.opt.eval_metric)
            scorers = tuple(dict.fromkeys(("CIDEr", sel)))
        _, scores = eval_split(
            self.model, self.val_loader, self.vocab, self.opt.max_length,
            self.val_split.refs, beam_size=self.opt.val_beam_size,
            length_norm=self.opt.length_norm, scorers=scorers,
            decode_chunk=self.opt.decode_chunk)
        return scores

    def checkpoint_payload(self, score: float = 0.0) -> Dict[str, Any]:
        """Everything a resume needs, as host tensors and plain values."""
        return {"model": {k: v.detach().cpu().clone()
                          for k, v in self.model.state_dict().items()},
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "score": score,
                "best_score": self.best,
                "rng": {"dropout": self.dropout_gen.get_state(),
                        "noise": self.noise_gen.get_state(),
                        "salt": self._rng_salt},
                "run": {"best": self.best, "best_step": self.best_step,
                        "patience": self.patience,
                        "history": list(self.history)},
                "opt": {k: v for k, v in vars(self.opt).items()
                        if isinstance(v, (str, int, float, type(None)))}}

    def _after_save(self, payload: Dict[str, Any]) -> None:
        """Bookkeeping after every durable save: the rollback snapshot,
        the save cadence's clock, and ``metrics.jsonl`` made durable with
        the state it describes."""
        self._last_saved_step = payload["step"]
        self._last_save_monotonic = time.monotonic()
        self._snapshot_good_state(payload)
        self.registry.flush(fsync=True)
        self._watchdog.beat()

    def _save_recovery(self, verify: bool = False) -> None:
        payload = self.checkpoint_payload()
        self.ckpt.save_recovery(self.step, payload, verify=verify)
        self._after_save(payload)

    def _note(self, completed: Completed, total: int, clock: list) -> None:
        """Queue each completed step's ``bad_step`` with the guard; every
        ``--log_every``-th step, a train record in ``metrics.jsonl``, a
        log line and the negative-advantage check."""
        opt = self.opt
        for k, m in completed:
            if self.guard is not None:
                self.guard.observe(k, m.get("bad_step"))
            if not (opt.log_every and (k + 1) % opt.log_every == 0):
                continue
            rec = {key: float(m[key]) for key in TRAIN_RECORD_KEYS
                   if key in m}
            rec["lr"] = float(self.optimizer.lr(torch.tensor(float(k))))
            secs = time.perf_counter() - clock[0]
            clock[0] = time.perf_counter()
            if self._captions:      # 0 for the later steps of a drain
                rec["captions_per_sec"] = self._captions / max(secs, 1e-9)
                self._captions = 0
            self.registry.log_step(k + 1, "train", rec)
            rl = ""
            if opt.use_rl:
                rl = (f" reward {rec['reward']:.4f} advantage "
                      f"{rec['advantage']:.4f} phases (ms) "
                      + ", ".join(f"{name} {ms:.1f}"
                                  for name, ms in phase_ms(m).items()))
            log.info("step %d/%d lr %.3g loss %.4f grad_norm %.3f "
                     "%.1f ms/step%s", k + 1, total, rec["lr"], rec["loss"],
                     rec["grad_norm"], 1e3 * secs / opt.log_every, rl)
            self._check_advantage_regime(rec)

    # Negative-advantage regime detector, after the reference's: with a
    # greedy baseline, samples that score below the greedy decode on every
    # logged step of a window give every advantage a negative sign, and
    # REINFORCE only pushes probability away from typical sequences.
    _ADV_WARN_STEPS = 5

    def _check_advantage_regime(self, m: Dict[str, float]) -> None:
        if "advantage" not in m or getattr(self, "_adv_warned", False):
            return
        hist = getattr(self, "_adv_history", [])
        hist.append((m["advantage"], m.get("reward", 0.0),
                     m.get("baseline", 0.0)))
        self._adv_history = hist = hist[-self._ADV_WARN_STEPS:]
        if len(hist) < self._ADV_WARN_STEPS:
            return
        adv = [a for a, _, _ in hist]
        if max(adv) < 0 and np.mean(adv) < -0.05:
            rew = np.mean([r for _, r, _ in hist])
            base = np.mean([b for _, _, b in hist])
            msg = (
                "advantage has been negative on every logged step so far "
                "(mean %.3f; sampled reward %.3f vs baseline %.3f): the "
                "baseline dominates the samples, so REINFORCE is only "
                "suppressing typical sequences and the policy is likely "
                "to degenerate.  Remedies: --rl_baseline scb-sample/"
                "scb-gt (centred by construction), lower --temperature, "
                "or a lower --learning_rate." % (np.mean(adv), rew, base))
            self._adv_warned = True
            # getattr, not self.opt: the detector also runs over a bare
            # namespace.
            opt = getattr(self, "opt", None)
            if opt is not None and getattr(
                    opt, "abort_on_negative_advantage_window", 0):
                registry = getattr(self, "registry", None)
                if registry is not None:
                    registry.inc("negative_advantage_aborts")
                raise NegativeAdvantageAbort(msg)
            log.warning(msg)

    def _honor_preemption(self, total: int, clock: list) -> None:
        """The step-boundary half of preemption: drain, a verified save
        unless the newest checkpoint already holds this step, the
        counters, then ``PreemptedExit``."""
        h = self._preempt
        self.registry.inc("preempt_signals", h.drain_signal_count())
        saved = self.step != self._last_saved_step
        if saved:
            self._note(self.drain(), total, clock)
            self._save_recovery(verify=True)
            self.registry.inc("preempt_saves")
        if h.signal_monotonic is not None:
            self.registry.set_gauge(
                "preempt_exit_ms",
                (time.monotonic() - h.signal_monotonic) * 1e3)
        self.registry.flush(fsync=True)
        log.warning("preemption (%s) honored at step boundary %d: %s; "
                    "exiting with the resumable code", h.signal_name,
                    self.step, "verified checkpoint saved" if saved
                    else "checkpoint already current")
        raise PreemptedExit(self.step, h.signal_name or "signal", saved)

    def _step_faults(self, step: int) -> None:
        """The loop's own drill sites, at the boundary before ``step``."""
        if self._faults.fire("preempt", step):
            log.warning("FAULT: preempt at step %d; sending SIGTERM to pid "
                        "%d (the next boundary must save and exit 75)",
                        step + 1, os.getpid())
            os.kill(os.getpid(), signal.SIGTERM)
        if self._faults.fire("wedge", step):
            log.critical("FAULT: wedge at step %d; blocking the train loop "
                         "(the watchdog must exit 124)", step + 1)
            while True:
                time.sleep(3600)

    def _stopped_early(self, bpe: int) -> bool:
        """The stage's directory says it already stopped early."""
        opt, infos = self.opt, self.ckpt.infos
        return bool(opt.max_patience
                    and int(infos.get("patience") or 0) >= opt.max_patience
                    and int(infos.get("last_step") or 0) // bpe
                    >= opt.min_epochs)

    def _result(self) -> Dict[str, Any]:
        return {"best_score": None if self.best == float("-inf")
                else self.best,
                "best_step": self.best_step, "last_step": self.step,
                "history": self.history}

    def train(self) -> Dict[str, Any]:
        opt = self.opt
        bpe = self.loader.batches_per_epoch
        total = opt.max_epochs * bpe
        if self._stopped_early(bpe):
            log.info("early stop already reached (%s epochs without %s "
                     "improvement); nothing to train",
                     self.ckpt.infos.get("patience"), opt.eval_metric)
            return self._result()
        if not self._sink_open:
            self.registry.add_sink(JsonlSink(os.path.join(
                opt.checkpoint_path, "metrics.jsonl")))
            self._sink_open = True
        clock = [time.perf_counter()]
        self._last_save_monotonic = time.monotonic()
        while self.step < total:
            # Each pass of the loop means the previous dispatch, drain,
            # validation and save returned.
            self._watchdog.beat()
            self._progress["loop_step"] = self.step
            if self._preempt is not None and self._preempt.requested:
                self._honor_preemption(total, clock)
            if self._faults is not None:
                self._step_faults(self.step)
            self._note(self.iteration(), total, clock)
            if self.guard is not None and self.guard.poll():
                rewind = self._handle_divergence(self.step - 1)
                if rewind is not None:
                    self.step = rewind
                    continue
            if self.step % bpe:
                due = ((opt.save_every_steps
                        and self.step % opt.save_every_steps == 0)
                       or (opt.save_interval_secs > 0
                           and time.monotonic() - self._last_save_monotonic
                           >= opt.save_interval_secs))
                if due:
                    self._note(self.drain(), total, clock)
                    self._save_recovery()
                continue
            # Epoch boundary: complete every in-flight step and reap every
            # bad-step flag before validating and saving.
            self._note(self.drain(), total, clock)
            if self.guard is not None and self.guard.flush():
                rewind = self._handle_divergence(self.step - 1)
                if rewind is not None:
                    self.step = rewind
                    continue
            scores = self.validate()
            self._watchdog.beat()
            score = scores.get(score_key(opt.eval_metric), 0.0)
            self.history.append({"step": self.step, **scores})
            self.registry.log_step(self.step, "val", scores)
            log.info("val @ step %d (epoch %d): %s", self.step,
                     self.step // bpe, scores)
            if score > self.best:
                self.best, self.best_step, self.patience = score, self.step, 0
            else:
                self.patience += 1
            payload = self.checkpoint_payload(score)
            self.ckpt.save(self.step, payload, score=score, extra={
                "opt": vars(opt), "val_scores": scores,
                "patience": self.patience, "history": self.history})
            self._after_save(payload)
            if (opt.max_patience and self.patience >= opt.max_patience
                    and self.step // bpe >= opt.min_epochs):
                log.info("early stop: no %s improvement in %d epochs",
                         opt.eval_metric, self.patience)
                break
        self._note(self.drain(), total, clock)
        if self.guard is not None:
            self.guard.flush()
            if self.guard.total_skipped:
                log.warning("divergence guard summary: %d step(s) skipped as "
                            "non-finite, %d rollback(s)",
                            self.guard.total_skipped, self.guard.rollbacks)
        self.registry.flush(fsync=True)
        return self._result()

    def close(self) -> None:
        """Join the prefetch workers, write ``telemetry.json`` (when
        ``train`` ran) with this process's kernel launches, close
        ``metrics.jsonl`` and stop the watchdog."""
        try:
            if self._batches is not None:
                self._batches.close()
            if self._sink_open:
                for key, n in launch_counts_by_dtype().items():
                    self.registry.set_gauge(f"launches/{key}", n)
                self.registry.write_snapshot(os.path.join(
                    self.opt.checkpoint_path, "telemetry.json"))
            self.registry.close()
        finally:
            self._watchdog.stop()
