"""One training stage, XE, WXE or CST (counterpart of the reference's
``training/trainer.py``).

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
  checkpoint save and verify milliseconds, ``preempt_exit_ms``, the
  kernels' launch counts of this process and, under ``meta``, the
  tuned-default provenance (``tuned_config``).
- **telemetry** (``telemetry/``, the reference's flags): ``--trace_dir``
  writes host spans as Chrome traces (the loop's ``data_wait``,
  ``compute``, ``score``, ``ckpt`` and ``fetch_wait`` phases, each
  worker's ``prefetch_assemble``, each ``ckpt_commit``);
  ``--step_timing`` (on under ``--trace_dir``) adds the interval's
  exclusive ``<phase>_ms`` gauges and the MFU fields at the run's shapes
  to every train record; ``--profile_dir`` runs ``torch.profiler`` (CPU
  and CUDA) over loop steps ``[--profile_start, +--profile_steps)`` (or
  ``A:B``) and writes a Chrome trace there, with the window's kernel
  launches in ``telemetry.json``; ``--tensorboard 1`` writes the records
  as scalars under ``<checkpoint_path>/tb``.  Without these flags every
  hook is one is-None check.
- ``--debug_nans 1``: torch's anomaly mode with its NaN check (a backward
  that returns a non-finite value raises and names its operation) and a
  host check of every step's loss: the run raises at the first
  non-finite value.  It turns the divergence guard off, with a warning.
- ``--abort_on_negative_advantage_window``: the reference's five-step
  detector of the negative-advantage regime warns once, or raises
  ``NegativeAdvantageAbort`` (exit 4).

Data parallelism (``parallel/``): in a process group of W ranks, one
device each (``train.py``'s ``--num_processes``, ``--process_id`` and
``--coordinator_address``), ``--batch_size`` is the global batch; every
rank draws the same global plan and assembles its own rows of it
(``CaptionLoader(dp_rank=...)``), and every step is global-view
(``parallel.dp.DataParallel``): the losses, tokens and parameters of
world size 1.  The CST metrics are the global batch's on both paths (on
the host-reward path each rank scores its own rows and
``DataParallel.host_means`` all-reduces the sums), so every rank's
negative-advantage check takes the same decision.  A batch W does not
divide is refused (the reference shrinks its mesh to a divisor; a
process group cannot shrink), and so is
``--data_shards`` (each rank already holds its own rows) and
``--fault_plan`` (its drills act on one process).  The validation loader
strides the split by rank and the predictions are gathered, so every
rank scores the whole split.  Rank 0 alone writes: ``metrics.jsonl``,
``telemetry.json``, TensorBoard, the heartbeat and the checkpoints, the
other ranks waiting at a barrier while it saves; all ranks resume from
the same checkpoint.  A preemption signal on any rank stops every rank
at the same step boundary.

Data are the split files of ``--train_*`` and ``--val_*``
(``data/dataset.py``: memory-mapped ``.npy`` features, or in RAM with
``--preload_feats 1``), or in-memory synthetic splits
(``data/synthetic.py``) when no file is given; WXE weights and the scb-gt
baseline come from the consensus pickle ``--train_bcmrscores_pkl`` (the
synthetic split's own scores without it), and ``--train_cached_tokens``
gives both CST rewards their corpus df.  Batches are drawn through the
ordered prefetcher (``--loader_workers`` threads; the ``loader_err``
drill fails a read, which it retries); with ``--device_feats 1`` every
training video's features stay on the card, uploaded in row chunks of
``--device_feats_upload_mb``, and batches gather them by
``Batch.video_ix``.  ``--start_from`` takes a train-CLI directory or an
exported checkpoint (``weights.py``).  ``--use_bfloat16 1``
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
import torch.distributed as dist

from .. import default_device
from ..data.dataset import CaptionDataset, SplitData, paths_from_opt
from ..data.loader import (Batch, CaptionLoader, feat_dtype, host_feats,
                           prefetch_to_device)
from ..data.sharding import resolve_shard_spec
from ..data.shapes import parse_feat_shapes
from ..data.synthetic import SyntheticSpec, generate
from ..metrics.ciderd import load_corpus_df
from ..metrics.coco_eval import KNOWN_EVAL_METRICS, score_key
from ..metrics.consensus import load_consensus, normalize_weights
from ..metrics.tokenizer import tokenize_corpus
from ..models.captioner import CaptionModel
from ..ops import launch_counts, launch_counts_by_dtype
from ..ops.device_ciderd import (auto_ref_chunk, match_tensor_bytes,
                                 table_bytes)
from ..ops.sampling import gumbel_noise
from ..parallel.dp import DataParallel
from ..resilience.faults import FaultPlan
from ..resilience.guard import DivergenceGuard
from ..resilience.preemption import PreemptedExit, PreemptionHandler
from ..telemetry import (JsonlSink, ScalarWriterSink, Telemetry,
                         caption_step_flops, mfu_fields)
from ..utils.watchdog import ProgressWatchdog
from ..weights import (exported_model_opts, from_flax, init_like_flax_,
                       is_exported_checkpoint, load_exported_checkpoint)
from . import checkpoint
from .device_rewards import build_device_tables
from .evaluation import eval_split
from .pipeline import RewardPipeline
from .rewards import RewardComputer, host_scorer, scb_gt_value
from .state import Optimizer
from .steps import fused_cst_step, rl_grad_step, rollout, xe_step

log = logging.getLogger(__name__)

#: The saved options of an exported ``--start_from`` checkpoint that set
#: the model's architecture (the training knobs stay this run's).
ARCH_KEYS = ("rnn_size", "input_encoding_size", "att_size", "num_layers",
             "use_attention", "model_type", "fusion_type", "num_heads",
             "num_tx_layers")

#: One completed update: (its step index, its metrics).
Completed = List[Tuple[int, Dict[str, Any]]]

#: The metrics of a train record in ``metrics.jsonl``, where the step has
#: them (the keys of the reference's records; ``lr`` and
#: ``captions_per_sec`` are added).
TRAIN_RECORD_KEYS = ("advantage", "baseline", "grad_norm", "loss", "reward",
                     "sample_len")


#: Why ``--data_shards`` is refused under more than one process (the
#: reference's words).
DATA_SHARDS_REFUSAL = (
    "--data_shards with multiple processes needs a DISTINCT "
    "--data_shard_id (or CST_DATA_SHARD_ID) per host: this launch gave "
    "every one of the {n} processes shard {k}, which would duplicate it "
    "and drop the rest; either assign per-host shard ids or drop "
    "--data_shards for the process-strided split")


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


def host_record(metrics: Dict[str, Any], keys) -> Dict[str, float]:
    """``float`` of each of ``keys`` that ``metrics`` holds, with one
    device-to-host copy for all of its tensors (the reference's one
    batched fetch per logged step), not one round trip per key."""
    keys = [k for k in keys if k in metrics]
    tens = [k for k in keys if isinstance(metrics[k], torch.Tensor)]
    got: Dict[str, float] = {}
    if tens:
        dev = metrics[tens[0]].device
        got = dict(zip(tens, torch.stack(
            [metrics[k].detach().reshape(()).to(dev, torch.float64)
             for k in tens]).tolist()))
    return {k: got[k] if k in got else float(metrics[k]) for k in keys}


def phase_ms(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Per-phase milliseconds of a CST step's metrics (both paths)."""
    out: Dict[str, float] = {}
    for marks in metrics.get("phase_marks", ()):
        out.update(marks.ms())
    return out


def build_splits(opt, train_features: bool = True
                 ) -> Tuple[SplitData, SplitData]:
    """The train and val splits: the files of ``--train_*`` and
    ``--val_*`` (both or neither), read lazily or preloaded
    (``--preload_feats``), or else those of the options' synthetic spec.
    The train split carries consensus scores when WXE or the scb-gt
    baseline needs them: the pickle of ``--train_bcmrscores_pkl``, else
    the synthetic split's own.  ``train_features=False`` builds the train
    split for its vocabulary alone (evaluation and serving)."""
    need_consensus = train_features and (bool(opt.use_consensus_weights) or (
        opt.use_rl and opt.rl_baseline == "scb-gt"))
    train_paths = paths_from_opt(opt, "train")
    val_paths = paths_from_opt(opt, "val")
    if train_paths is not None or val_paths is not None:
        if train_paths is None or val_paths is None:
            raise ValueError("the train split and the val split both come "
                             "from files (--train_* and --val_*) or neither")
        preload = bool(opt.preload_feats) and train_features
        train = CaptionDataset(train_paths, preload=preload)
        val = CaptionDataset(val_paths, preload=preload)
    else:
        train, val = _synthetic_splits(
            opt, train_features,
            need_consensus and not opt.train_bcmrscores_pkl)
    if need_consensus and opt.train_bcmrscores_pkl:
        train.consensus = load_consensus(opt.train_bcmrscores_pkl)
        log.info("consensus scores of %d videos from %s",
                 len(train.consensus), opt.train_bcmrscores_pkl)
    return train, val


def _synthetic_splits(opt, train_features: bool, consensus: bool):
    shapes = parse_feat_shapes(opt.feat_shapes)

    def spec(n):
        return SyntheticSpec(
            num_videos=n, captions_per_video=opt.captions_per_video,
            max_len=opt.max_length, feat_dims=tuple(d for _, d in shapes),
            feat_times=tuple(t for t, _ in shapes), seed=opt.synthetic_seed,
            rich_vocab=opt.synthetic_rich_vocab)

    train = generate("train", spec(opt.synthetic_videos),
                     consensus=consensus, features=train_features)
    val = generate("val", spec(opt.synthetic_val_videos), vocab=train.vocab,
                   consensus=False)
    return train, val


def build_model(opt, vocab_size: int, feat_dims,
                 seq_length: Optional[int] = None,
                 tx_max_len: Optional[int] = None) -> CaptionModel:
    """The model the options ask for, as the reference's ``build_model``:
    the transformer's positions cover ``max(seq_length + 1, max_length +
    1)`` (``seq_length``: the label length, default ``max_length``)
    unless ``tx_max_len`` (a checkpoint's) is given; ``--fusion_type
    manet`` is the modality fusion."""
    seq_length = opt.max_length if seq_length is None else seq_length
    return CaptionModel(
        vocab_size, feat_dims, embed_size=opt.input_encoding_size,
        hidden_size=opt.rnn_size, attn_size=opt.att_size,
        num_layers=int(opt.num_layers),
        use_attention=bool(opt.use_attention),
        use_kernel_attention=bool(opt.pallas_attention),
        decode_kernel=opt.decode_kernel, drop_prob=opt.drop_prob,
        dtype=torch.bfloat16 if opt.use_bfloat16 else torch.float32,
        decoder_type=opt.model_type, num_heads=int(opt.num_heads),
        num_tx_layers=int(opt.num_tx_layers),
        tx_max_len=tx_max_len or max(seq_length + 1, opt.max_length + 1),
        fusion_type={"manet": "modality"}.get(opt.fusion_type, "temporal"),
        remat_cell=bool(opt.remat_cell))


class Trainer:
    """One stage on one device (one rank of a process group when one is
    started: see the module doc).  ``splits`` (train, val) may be passed
    in to skip building them from the options; ``preemption`` is the
    installed ``PreemptionHandler`` whose flag the loop honors (None: the
    loop reads no signal flag).  ``device_tables``, a dict that several
    trainers of one process share, keeps the fused path's device CIDEr-D
    tables (read-only) under their references, vocabulary and device: a
    trainer takes the tables an earlier one built for the same split
    instead of building them again (a ``--train_cached_tokens`` df is
    never shared)."""

    def __init__(self, opt,
                 splits: Optional[Tuple[SplitData, SplitData]] = None,
                 preemption: Optional[PreemptionHandler] = None,
                 device_tables: Optional[dict] = None):
        if opt.eval_metric not in KNOWN_EVAL_METRICS:
            # At start-up, not after the first epoch's validation scores
            # 0.0 for ever.
            raise ValueError(f"--eval_metric {opt.eval_metric!r} is not one "
                             f"of {KNOWN_EVAL_METRICS}")
        self.opt = opt
        self._preempt = preemption
        self._device_tables = device_tables
        #: This process's rank and the world size (0 and 1 without a
        #: process group); rank 0 alone writes.
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self._check_world(opt)
        # The registry always exists; the tracer and the phase timer only
        # under --trace_dir / --step_timing (telemetry/__init__.py).
        self.telemetry = Telemetry.from_opts(opt, process_index=self.rank)
        self.registry = registry = self.telemetry.registry
        self.registry.declare("preempt_signals", "preempt_saves",
                              "negative_advantage_aborts")
        self.registry.set_meta("tuned_config", getattr(
            opt, "tuned_provenance", None) or {"tuned": False})
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
            heartbeat_path=(os.path.join(ck, "heartbeat.json")
                            if self.rank == 0 else None),
            payload=lambda: {**progress, **registry.heartbeat_payload()}
        ).start()
        try:
            self._init(opt, splits)
        except BaseException:
            self._watchdog.stop()
            raise

    def _check_world(self, opt) -> None:
        """What a process group refuses: a global batch its world size
        does not divide, ``--data_shards`` and ``--fault_plan``."""
        if self.world == 1:
            return
        if opt.batch_size % self.world:
            raise ValueError(
                f"--batch_size {opt.batch_size} is the global batch and "
                f"must be a multiple of the world size {self.world} (the "
                "reference shrinks its mesh to a divisor; a process group "
                "cannot shrink)")
        if getattr(opt, "data_shards", 0):
            raise ValueError(DATA_SHARDS_REFUSAL.format(
                n=self.world, k=getattr(opt, "data_shard_id", 0)))
        if opt.fault_plan:
            raise ValueError("--fault_plan acts on one process: run its "
                             "drills at one process")

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
        #: The global-view step's collectives, under a process group (at
        #: world size 1 too: its one-rank collectives are copies).
        self.dp = DataParallel() if dist.is_initialized() else None
        self.train_split, self.val_split = splits or build_splits(opt)
        self._watchdog.beat()
        self.vocab = self.train_split.vocab
        exported = None
        if opt.start_from and is_exported_checkpoint(opt.start_from):
            exported = load_exported_checkpoint(opt.start_from)
            arch = {k: v for k, v in exported_model_opts(exported[1]).items()
                    if k in ARCH_KEYS}
            log.info("--start_from %s: the model's widths from its saved "
                     "options %s", opt.start_from, arch)
            vars(opt).update(arch)
        self.model = build_model(opt, self.vocab.size_with_pad,
                                 self.train_split.feat_dims,
                                 self.train_split.seq_length)
        init_like_flax_(self.model, torch.Generator().manual_seed(opt.seed))
        if exported is not None:
            self._start_from_exported(opt.start_from, *exported)
        elif opt.start_from:
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
            weights = self._wxe_weights()
        self.loader = CaptionLoader(
            self.train_split, opt.batch_size, seq_per_img=opt.seq_per_img,
            seed=opt.seed, consensus_weights=weights,
            fault_plan=self._faults,
            shard_spec=resolve_shard_spec(getattr(opt, "data_shards", 0),
                                          getattr(opt, "data_shard_id", 0)),
            dp_rank=(self.rank, self.world))
        #: The prefetched training stream, started at the first batch.
        self._batches: Optional[Iterator[Batch]] = None
        self.val_loader = CaptionLoader(
            self.val_split, opt.eval_batch_size or opt.batch_size,
            seq_per_img=1, shuffle=False, process_index=self.rank,
            process_count=self.world)
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
                      if self._arm_debug_nans(opt) else None)
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
        if self.rank != 0:          # after rank 0's quarantine scan
            self._barrier()
        self.ckpt = checkpoint.CheckpointManager(
            opt.checkpoint_path, max_to_keep=opt.max_checkpoints,
            fault_plan=self._faults, registry=self.registry,
            tracer=self.telemetry.tracer, readonly=self.rank != 0)
        if self.rank == 0:
            self._barrier()
        self._flops_per_step: Optional[float] = None
        if self.telemetry.phases is not None:
            self._flops_per_step = caption_step_flops(
                opt.batch_size, opt.seq_per_img,
                opt.max_length if opt.use_rl
                else self.train_split.seq_length,
                self.vocab.size_with_pad, opt.rnn_size,
                feat_shapes=list(zip(self.train_split.feat_times,
                                     self.train_split.feat_dims))
            )["cst" if opt.use_rl else "xe"]
        self._device_name = (torch.cuda.get_device_name(self.device)
                             if self.device.type == "cuda"
                             else str(self.device))
        self._profiler = None
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

    def _arm_debug_nans(self, opt) -> bool:
        """Arm ``--debug_nans`` (anomaly mode with its NaN check, restored
        by ``close``) -> whether the divergence guard stays on: the two
        exclude each other, as in the reference."""
        self._anomaly_before = None
        if not opt.debug_nans:
            return bool(opt.divergence_guard)
        self._anomaly_before = (torch.is_anomaly_enabled(),
                                torch.is_anomaly_check_nan_enabled())
        torch.autograd.set_detect_anomaly(True, check_nan=True)
        if opt.divergence_guard:
            log.warning(
                "--debug_nans and --divergence_guard are mutually "
                "exclusive: --debug_nans raises on the FIRST non-finite "
                "value, so the guard's skip-and-rollback can never run.  "
                "Disabling the divergence guard for this run (pass "
                "--divergence_guard 0 to silence).")
        return False

    def _start_from_exported(self, directory: str, params, _opts,
                             vocab) -> None:
        """``--start_from`` an exported checkpoint: its parameters, after
        checking that its vocabulary is this run's."""
        if vocab.to_json() != self.vocab.to_json():
            raise ValueError(
                f"--start_from {directory}: its vocabulary "
                f"({len(vocab)} words) is not this run's "
                f"({len(self.vocab)} words)")
        self.model.load_state_dict(from_flax(params))
        log.info("warm-started from the exported checkpoint %s", directory)

    def _wxe_weights(self) -> Dict[str, np.ndarray]:
        """The WXE weights: the train split's consensus scores normalised
        at ``--consensus_temperature``; videos without scores keep weight
        1 (a warning says how many)."""
        split = self.train_split
        if split.consensus is None:
            raise ValueError("--use_consensus_weights 1 needs consensus "
                             "scores: pass --train_bcmrscores_pkl")
        weights = normalize_weights(
            split.consensus, temperature=self.opt.consensus_temperature)
        log.info("WXE: consensus weights for %d videos", len(weights))
        missing = [v for v in split.video_ids if v not in weights]
        if missing:
            log.warning("WXE: %d training video(s) missing from the "
                        "consensus scores (e.g. %s); their captions keep "
                        "weight 1.0: check that --train_bcmrscores_pkl "
                        "matches the training split", len(missing),
                        missing[:3])
        return weights

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
        modality in ``feat_dtype``, refused over ``--device_feats_max_gb``.
        Uploaded in row chunks of at most ``--device_feats_upload_mb``
        per modality, read from the split (the memory map, for files) and
        cast on the host chunk by chunk: host memory holds one chunk, not
        the table."""
        split = self.train_split
        n = split.num_videos
        itemsize = torch.finfo(self.feat_dtype).bits // 8
        row_bytes = [t * d * itemsize
                     for t, d in zip(split.feat_times, split.feat_dims)]
        size = n * sum(row_bytes)
        budget = float(self.opt.device_feats_max_gb) * 1e9
        if size > budget:
            raise ValueError(
                f"--device_feats table is {size / 1e9:.1f} GB "
                f"({n} videos), over the "
                f"--device_feats_max_gb {budget / 1e9:.1f} GB budget: use "
                "--device_feats 0 or raise the budget if the card fits it")
        chunk = max(1, int(float(self.opt.device_feats_upload_mb) * 1e6
                           // max(row_bytes)))
        tables = [torch.empty((n, t, d), dtype=self.feat_dtype,
                              device=self.device)
                  for t, d in zip(split.feat_times, split.feat_dims)]
        n_chunks = -(-n // chunk)
        for i, start in enumerate(range(0, n, chunk)):
            ix = np.arange(start, min(start + chunk, n))
            for table, block in zip(tables, host_feats(
                    split.features(ix), self.feat_dtype)):
                table[start:start + len(ix)].copy_(block)
            self._watchdog.beat()
            if n_chunks > 1 and ((i + 1) % 8 == 0 or i + 1 == n_chunks):
                log.info("device_feats upload: %d/%d chunks", i + 1,
                         n_chunks)
        log.info("device_feats: %d videos x %d modalities on the device "
                 "(%.3f GB, %s) in %d chunks of up to %d rows", n,
                 len(tables), size / 1e9, self.feat_dtype, -(-n // chunk),
                 chunk)
        return tables

    def _corpus_df(self):
        """``--train_cached_tokens``: (df, number of documents) of the
        corpus-df pickle, or None.  A file that is not one raises."""
        path = self.opt.train_cached_tokens
        if not path:
            return None
        df, ref_len = load_corpus_df(path)
        log.info("CST reward: corpus df from %s (%d n-grams, %d documents)",
                 path, len(df), int(ref_len))
        return df, ref_len

    def _setup_host_rl(self) -> None:
        """The host reward: the native C++ CIDEr-D under ``--native_cider
        1`` (the default), the Python scorer when it is 0 or the library
        cannot be built (a warning, as the reference does)."""
        opt = self.opt
        refs = tokenize_corpus(self.train_split.refs)
        scorer, self.cst_scorer = host_scorer(
            refs, self.vocab.word_to_ix, native=bool(opt.native_cider),
            corpus_df=self._corpus_df())
        self.registry.set_info("cst_scorer", self.cst_scorer)
        # The host path's hooks: the score and fetch_wait phases (and
        # spans), and the profiler's ranges inside its window.
        tel = self.telemetry
        hooked = (tel if tel.phases is not None or tel.tracer is not None
                  or opt.profile_dir else None)
        self.reward_computer = RewardComputer(
            self.vocab, scorer,
            refs, seq_per_img=opt.seq_per_img, baseline=opt.rl_baseline,
            consensus_scores=self.train_split.consensus,
            scb_captions=opt.scb_captions, telemetry=hooked,
            means=None if self.dp is None else self.dp.host_means)
        self.pipeline = RewardPipeline(
            self._pipeline_rollout, self._pipeline_grad,
            lambda ctx, s, g: self.reward_computer(ctx["video_ids"], s, g),
            depth=opt.overlap_rewards, telemetry=hooked)
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
        external_df, external_ref_len = self._corpus_df() or (None, None)
        t0 = time.perf_counter()
        shared = self._device_tables
        key = None
        if shared is not None and external_df is None:
            key = (tuple((v, tuple(c)) for v, c in refs.items()),
                   tuple(sorted(self.vocab.word_to_ix.items())),
                   str(self.device))
        if key is not None and key in shared:
            corpus, tables = shared[key]
        else:
            corpus, tables, _ = build_device_tables(
                refs, self.vocab.word_to_ix, device=self.device,
                external_df=external_df, external_ref_len=external_ref_len)
            if key is not None:
                shared[key] = corpus, tables
        build_s = time.perf_counter() - t0
        scb_gt = None
        if opt.rl_baseline == "scb-gt":
            if split.consensus is None:
                raise ValueError("scb-gt baseline needs consensus scores: "
                                 "pass --train_bcmrscores_pkl")
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
                      guard=self.guard is not None, dp=self.dp)
        self.step += 1
        return [(self.step - 1, out)]

    def _pipeline_rollout(self, feats, ctx):
        marks = PhaseMarks(self.device)
        marks("start")
        out = rollout(self.model, feats, self.opt.max_length,
                      self.opt.seq_per_img, self.noise,
                      temperature=self.opt.temperature,
                      greedy_baseline=self.opt.rl_baseline == "greedy",
                      decode_chunk=self.opt.decode_chunk, dp=self.dp)
        marks("rollout")
        ctx.update(marks=marks, rollout_steps=out[2])
        return out

    def _pipeline_grad(self, feats, sampled, advantage, ctx):
        marks = PhaseMarks(self.device)
        marks("start")
        m = rl_grad_step(self.model, self.optimizer, feats, sampled,
                         torch.from_numpy(advantage).to(self.device),
                         self.opt.seq_per_img, guard=self.guard is not None,
                         dp=self.dp)
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
            decode_chunk=opt.decode_chunk, mark=marks, dp=self.dp)
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
                read_feats=self.feat_tables is None,
                tracer=self.telemetry.tracer)
        return next(self._batches)

    def iteration(self) -> Completed:
        """Dispatch one update; -> the updates completed by this call
        (one, or for the host-reward pipeline 0 or 1).  Under
        ``--step_timing`` the batch fetch is the ``data_wait`` phase and
        the dispatch the ``compute`` phase (the host path's fetch and
        score nest inside it, attributed exclusively)."""
        ph = self.telemetry.phases
        if ph is None:
            batch = self.next_batch()
        else:
            with ph.phase("data_wait"):
                batch = self.next_batch()
        batch = self._nan_fault_inputs(self.step, batch)
        self._captions += self.opt.batch_size * self.opt.seq_per_img
        step = self.rl_iteration if self.opt.use_rl else self.xe_iteration
        if ph is None:
            return step(batch)
        with ph.phase("compute"):
            return step(batch)

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
                        if isinstance(v, (str, int, float, type(None)))
                        or (isinstance(v, list)
                            and all(isinstance(x, str) for x in v))}}

    def _after_save(self, payload: Dict[str, Any]) -> None:
        """Bookkeeping after every durable save: the rollback snapshot,
        the save cadence's clock, and ``metrics.jsonl`` made durable with
        the state it describes."""
        self._last_saved_step = payload["step"]
        self._last_save_monotonic = time.monotonic()
        self._snapshot_good_state(payload)
        self.telemetry.flush(fsync=True)
        self._watchdog.beat()

    def _barrier(self) -> None:
        if self.dp is not None:
            dist.barrier()

    def _save_recovery(self, verify: bool = False) -> None:
        payload = self.checkpoint_payload()
        with self.telemetry.phase("ckpt"):
            if self.rank == 0:
                self.ckpt.save_recovery(self.step, payload, verify=verify)
            self._barrier()
        self._after_save(payload)

    def _note(self, completed: Completed, total: int, clock: list) -> None:
        """Queue each completed step's ``bad_step`` with the guard; every
        ``--log_every``-th step, a train record in ``metrics.jsonl``, a
        log line and the negative-advantage check."""
        opt = self.opt
        for k, m in completed:
            if self.guard is not None:
                self.guard.observe(k, m.get("bad_step"))
            if opt.debug_nans:
                self._check_finite(k, m)
            if not (opt.log_every and (k + 1) % opt.log_every == 0):
                continue
            rec = host_record(m, TRAIN_RECORD_KEYS)
            # cstlint-torch: disable=device-scalar-fetch -- the schedule evaluated on a CPU tensor of the host step index: no device value
            rec["lr"] = float(self.optimizer.lr(torch.tensor(float(k))))
            secs = time.perf_counter() - clock[0]
            clock[0] = time.perf_counter()
            if self._captions:      # 0 for the later steps of a drain
                cps = self._captions / max(secs, 1e-9)
                rec["captions_per_sec"] = cps
                phases = self.telemetry.phases
                if phases is not None:
                    # The interval's exclusive phase split, and the MFU
                    # its captions/s imply at this run's shapes (null
                    # where the peak table has no entry: the CPU).
                    ncaps = opt.batch_size * opt.seq_per_img
                    rec.update(phases.drain_ms(
                        max(1, round(self._captions / ncaps))))
                    rec.update(mfu_fields(self._flops_per_step, cps, ncaps,
                                          self._device_name))
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

    @staticmethod
    def _check_finite(k: int, m: Dict[str, Any]) -> None:
        """``--debug_nans``: raise at a step whose loss or gradient norm is
        not finite (the forward's NaN; anomaly mode names the backward's
        operation before this runs)."""
        for key in ("loss", "grad_norm"):
            if key in m:
                # cstlint-torch: disable=device-scalar-fetch -- --debug_nans only (off by default): the flag's contract is a finite check of every step's loss and gradient norm, which needs their values
                value = float(m[key])
                if not np.isfinite(value):
                    raise FloatingPointError(
                        f"--debug_nans: step {k + 1} produced a non-finite "
                        f"{key} ({value})")

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
        self._stop_profiler()
        if h.signal_monotonic is not None:
            self.registry.set_gauge(
                "preempt_exit_ms",
                (time.monotonic() - h.signal_monotonic) * 1e3)
        self.telemetry.flush(fsync=True)
        log.warning("preemption (%s) honored at step boundary %d: %s; "
                    "exiting with the resumable code", h.signal_name,
                    self.step, "verified checkpoint saved" if saved
                    else "checkpoint already current")
        raise PreemptedExit(self.step, h.signal_name or "signal", saved)

    def _preempt_requested(self) -> bool:
        """The preemption flag, taken by every rank together: a signal on
        any rank stops them all at this boundary."""
        flag = self._preempt.requested
        return flag if self.world == 1 else self.dp.any(flag)

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
            self._open_sinks()
        window = self.profile_window()
        clock = [time.perf_counter()]
        self._last_save_monotonic = time.monotonic()
        while self.step < total:
            # Each pass of the loop means the previous dispatch, drain,
            # validation and save returned.
            self._watchdog.beat()
            self._progress["loop_step"] = self.step
            if window is not None:
                self._profile_tick(window)
            if self._preempt is not None and self._preempt_requested():
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
            with self.telemetry.phase("ckpt"):
                if self.rank == 0:
                    self.ckpt.save(self.step, payload, score=score, extra={
                        "opt": vars(opt), "val_scores": scores,
                        "patience": self.patience,
                        "history": self.history})
                self._barrier()
            self._after_save(payload)
            if (opt.max_patience and self.patience >= opt.max_patience
                    and self.step // bpe >= opt.min_epochs):
                log.info("early stop: no %s improvement in %d epochs",
                         opt.eval_metric, self.patience)
                break
        self._note(self.drain(), total, clock)
        self._stop_profiler()
        if self.guard is not None:
            self.guard.flush()
            if self.guard.total_skipped:
                log.warning("divergence guard summary: %d step(s) skipped as "
                            "non-finite, %d rollback(s)",
                            self.guard.total_skipped, self.guard.rollbacks)
        self.telemetry.flush(fsync=True)
        return self._result()

    def _open_sinks(self) -> None:
        """``metrics.jsonl`` always; TensorBoard scalars under
        ``<checkpoint_path>/tb`` with ``--tensorboard 1`` (a warning
        without the ``tensorboard`` package, as the reference)."""
        opt = self.opt
        if self.rank != 0:
            return
        self.registry.add_sink(JsonlSink(os.path.join(
            opt.checkpoint_path, "metrics.jsonl")))
        if opt.tensorboard:
            try:
                from ..utils.tb import ScalarWriter

                self.registry.add_sink(ScalarWriterSink(ScalarWriter(
                    os.path.join(os.path.abspath(opt.checkpoint_path),
                                 "tb"))))
            except ImportError as e:
                log.warning("tensorboard writer unavailable: %s", e)
        self._sink_open = True

    # -- the profiler window -------------------------------------------------

    def profile_window(self) -> Optional[Tuple[int, int]]:
        """Loop steps ``[start, stop)`` of the ``torch.profiler`` window,
        or None without ``--profile_dir``.  ``--profile_steps`` is a count
        from ``--profile_start`` or ``A:B``; an empty window raises."""
        opt = self.opt
        if not opt.profile_dir:
            return None
        spec = str(opt.profile_steps).strip()
        if ":" in spec:
            a, b = spec.split(":", 1)
            start, stop = int(a), int(b)
        else:
            start = int(opt.profile_start)
            stop = start + int(spec)
        if stop <= start:
            raise ValueError(
                f"--profile_steps {spec!r} with --profile_start "
                f"{opt.profile_start} is an empty window")
        return start, stop

    def _profile_tick(self, window: Tuple[int, int]) -> None:
        """At the top of a loop pass: open the profiler at the window's
        first step, close it at its end.  The device is synchronised at
        both ends, so the trace holds exactly the window's kernels."""
        start, stop = window
        if self._profiler is None and self.step == start:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize(self.device)
            self._profiler = profile(activities=acts)
            self._profile_from = (self.step, launch_counts(),
                                  launch_counts_by_dtype())
            self._profiler.start()
            self.telemetry.profiling = True
        elif self._profiler is not None and self.step == stop:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        """Close an open profiler window: its Chrome trace into
        ``--profile_dir``, and the window's steps, trace path and kernel
        launches (counted by the wrappers) in ``telemetry.json`` under
        ``info.profile``."""
        prof = self._profiler
        if prof is None:
            return
        self._profiler = None
        self.telemetry.profiling = False
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        first, counts, by_dtype = self._profile_from
        os.makedirs(self.opt.profile_dir, exist_ok=True)
        path = os.path.join(os.path.abspath(self.opt.profile_dir),
                            f"profile_{os.getpid()}_steps{first}-"
                            f"{self.step}.json")
        prof.export_chrome_trace(path)
        launches = {k: n - counts[k] for k, n in launch_counts().items()}
        launches.update({k: n - by_dtype[k]
                         for k, n in launch_counts_by_dtype().items()})
        self.registry.set_info("profile", {
            "steps": [first, self.step], "trace": path,
            "launches": launches})
        log.info("profiler trace of steps [%d, %d) written to %s", first,
                 self.step, path)

    def close(self) -> None:
        """Join the prefetch workers, close an open profiler window, write
        ``telemetry.json`` (when ``train`` ran) with this process's kernel
        launches, close ``metrics.jsonl``, TensorBoard and the span
        tracer, put anomaly mode back (``--debug_nans``) and stop the
        watchdog.  Idempotent."""
        try:
            if self._batches is not None:
                self._batches.close()
            if getattr(self, "_profiler", None) is not None:
                self._stop_profiler()
            path = None
            if self._sink_open:
                for key, n in launch_counts_by_dtype().items():
                    self.registry.set_gauge(f"launches/{key}", n)
                path = os.path.join(self.opt.checkpoint_path,
                                    "telemetry.json")
            self.telemetry.close(path)
        finally:
            if getattr(self, "_anomaly_before", None) is not None:
                torch.autograd.set_detect_anomaly(*self._anomaly_before)
                self._anomaly_before = None
            self._watchdog.stop()
