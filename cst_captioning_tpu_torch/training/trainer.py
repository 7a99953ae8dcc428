"""One training stage, XE, WXE or CST (counterpart of the reference's
``training/trainer.py``, single device).

The stage runs an epoch loop over the training split: one update per
batch, validation at every epoch boundary (greedy decode, CIDEr-D),
``best.pt`` on a new best score, ``last.pt`` every epoch, and an early
stop after ``max_patience`` epochs without improvement (not before
``min_epochs``).  The learning rate decays by ``learning_rate_decay_rate``
every ``learning_rate_decay_every`` epochs, counted in updates as the
reference counts them.

CST runs one of two paths (``rl_iteration``):

- ``--device_rewards 1`` (the default, as in the reference): the fused
  step (``steps.fused_cst_step``) with the on-device CIDEr-D tables built
  once here (``_setup_fused_rl``), rows in dataset video order;
- ``--device_rewards 0``: the host reward (``RewardComputer``) driven by
  ``RewardPipeline`` at depth ``--overlap_rewards`` (2 by default).

The divergence guard (``--divergence_guard 1``, the default) folds a
finite-check into every update and counts bad steps on the host with a
lag of one step; after ``--divergence_max_bad`` consecutive bad steps the
stage rolls back to a host copy of the state taken at the last
checkpoint save, drops the pipeline's in-flight rollouts and re-seeds
the rollout noise (``rollout_seed``).

Data are in-memory synthetic splits (``data/synthetic.py``); with
``--device_feats 1`` every training video's features stay on the card
and batches gather them by ``Batch.video_ix``.  Random streams are
explicit generators seeded from ``--seed``: the weights (CPU), the
dropout masks and the rollout noise (on the device).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import default_device
from ..data.loader import Batch, CaptionLoader
from ..data.shapes import parse_feat_shapes
from ..data.synthetic import Split, SyntheticSpec, generate
from ..metrics.ciderd import CiderD, build_corpus_df
from ..metrics.consensus import normalize_weights
from ..metrics.tokenizer import tokenize_corpus
from ..models.captioner import CaptionModel
from ..ops.device_ciderd import (auto_ref_chunk, match_tensor_bytes,
                                 table_bytes)
from ..ops.sampling import gumbel_noise
from ..resilience.guard import DivergenceGuard
from ..weights import init_like_flax_
from . import checkpoint
from .device_rewards import build_device_tables
from .evaluation import eval_split
from .pipeline import RewardPipeline
from .rewards import RewardComputer, scb_gt_value
from .state import Optimizer
from .steps import fused_cst_step, rl_grad_step, rollout, xe_step

log = logging.getLogger(__name__)

#: One completed update: (its step index, its metrics).
Completed = List[Tuple[int, Dict[str, Any]]]


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


def build_splits(opt) -> Tuple[Split, Split]:
    """The train and val splits of the options' synthetic spec; the train
    split carries consensus scores when WXE or the scb-gt baseline needs
    them."""
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
                     consensus=need_consensus)
    val = generate("val", spec(opt.synthetic_val_videos), vocab=train.vocab,
                   consensus=False)
    return train, val


def build_model(opt, vocab_size: int, feat_dims) -> CaptionModel:
    return CaptionModel(
        vocab_size, feat_dims, embed_size=opt.input_encoding_size,
        hidden_size=opt.rnn_size, attn_size=opt.att_size,
        use_kernel_attention=bool(opt.pallas_attention),
        decode_kernel=opt.decode_kernel, drop_prob=opt.drop_prob)


class Trainer:
    """One stage on one device.  ``splits`` (train, val) may be passed in
    to skip building them from the options."""

    def __init__(self, opt, splits: Optional[Tuple[Split, Split]] = None):
        self.opt = opt
        self.device = default_device(opt.device)
        self.train_split, self.val_split = splits or build_splits(opt)
        self.vocab = self.train_split.vocab
        self.model = build_model(
            opt, self.vocab.size_with_pad,
            [f.shape[-1] for f in self.train_split.feats])
        init_like_flax_(self.model, torch.Generator().manual_seed(opt.seed))
        if opt.start_from:
            prev = checkpoint.load(opt.start_from, checkpoint.BEST)
            self.model.load_state_dict(prev["model"])
            log.info("warm-started from %s (step %s, score %s)",
                     opt.start_from, prev["step"], prev["best_score"])
        self.model.to(self.device)

        weights = None
        if opt.use_consensus_weights:
            weights = normalize_weights(self.train_split.consensus,
                                        temperature=opt.consensus_temperature)
        self.loader = CaptionLoader(self.train_split, opt.batch_size,
                                    seq_per_img=opt.seq_per_img,
                                    seed=opt.seed, consensus_weights=weights)
        self.val_loader = CaptionLoader(
            self.val_split, opt.batch_size, seq_per_img=1, shuffle=False)
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
        self.noise = gumbel_noise(self.noise_gen,
                                  dtype=getattr(torch, opt.noise_dtype))
        self.guard = (DivergenceGuard(opt.divergence_max_bad,
                                      opt.divergence_max_rollbacks)
                      if opt.divergence_guard else None)
        self._good_state: Optional[Tuple[int, dict, dict]] = None
        self.feat_tables = (self._load_device_feats() if opt.device_feats
                            else None)
        self.reward_computer: Optional[RewardComputer] = None
        self.pipeline: Optional[RewardPipeline] = None
        self.fused: Optional[Dict[str, Any]] = None
        #: What the fused path's setup built (times, bytes, the chunking).
        self.reward_setup: Dict[str, Any] = {}
        if opt.use_rl:
            if opt.device_rewards:
                self._setup_fused_rl()
            else:
                self._setup_host_rl()
        self.step = 0
        self.last_rollout_steps = 0
        self.history: List[Dict[str, float]] = []

    # -- set-up --------------------------------------------------------------

    def _load_device_feats(self) -> List[torch.Tensor]:
        """Every training video's features on the device, one tensor per
        modality, refused over ``--device_feats_max_gb``."""
        size = sum(f.nbytes for f in self.train_split.feats)
        budget = float(self.opt.device_feats_max_gb) * 1e9
        if size > budget:
            raise ValueError(
                f"--device_feats table is {size / 1e9:.1f} GB "
                f"({self.train_split.num_videos} videos), over the "
                f"--device_feats_max_gb {budget / 1e9:.1f} GB budget: use "
                "--device_feats 0 or raise the budget if the card fits it")
        tables = [torch.from_numpy(f).to(self.device)
                  for f in self.train_split.feats]
        log.info("device_feats: %d videos x %d modalities on the device "
                 "(%.3f GB)", self.train_split.num_videos, len(tables),
                 size / 1e9)
        return tables

    def _setup_host_rl(self) -> None:
        opt = self.opt
        refs = tokenize_corpus(self.train_split.refs)
        df, ndocs = build_corpus_df(refs)
        self.reward_computer = RewardComputer(
            self.vocab, CiderD(df_mode="corpus", df=df,
                               ref_len=float(ndocs)),
            refs, seq_per_img=opt.seq_per_img, baseline=opt.rl_baseline,
            consensus_scores=self.train_split.consensus,
            scb_captions=opt.scb_captions)
        self.pipeline = RewardPipeline(
            self._pipeline_rollout, self._pipeline_grad,
            lambda ctx, s, g: self.reward_computer(ctx["video_ids"], s, g),
            depth=opt.overlap_rewards)
        log.info("RL reward: host CIDEr-D, pipeline depth %d",
                 self.pipeline.depth)

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
        return [torch.from_numpy(f).to(self.device) for f in batch.feats]

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

    def iteration(self) -> Completed:
        """Dispatch one update; -> the updates completed by this call
        (one, or for the host-reward pipeline 0 or 1)."""
        batch = self.loader.next_batch()
        if self.opt.use_rl:
            return self.rl_iteration(batch)
        return self.xe_iteration(batch)

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
        _, scores = eval_split(
            self.model, self.val_loader, self.vocab, self.opt.max_length,
            self.val_split.refs, beam_size=self.opt.val_beam_size,
            length_norm=self.opt.length_norm,
            decode_chunk=self.opt.decode_chunk)
        return scores

    def checkpoint_payload(self, best: float, score: float) -> Dict[str, Any]:
        return {"model": {k: v.detach().cpu().clone()
                          for k, v in self.model.state_dict().items()},
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "best_score": best, "score": score,
                "opt": {k: v for k, v in vars(self.opt).items()
                        if isinstance(v, (str, int, float, type(None)))}}

    def _note(self, completed: Completed, total: int, clock: list) -> None:
        """Queue each completed step's ``bad_step`` with the guard and log
        every ``--log_every``-th step."""
        opt = self.opt
        for k, m in completed:
            if self.guard is not None:
                self.guard.observe(k, m.get("bad_step"))
            if not (opt.log_every and (k + 1) % opt.log_every == 0):
                continue
            secs = time.perf_counter() - clock[0]
            clock[0] = time.perf_counter()
            rl = ""
            if opt.use_rl:
                rl = (f" reward {float(m['reward']):.4f} advantage "
                      f"{float(m['advantage']):.4f} phases (ms) "
                      + ", ".join(f"{name} {ms:.1f}"
                                  for name, ms in phase_ms(m).items()))
            log.info("step %d/%d lr %.3g loss %.4f grad_norm %.3f "
                     "%.1f ms/step%s", k + 1, total,
                     self.optimizer.current_lr(), float(m["loss"]),
                     float(m["grad_norm"]), 1e3 * secs / opt.log_every, rl)

    def train(self) -> Dict[str, Any]:
        opt = self.opt
        bpe = self.loader.batches_per_epoch
        total = opt.max_epochs * bpe
        best, best_step, patience = float("-inf"), None, 0
        clock = [time.perf_counter()]
        while self.step < total:
            self._note(self.iteration(), total, clock)
            if self.guard is not None and self.guard.poll():
                rewind = self._handle_divergence(self.step - 1)
                if rewind is not None:
                    self.step = rewind
                    continue
            if self.step % bpe:
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
            score = scores["CIDEr"]
            self.history.append({"step": self.step, **scores})
            log.info("val @ step %d (epoch %d): %s", self.step,
                     self.step // bpe, scores)
            improved = score > best
            if improved:
                best, best_step, patience = score, self.step, 0
            else:
                patience += 1
            payload = self.checkpoint_payload(best, score)
            if improved:
                checkpoint.save(opt.checkpoint_path, checkpoint.BEST, payload)
            checkpoint.save(opt.checkpoint_path, checkpoint.LAST, payload)
            self._snapshot_good_state(payload)
            if (opt.max_patience and patience >= opt.max_patience
                    and self.step // bpe >= opt.min_epochs):
                log.info("early stop: no CIDEr-D improvement in %d epochs",
                         patience)
                break
        self._note(self.drain(), total, clock)
        if self.guard is not None:
            self.guard.flush()
            if self.guard.total_skipped:
                log.warning("divergence guard summary: %d step(s) skipped as "
                            "non-finite, %d rollback(s)",
                            self.guard.total_skipped, self.guard.rollbacks)
        result = {"best_score": None if best == float("-inf") else best,
                  "best_step": best_step, "last_step": self.step,
                  "history": self.history}
        os.makedirs(opt.checkpoint_path, exist_ok=True)
        tmp = os.path.join(opt.checkpoint_path, f"infos.json.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(result, f)
        os.replace(tmp, os.path.join(opt.checkpoint_path, "infos.json"))
        return result
