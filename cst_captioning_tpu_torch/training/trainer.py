"""One training stage, XE, WXE or CST (counterpart of the reference's
``training/trainer.py``, single device, host-reward CST).

The stage runs an epoch loop over the training split: one update per
batch (``xe_iteration`` or ``rl_iteration``), validation at every epoch
boundary (greedy decode, CIDEr-D), ``best.pt`` on a new best score,
``last.pt`` every epoch, and an early stop after ``max_patience`` epochs
without improvement (not before ``min_epochs``).  The learning rate
decays by ``learning_rate_decay_rate`` every ``learning_rate_decay_every``
epochs, counted in updates as the reference counts them.

Data are in-memory synthetic splits (``data/synthetic.py``).  Random
streams are explicit generators seeded from ``--seed``: the weights
(CPU), the dropout masks and the rollout noise (on the device).
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
from ..ops.sampling import gumbel_noise
from ..weights import init_like_flax_
from . import checkpoint
from .evaluation import eval_split
from .rewards import RewardComputer
from .state import Optimizer
from .steps import rl_grad_step, rollout, xe_step

log = logging.getLogger(__name__)


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
        self.noise = gumbel_noise(
            torch.Generator(self.device).manual_seed(opt.seed + 1),
            dtype=getattr(torch, opt.noise_dtype))
        self.reward_computer = None
        if opt.use_rl:
            refs = tokenize_corpus(self.train_split.refs)
            df, ndocs = build_corpus_df(refs)
            self.reward_computer = RewardComputer(
                self.vocab, CiderD(df_mode="corpus", df=df,
                                   ref_len=float(ndocs)),
                refs, seq_per_img=opt.seq_per_img, baseline=opt.rl_baseline,
                consensus_scores=self.train_split.consensus,
                scb_captions=opt.scb_captions)
        self.step = 0
        self.history: List[Dict[str, float]] = []

    # -- one update ----------------------------------------------------------

    def _feats(self, batch: Batch) -> List[torch.Tensor]:
        return [torch.from_numpy(f).to(self.device) for f in batch.feats]

    def xe_iteration(self, batch: Batch) -> Dict[str, Any]:
        """One XE/WXE update; metrics stay on the device."""
        out = xe_step(self.model, self.optimizer, self._feats(batch),
                      torch.from_numpy(batch.labels).long().to(self.device),
                      torch.from_numpy(batch.weights).to(self.device),
                      self.opt.seq_per_img, self.dropout_gen)
        self.step += 1
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def rl_iteration(self, batch: Batch) -> Dict[str, Any]:
        """One CST update: rollout (K2 under ``--decode_kernel fused``),
        host CIDEr-D advantage, REINFORCE gradient.  The metrics carry the
        host seconds of each phase (the device synchronised at each
        boundary) and the rollout's decode steps."""
        opt = self.opt
        feats = self._feats(batch)
        t0 = time.perf_counter()
        sampled, greedy, steps = rollout(
            self.model, feats, opt.max_length, opt.seq_per_img, self.noise,
            temperature=opt.temperature,
            greedy_baseline=opt.rl_baseline == "greedy",
            decode_chunk=opt.decode_chunk)
        sampled_h = sampled.cpu().numpy()
        greedy_h = None if greedy is None else greedy.cpu().numpy()
        t1 = time.perf_counter()
        advantage, stats = self.reward_computer(batch.video_ids, sampled_h,
                                                greedy_h)
        t2 = time.perf_counter()
        out = rl_grad_step(self.model, self.optimizer, feats, sampled,
                           torch.from_numpy(advantage).to(self.device),
                           opt.seq_per_img)
        self._sync()
        t3 = time.perf_counter()
        self.step += 1
        out.update(stats)
        out.update({"rollout_steps": steps, "rollout_s": t1 - t0,
                    "reward_s": t2 - t1, "grad_s": t3 - t2})
        return out

    def iteration(self) -> Dict[str, Any]:
        batch = self.loader.next_batch()
        if self.opt.use_rl:
            return self.rl_iteration(batch)
        return self.xe_iteration(batch)

    # -- validation, checkpoints, the loop -----------------------------------

    def validate(self) -> Dict[str, float]:
        _, scores = eval_split(
            self.model, self.val_loader, self.vocab, self.opt.max_length,
            self.val_split.refs, beam_size=self.opt.val_beam_size,
            length_norm=self.opt.length_norm,
            decode_chunk=self.opt.decode_chunk)
        return scores

    def checkpoint_payload(self, best: float, score: float) -> Dict[str, Any]:
        return {"model": {k: v.detach().cpu()
                          for k, v in self.model.state_dict().items()},
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "best_score": best, "score": score,
                "opt": {k: v for k, v in vars(self.opt).items()
                        if isinstance(v, (str, int, float, type(None)))}}

    def train(self) -> Dict[str, Any]:
        opt = self.opt
        bpe = self.loader.batches_per_epoch
        total = opt.max_epochs * bpe
        best, best_step, patience = float("-inf"), None, 0
        t_log = time.perf_counter()
        while self.step < total:
            m = self.iteration()
            if opt.log_every and self.step % opt.log_every == 0:
                secs = time.perf_counter() - t_log
                t_log = time.perf_counter()
                log.info("step %d/%d lr %.3g loss %.4f grad_norm %.3f "
                         "%.1f ms/step%s", self.step, total,
                         self.optimizer.lr(self.optimizer.count - 1),
                         float(m["loss"]), float(m["grad_norm"]),
                         1e3 * secs / opt.log_every,
                         f" reward {m['reward']:.4f} advantage "
                         f"{m['advantage']:.4f}" if opt.use_rl else "")
            if self.step % bpe:
                continue
            scores = self.validate()
            score = scores["CIDEr"]
            self.history.append({"step": self.step, **scores})
            log.info("val @ step %d (epoch %d): %s", self.step,
                     self.step // bpe, scores)
            if score > best:
                best, best_step, patience = score, self.step, 0
                checkpoint.save(opt.checkpoint_path, checkpoint.BEST,
                                self.checkpoint_payload(best, score))
            else:
                patience += 1
            checkpoint.save(opt.checkpoint_path, checkpoint.LAST,
                            self.checkpoint_payload(best, score))
            if (opt.max_patience and patience >= opt.max_patience
                    and self.step // bpe >= opt.min_epochs):
                log.info("early stop: no CIDEr-D improvement in %d epochs",
                         patience)
                break
        result = {"best_score": None if best == float("-inf") else best,
                  "best_step": best_step, "last_step": self.step,
                  "history": self.history}
        os.makedirs(opt.checkpoint_path, exist_ok=True)
        tmp = os.path.join(opt.checkpoint_path, f"infos.json.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(result, f)
        os.replace(tmp, os.path.join(opt.checkpoint_path, "infos.json"))
        return result

