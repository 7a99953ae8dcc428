"""Training steps: XE/WXE, the CST rollout, the REINFORCE gradient and the
fused CST step (counterpart of the reference's ``training/steps.py``).

The CST stage runs one of two ways:

- **fused** (``fused_cst_step``, the default ``--device_rewards 1``): the
  whole iteration on the device, rollout (K2) -> on-device CIDEr-D
  (``ops/device_ciderd.py``) -> advantage -> REINFORCE gradient (K1 and
  its backward) -> guarded update, strictly on-policy, with nothing read
  back to the host but the rollout's early-exit check;
- **host reward** (``--device_rewards 0``): ``rollout`` -> host CIDEr-D
  advantage -> ``rl_grad_step``, driven by ``training/pipeline.py``.

The gradient step recomputes log p(sampled) by teacher forcing, without
dropout, instead of keeping the rollout's graph, as the reference does.
Steps return their metrics as tensors on the device (``loss``, and
``grad_norm`` before the clip); nothing here waits for the device.

``guard=True`` folds the divergence guard's device half into the update
(``apply_gradients_guarded``): ``ok = isfinite(loss) & isfinite(norm)``
on the device selects the new or the old parameters and optimizer state,
and ``bad_step`` reports ``1 - ok`` as a 0-d tensor.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..ops.device_ciderd import CorpusTable, RefTables, ciderd_scores
from ..ops.losses import (cross_entropy_loss, reward_loss, sequence_mask,
                          token_logprobs)
from ..ops.sampling import Noise, sample_captions, sample_with_baseline
from .rewards import BASELINES
from .state import Optimizer


def apply_gradients_guarded(opt: Optimizer, loss: torch.Tensor,
                            guard: bool) -> Dict[str, torch.Tensor]:
    """The optimizer update with the divergence guard's device half
    (counterpart of ``_apply_gradients_guarded``).  The gradients are in
    the parameters' ``.grad``.  With ``guard`` a non-finite loss or
    gradient norm leaves every parameter and optimizer tensor (the count
    too) as it was, bit for bit, and ``bad_step`` is 1; a good guarded
    step is bit-identical to an unguarded one."""
    loss = loss.detach()
    norm = opt.grad_norm()
    metrics = {"loss": loss, "grad_norm": norm}
    ok = None
    if guard:
        ok = torch.isfinite(loss) & torch.isfinite(norm)
        metrics["bad_step"] = 1.0 - ok.float()
    opt.step(ok=ok, norm=norm)
    return metrics


def xe_step(model, opt: Optimizer, feats: Sequence[torch.Tensor],
            labels: torch.Tensor, weights: torch.Tensor, seq_per_img: int,
            generator: torch.Generator, guard: bool = False
            ) -> Dict[str, torch.Tensor]:
    """One XE (all-ones ``weights``) or WXE (consensus weights) update
    with dropout on, masks from ``generator``."""
    opt.zero_grad()
    logits = model(feats, labels, seq_per_img, train=True,
                   generator=generator)
    loss = cross_entropy_loss(logits, labels, weights)
    loss.backward()
    return apply_gradients_guarded(opt, loss, guard)


def rollout(model, feats: Sequence[torch.Tensor], max_len: int,
            seq_per_img: int, noise: Noise, temperature: float = 1.0,
            greedy_baseline: bool = True, decode_chunk: int = 0
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """-> (sampled (B*S, L), greedy (B, L) or None, decode steps run).
    With ``greedy_baseline`` the greedy rows ride the sampled rows' rollout
    (one K2 batch of B*S + B rows); SCB baselines roll out the samples
    only."""
    if greedy_baseline:
        sampled, _, greedy, steps = sample_with_baseline(
            model, feats, max_len, seq_per_img, temperature=temperature,
            noise=noise, decode_chunk=decode_chunk, return_steps=True)
        return sampled, greedy, steps
    sampled, _, steps = sample_captions(
        model, feats, max_len, seq_per_img=seq_per_img, greedy=False,
        temperature=temperature, noise=noise, decode_chunk=decode_chunk,
        return_steps=True)
    return sampled, None, steps


def rl_grad_step(model, opt: Optimizer, feats: Sequence[torch.Tensor],
                 sampled: torch.Tensor, advantage: torch.Tensor,
                 seq_per_img: int, guard: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """REINFORCE update: teacher-force the samples WITHOUT dropout (the
    policy reinforced is the one that drew them), then ``reward_loss``."""
    opt.zero_grad()
    logits = model(feats, sampled, seq_per_img, train=False)
    loss = reward_loss(token_logprobs(logits, sampled), sampled, advantage)
    loss.backward()
    metrics = apply_gradients_guarded(opt, loss, guard)
    metrics["sample_len"] = sequence_mask(sampled).sum(dim=1).mean()
    return metrics


def fused_cst_step(model, opt: Optimizer, feats: Sequence[torch.Tensor],
                   video_ix: torch.Tensor, noise: Noise,
                   corpus: CorpusTable, tables: RefTables, max_len: int,
                   seq_per_img: int, baseline: str = "greedy",
                   temperature: float = 1.0,
                   scb_gt_baseline: Optional[torch.Tensor] = None,
                   ref_chunk: Optional[int] = None, guard: bool = False,
                   decode_chunk: int = 0,
                   mark: Optional[Callable[[str], None]] = None
                   ) -> Dict[str, torch.Tensor]:
    """The whole CST iteration on the device (counterpart of
    ``make_fused_cst_step``): rollout, on-device CIDEr-D of the samples
    (and of the greedy rows under the greedy baseline), the baseline, the
    advantage, the teacher-forced recompute and the guarded update.

    ``video_ix`` (B,) are the batch's dataset video indices
    (``Batch.video_ix``) on the device: they index ``tables`` and, for
    scb-gt, ``scb_gt_baseline`` (V,).  ``mark(name)``, when given, is
    called at the phase boundaries ("start", "rollout", "reward",
    "grad"); the trainer records a CUDA event there.  Returns ``loss``,
    ``grad_norm``, ``bad_step`` (with ``guard``), ``sample_len``,
    ``reward``, ``baseline``, ``advantage`` (means) and ``rollout_steps``,
    all 0-d tensors on the device."""
    if baseline not in BASELINES:
        raise ValueError(f"baseline {baseline!r} not in {BASELINES}")
    if baseline == "scb-gt" and scb_gt_baseline is None:
        raise ValueError("scb-gt fused step needs the per-video baseline "
                         "table")
    if baseline == "scb-sample" and seq_per_img < 2:
        # /(S-1) would be a silent NaN on the device
        raise ValueError("scb-sample baseline needs seq_per_img >= 2")
    mark = mark or (lambda name: None)
    mark("start")
    sampled, greedy, steps = rollout(
        model, feats, max_len, seq_per_img, noise, temperature=temperature,
        greedy_baseline=baseline == "greedy", decode_chunk=decode_chunk)
    mark("rollout")
    hyp_vix = torch.repeat_interleave(video_ix, seq_per_img)
    r_sample = ciderd_scores(sampled, hyp_vix, corpus, tables,
                             ref_chunk=ref_chunk)
    if baseline == "greedy":
        r_base = torch.repeat_interleave(
            ciderd_scores(greedy, video_ix, corpus, tables,
                          ref_chunk=ref_chunk), seq_per_img)
    elif baseline == "scb-sample":
        per_vid = r_sample.view(-1, seq_per_img)
        r_base = ((per_vid.sum(dim=1, keepdim=True) - per_vid)
                  / (seq_per_img - 1)).reshape(-1)
    else:
        r_base = torch.repeat_interleave(scb_gt_baseline[video_ix.long()],
                                         seq_per_img)
    advantage = (r_sample - r_base).float()
    mark("reward")
    opt.zero_grad()
    logits = model(feats, sampled, seq_per_img, train=False)
    loss = reward_loss(token_logprobs(logits, sampled), sampled, advantage)
    loss.backward()
    metrics = apply_gradients_guarded(opt, loss, guard)
    mark("grad")
    metrics.update({
        "sample_len": sequence_mask(sampled).sum(dim=1).mean(),
        "reward": r_sample.mean(), "baseline": r_base.mean(),
        "advantage": advantage.mean(),
        # decode steps the rollout ran (max_len without the early exit)
        "rollout_steps": torch.full((), float(steps), device=loss.device)})
    return metrics
