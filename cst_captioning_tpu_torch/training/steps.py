"""Training steps: XE/WXE, the CST rollout, the REINFORCE gradient
(counterpart of the reference's ``training/steps.py``, host-reward path).

The CST stage is two device phases with the host reward between them:

    rollout (no grad: K2) -> reward/advantage (host) -> gradient step

The gradient step recomputes log p(sampled) by teacher forcing (K1 and
its backward) instead of keeping the rollout's graph, as the reference
does.  Steps return their metrics as tensors on the device (``loss``,
and ``grad_norm`` before the clip); nothing here waits for the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops.losses import cross_entropy_loss, reward_loss, token_logprobs
from ..ops.sampling import Noise, sample_captions, sample_with_baseline
from .state import Optimizer


def xe_step(model, opt: Optimizer, feats: Sequence[torch.Tensor],
            labels: torch.Tensor, weights: torch.Tensor, seq_per_img: int,
            generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One XE (all-ones ``weights``) or WXE (consensus weights) update
    with dropout on, masks from ``generator``."""
    opt.zero_grad()
    logits = model(feats, labels, seq_per_img, train=True,
                   generator=generator)
    loss = cross_entropy_loss(logits, labels, weights)
    loss.backward()
    return {"loss": loss.detach(), "grad_norm": opt.step()}


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
                 seq_per_img: int) -> Dict[str, torch.Tensor]:
    """REINFORCE update: teacher-force the samples WITHOUT dropout (the
    policy reinforced is the one that drew them), then ``reward_loss``."""
    opt.zero_grad()
    logits = model(feats, sampled, seq_per_img, train=False)
    loss = reward_loss(token_logprobs(logits, sampled), sampled, advantage)
    loss.backward()
    return {"loss": loss.detach(), "grad_norm": opt.step()}
