"""Sequence losses: masked XE, consensus-weighted XE, REINFORCE
(counterpart of the reference's ``ops/losses.py``).

Masking convention (0 = EOS labels): position t is supervised iff every
earlier target token is nonzero, i.e. the words up to and including the
first 0 (the model must learn to emit EOS); everything after is padding.

``total``, where given, turns the batch's mask total into the global
batch's before the division (``parallel.dp.DataParallel.sum``: a
data-parallel rank's loss is its share of the global loss).

The log-softmax runs in the logits' dtype (``precision.log_softmax``);
bfloat16 log-probabilities become float32 where they meet the float32
mask, weights or advantage, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..precision import log_softmax


def sequence_mask(targets: torch.Tensor) -> torch.Tensor:
    """(N, L) 0-terminated targets -> float mask covering words + first EOS:
    ``mask[:, 0] = 1``, ``mask[:, t] = all(targets[:, :t] != 0)``."""
    nonzero = (targets != 0).float()
    leading = torch.cumprod(nonzero[:, :-1], dim=1)
    return torch.cat([torch.ones_like(nonzero[:, :1]), leading], dim=1)


def token_logprobs(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """log p(target_t) per position: (N, L, V), (N, L) -> (N, L)."""
    logp = log_softmax(logits, dim=-1)
    return logp.gather(-1, targets.long()[..., None])[..., 0]


def _denominator(mask: torch.Tensor,
                 total: Optional[Callable[[torch.Tensor], torch.Tensor]]
                 ) -> torch.Tensor:
    n = mask.sum()
    return (n if total is None else total(n)).clamp(min=1.0)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       total: Optional[Callable] = None) -> torch.Tensor:
    """Masked sequence XE; with ``weights`` (N,) the WXE criterion (each
    caption's token losses times its consensus weight).  Normalised by the
    *unweighted* mask total, so XE and WXE share a scale and learning rates
    carry over between the stages."""
    mask = sequence_mask(targets)
    nll = -token_logprobs(logits, targets) * mask
    if weights is not None:
        nll = nll * weights[:, None]
    return nll.sum() / _denominator(mask, total)


def reward_loss(sample_logprobs: torch.Tensor, sampled: torch.Tensor,
                advantage: torch.Tensor,
                total: Optional[Callable] = None) -> torch.Tensor:
    """REINFORCE: ``-E[advantage * log p(sampled)]`` masked to the sampled
    sequence (words + first EOS).  ``advantage`` (N,) is a constant: no
    gradient flows into it."""
    mask = sequence_mask(sampled)
    loss = -(sample_logprobs * advantage.detach()[:, None] * mask)
    return loss.sum() / _denominator(mask, total)
