"""Multi-modality feature encoder (counterpart of the reference's
``models/encoder.py``).

Each modality's (B, T_m, D_m) features go through a Linear + ReLU, and
the per-modality time means are concatenated and fused (Linear + tanh)
into ``pooled`` (B, H), which initialises the decoder state.  The
attention memory is, by ``fusion``:

- ``"temporal"``: the per-timestep projections concatenated along time,
  (B, sum_m T_m, H);
- ``"modality"`` (the reference's "manet" variant): the per-modality
  time means stacked, one token per modality, (B, M, H).

With ``train=True`` and ``drop_prob`` > 0, dropout applies at the
reference's sites: ``pooled`` first, then ``memory``.  Masks come from the
``torch.Generator`` the caller passes (``dropout``), or from a
data-parallel rank's ``parallel.mesh.RowDraw``: its rows of the global
draw.

Under context parallelism (``time_shard``, ``parallel/cp.py``) the
memory is this rank's time block of the temporal memory: a time-sharded
modality comes in as its time range only and its mean is the all-reduced
block sums over its global T; a replicated modality comes in whole.

``dtype`` is the compute dtype (``precision.py``): the features
are cast to it first, as the reference casts them, and every Dense
computes in it over the float32 parameters.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..parallel.mesh import RowDraw
from ..parallel.sequence import all_sum
from ..precision import compute_dtype, dense

FUSIONS = ("temporal", "modality")


def dropout_keep(shape, p: float, generator: Optional[torch.Generator],
                 device, rows: bool = True) -> torch.Tensor:
    """The keep mask of ``dropout``: ``uniform < 1 - p`` from
    ``generator``, which must live on ``device``.  A ``RowDraw`` draws
    this rank's rows of the global mask; ``rows=False`` marks a mask
    without a batch axis, the same on every rank."""
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator")
    if isinstance(generator, RowDraw):
        return generator.rand(shape, device, rows) < 1.0 - p
    return torch.rand(shape, generator=generator, device=device) < 1.0 - p


def apply_keep(x: torch.Tensor, keep: torch.Tensor, p: float) -> torch.Tensor:
    """``x / (1 - p)`` where ``keep``, else 0."""
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout`` semantics: keep each element with probability
    ``1 - p`` (``uniform < 1 - p``) and scale it by ``1 / (1 - p)``.  The
    uniforms come from ``generator``, which must live on ``x``'s device."""
    return apply_keep(x, dropout_keep(x.shape, p, generator, x.device), p)


class FeatureEncoder(nn.Module):
    """Returns (memory (B, sum_m T_m, H) or (B, M, H), pooled (B, H))."""

    def __init__(self, feat_dims: Sequence[int], hidden_size: int,
                 drop_prob: float = 0.0, dtype: torch.dtype = torch.float32,
                 fusion: str = "temporal"):
        super().__init__()
        if len(feat_dims) == 0:
            raise ValueError("need at least one feature modality")
        if fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {fusion!r}; one of {FUSIONS}")
        self.fusion = fusion
        self.drop_prob = drop_prob
        self.dtype = compute_dtype(dtype)
        self.embed = nn.ModuleList(nn.Linear(int(d), hidden_size)
                                   for d in feat_dims)
        self.fuse = nn.Linear(len(feat_dims) * hidden_size, hidden_size)
        #: The context-parallel layout (``parallel/cp.TimeShard``), or None.
        self.time_shard = None

    def forward(self, feats: Sequence[torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None):
        if len(feats) != len(self.embed):
            raise ValueError(f"expected {len(self.embed)} modalities, got "
                             f"{len(feats)}")
        ts = self.time_shard
        if ts is not None and train and self.drop_prob > 0:
            raise ValueError("context parallelism trains without dropout "
                             "(drop_prob 0)")
        projected, pooled = [], []
        for m, (x, embed) in enumerate(zip(feats, self.embed)):
            if x.ndim != 3:
                raise ValueError(
                    f"modality {m}: expected (B, T, D), got {tuple(x.shape)}")
            h = torch.relu(dense(x.to(self.dtype), embed.weight, embed.bias,
                                 self.dtype))
            if ts is None:
                projected.append(h)                    # (B, T_m, H)
                pooled.append(h.mean(dim=1))           # (B, H)
            elif ts.sharded[m]:                        # its time range only
                projected.append(h)
                pooled.append(all_sum(h.sum(dim=1), ts.axis)
                              / ts.feat_times[m])
            else:                                      # replicated, whole
                a, b = ts.ranges[m]
                projected.append(h[:, a:b])
                pooled.append(h.mean(dim=1))
        memory = (torch.stack(pooled, dim=1) if self.fusion == "modality"
                  else torch.cat(projected, dim=1))
        fused = torch.tanh(dense(torch.cat(pooled, dim=-1), self.fuse.weight,
                                 self.fuse.bias, self.dtype))
        if train and self.drop_prob > 0:
            fused = dropout(fused, self.drop_prob, generator)
            memory = dropout(memory, self.drop_prob, generator)
        return memory, fused
