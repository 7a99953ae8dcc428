"""Multi-modality feature encoder (counterpart of the reference's
``models/encoder.py``, ``fusion="temporal"``).

Each modality's (B, T_m, D_m) features go through a Linear + ReLU; the
per-timestep projections are concatenated along time into the attention
memory (B, sum_m T_m, H), and the per-modality time means are
concatenated and fused (Linear + tanh) into ``pooled`` (B, H), which
initialises the decoder state.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class FeatureEncoder(nn.Module):
    """Returns (memory (B, sum_m T_m, H), pooled (B, H))."""

    def __init__(self, feat_dims: Sequence[int], hidden_size: int):
        super().__init__()
        if len(feat_dims) == 0:
            raise ValueError("need at least one feature modality")
        self.embed = nn.ModuleList(nn.Linear(int(d), hidden_size)
                                   for d in feat_dims)
        self.fuse = nn.Linear(len(feat_dims) * hidden_size, hidden_size)

    def forward(self, feats: Sequence[torch.Tensor]):
        if len(feats) != len(self.embed):
            raise ValueError(f"expected {len(self.embed)} modalities, got "
                             f"{len(feats)}")
        projected, pooled = [], []
        for m, (x, embed) in enumerate(zip(feats, self.embed)):
            if x.ndim != 3:
                raise ValueError(
                    f"modality {m}: expected (B, T, D), got {tuple(x.shape)}")
            h = torch.relu(embed(x.float()))
            projected.append(h)                        # (B, T_m, H)
            pooled.append(h.mean(dim=1))               # (B, H)
        memory = torch.cat(projected, dim=1)
        fused = torch.tanh(self.fuse(torch.cat(pooled, dim=-1)))
        return memory, fused
