"""Additive (Bahdanau) attention for the attention-LSTM decoder
(counterpart of the reference's ``ops/attention.py``).

The memory projection ``W_m memory`` depends only on the encoder output,
so the caller computes it once per video and passes it to every step;
this module holds the per-step parameters (query projection + score
vector).  ``use_kernel=True`` routes the score -> softmax -> context
chain through the K1 kernel wrapper (``ops/attention_kernel.py``) with
the same parameters and the same math.
"""

from __future__ import annotations

import torch
from torch import nn

from .attention_kernel import additive_attention_plain, \
    fused_additive_attention


class AdditiveAttention(nn.Module):
    """score(h, m_t) = v . tanh(proj_mem_t + W_q h); returns (ctx, w)."""

    def __init__(self, hidden_size: int, attn_size: int,
                 use_kernel: bool = False):
        super().__init__()
        self.query_proj = nn.Linear(hidden_size, attn_size, bias=False)
        self.score_v = nn.Parameter(torch.zeros(attn_size))
        self.use_kernel = use_kernel

    def forward(self, query: torch.Tensor, memory: torch.Tensor,
                projected_memory: torch.Tensor):
        q = self.query_proj(query)                               # (B, A)
        attend = (fused_additive_attention if self.use_kernel
                  else additive_attention_plain)
        return attend(q, projected_memory, memory, self.score_v)
