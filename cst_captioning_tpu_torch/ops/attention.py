"""Additive (Bahdanau) attention for the attention-LSTM decoder
(counterpart of the reference's ``ops/attention.py``).

The memory projection ``W_m memory`` depends only on the encoder output,
so the caller computes it once per video and passes it to every step;
this module holds the per-step parameters (query projection + score
vector).  ``use_kernel=True`` routes the score -> softmax -> context
chain through the K1 kernel wrapper (``ops/attention_kernel.py``) with
the same parameters and the same math.

``dtype`` is the compute dtype (``precision.py``): the query
projection runs in it; the scores, the softmax and the context run in
float32 from operands cast to float32 BEFORE the add (``score_v`` stays
a float32 parameter), and the context and weights come back in
``dtype``, as the reference's ``ops/attention.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..precision import compute_dtype, dense
from .attention_kernel import additive_attention_plain, \
    fused_additive_attention


class AdditiveAttention(nn.Module):
    """score(h, m_t) = v . tanh(proj_mem_t + W_q h); returns (ctx, w)."""

    def __init__(self, hidden_size: int, attn_size: int,
                 use_kernel: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.query_proj = nn.Linear(hidden_size, attn_size, bias=False)
        self.score_v = nn.Parameter(torch.zeros(attn_size))
        self.use_kernel = use_kernel

    def forward(self, query: torch.Tensor, memory: torch.Tensor,
                projected_memory: torch.Tensor):
        q = dense(query, self.query_proj.weight, None, self.dtype)  # (B, A)
        attend = (fused_additive_attention if self.use_kernel
                  else additive_attention_plain)
        ctx, w = attend(q, projected_memory, memory, self.score_v)
        return ctx.to(self.dtype), w.to(self.dtype)
