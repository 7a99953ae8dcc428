"""Attention-LSTM decoder cell (counterpart of the reference's
``models/decoder_lstm.py``).

One decode step: embed the token, attend over the encoder memory (or
take the pooled feature when attention is off), run the LSTM stack.  The
vocab head lives outside the cell, in ``CaptionModel``, as in the
reference.  Dropout applies to the top layer's output ``h`` (not to the
carry), as in the reference, with the keep mask the caller drew
(``keep``; ``CaptionModel.decode`` draws it before the step, as
``--remat_cell`` needs).

``dtype`` is the compute dtype (``precision.py``): the embedding, the
gate algebra and the carry run in it over float32 parameters, in flax
``OptimizedLSTMCell``'s op order (each op rounds to ``dtype``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.attention import AdditiveAttention
from ..precision import compute_dtype, embed, sigmoid
from .encoder import apply_keep

Carry = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # ((c, h) per layer)


class LSTMLayer(nn.Module):
    """flax ``OptimizedLSTMCell`` algebra: gates ``h @ W_h + b`` plus
    ``inp @ W_i`` (bias on the h side only) in i, f, g, o order;
    ``c' = f*c + i*g``, ``h' = o*tanh(c')``.

    Weights keep the reference's ``(in, out)`` layout in one parameter,
    ``w = [W_i; W_h]`` of shape ``(in + H, 4H)`` — the layout the fused
    decode kernel reads, so binding it copies nothing.

    In bfloat16 the weights and bias are cast at use and every op below
    rounds to bfloat16: ``h @ W_h``, ``+ b``, ``inp @ W_i``, their sum,
    each activation, ``f*c``, ``i*g``, ``c'``, ``tanh(c')`` and ``h'``."""

    def __init__(self, input_size: int, hidden_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_size = input_size
        self.dtype = compute_dtype(dtype)
        self.w = nn.Parameter(torch.zeros(input_size + hidden_size,
                                          4 * hidden_size))
        self.bias = nn.Parameter(torch.zeros(4 * hidden_size))

    def forward(self, carry, inp: torch.Tensor):
        c, h = carry
        n = self.input_size
        w = self.w.to(self.dtype)
        gh = h.to(self.dtype) @ w[n:] + self.bias.to(self.dtype)
        gi = inp.to(self.dtype) @ w[:n]
        i, f, g, o = (gh + gi).chunk(4, dim=-1)
        new_c = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
        new_h = sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class DecoderCell(nn.Module):
    """One decode step: embed token, attend, run LSTM stack -> hidden."""

    def __init__(self, vocab_size: int, embed_size: int, hidden_size: int,
                 num_layers: int = 1, attn_size: int = 512,
                 use_attention: bool = True,
                 use_kernel_attention: bool = False,
                 drop_prob: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_attention = use_attention
        self.drop_prob = drop_prob
        self.dtype = compute_dtype(dtype)
        self.embed = nn.Embedding(vocab_size, embed_size)
        self.attn = (AdditiveAttention(hidden_size, attn_size,
                                       use_kernel=use_kernel_attention,
                                       dtype=self.dtype)
                     if use_attention else None)
        self.lstm = nn.ModuleList(
            LSTMLayer(embed_size + hidden_size if layer == 0
                      else hidden_size, hidden_size, dtype=self.dtype)
            for layer in range(num_layers))

    def forward(self, carry: Carry, token: torch.Tensor,
                memory: torch.Tensor, proj_mem: torch.Tensor,
                pooled: torch.Tensor, keep: Optional[torch.Tensor] = None):
        """``keep``, when given, is the dropout mask of ``h``, drawn by the
        caller (so a recompute applies the same one)."""
        x = embed(token, self.embed.weight, self.dtype)
        if self.attn is not None:
            context, _ = self.attn(carry[-1][1], memory, proj_mem)
        else:
            context = pooled
        inp = torch.cat([x, context.to(x.dtype)], dim=-1)
        new_carry = []
        for layer in self.lstm:
            layer_carry, inp = layer(carry[len(new_carry)], inp)
            new_carry.append(layer_carry)
        if keep is not None:
            inp = apply_keep(inp, keep, self.drop_prob)
        return tuple(new_carry), inp
