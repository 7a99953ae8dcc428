"""Attention-LSTM decoder cell (counterpart of the reference's
``models/decoder_lstm.py``).

One decode step: embed the token, attend over the encoder memory (or
take the pooled feature when attention is off), run the LSTM stack.  The
vocab head lives outside the cell, in ``CaptionModel``, as in the
reference.  Dropout is identity at inference, so the cell has none.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.attention import AdditiveAttention

Carry = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # ((c, h) per layer)


class LSTMLayer(nn.Module):
    """flax ``OptimizedLSTMCell`` algebra: gates ``h @ W_h + b`` plus
    ``inp @ W_i`` (bias on the h side only) in i, f, g, o order;
    ``c' = f*c + i*g``, ``h' = o*tanh(c')``.

    Weights keep the reference's ``(in, out)`` layout in one parameter,
    ``w = [W_i; W_h]`` of shape ``(in + H, 4H)`` — the layout the fused
    decode kernel reads, so binding it copies nothing."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.input_size = input_size
        self.w = nn.Parameter(torch.zeros(input_size + hidden_size,
                                          4 * hidden_size))
        self.bias = nn.Parameter(torch.zeros(4 * hidden_size))

    def forward(self, carry, inp: torch.Tensor):
        c, h = carry
        n = self.input_size
        gh = h @ self.w[n:] + self.bias
        gi = inp @ self.w[:n]
        i, f, g, o = (gh + gi).chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class DecoderCell(nn.Module):
    """One decode step: embed token, attend, run LSTM stack -> hidden."""

    def __init__(self, vocab_size: int, embed_size: int, hidden_size: int,
                 num_layers: int = 1, attn_size: int = 512,
                 use_attention: bool = True,
                 use_kernel_attention: bool = False):
        super().__init__()
        self.use_attention = use_attention
        self.embed = nn.Embedding(vocab_size, embed_size)
        self.attn = (AdditiveAttention(hidden_size, attn_size,
                                       use_kernel=use_kernel_attention)
                     if use_attention else None)
        self.lstm = nn.ModuleList(
            LSTMLayer(embed_size + hidden_size if layer == 0
                      else hidden_size, hidden_size)
            for layer in range(num_layers))

    def forward(self, carry: Carry, token: torch.Tensor,
                memory: torch.Tensor, proj_mem: torch.Tensor,
                pooled: torch.Tensor):
        x = self.embed(token)
        if self.attn is not None:
            context, _ = self.attn(carry[-1][1], memory, proj_mem)
        else:
            context = pooled
        inp = torch.cat([x, context.to(x.dtype)], dim=-1)
        new_carry = []
        for layer in self.lstm:
            layer_carry, inp = layer(carry[len(new_carry)], inp)
            new_carry.append(layer_carry)
        return tuple(new_carry), inp
