"""Transformer caption decoder (counterpart of the reference's
``models/decoder_transformer.py``).

Pre-LN blocks: causal self-attention over the word prefix,
cross-attention over the encoder memory, then an MLP ``Dense(4H) ->
gelu -> Dense(H)`` with dropout on its output.  The fused video feature
``pooled`` is added at every position, after the word embedding and the
learned positions; a final LayerNorm precedes the vocab head.

The ops follow flax 0.12.3's modules, where a plain torch port would
round otherwise:

- ``LayerNorm``: epsilon 1e-6, statistics in float32 with the fast
  variance ``E[x^2] - E[x]^2`` (clipped at 0), the scale folded into the
  reciprocal square root before it multiplies ``x - mean``, one rounding
  to the compute dtype at the end;
- ``MultiHeadAttention`` (``nn.MultiHeadDotProductAttention``): q, k, v
  and the output are biased Dense layers; the query is divided by
  ``sqrt(head_dim)`` before the product, masked scores are set to the
  dtype's ``finfo.min``, the softmax runs in the compute dtype, and the
  attention-weight dropout draws one (Lq, Lk) mask for every row and
  head (``broadcast_dropout``);
- ``gelu`` is the tanh approximation (``precision.gelu``).

The attention is plain PyTorch: the reference computes it in XLA and
reaches no TPU kernel.

Autoregressive decoding works over a static token buffer, the
reference's carry ``(buffer (B, Lmax), position)``: ``decode`` writes
the L tokens at ``[pos, pos + L)`` and returns their logits.  The
reference recomputes the whole buffer each step; under the causal mask
the positions below ``pos + L`` do not depend on later ones, so this
port runs the blocks over the prefix ``[0, pos + L)`` alone and the vocab
head over the L positions it returns (``full=True`` runs the whole
buffer, as the reference does).  The position is a Python int: the
beam search's reorder passes it through.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..precision import compute_dtype, dense, embed, gelu, softmax
from .encoder import dropout, dropout_keep

TxCarry = Tuple[torch.Tensor, int]   # (token buffer (B, Lmax), position)

#: flax ``nn.LayerNorm``'s default epsilon.
LN_EPS = 1e-6


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis (see the module doc)."""

    def __init__(self, size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.scale = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True)
               - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class MultiHeadAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` with ``qkv_features =
    out_features = H`` (see the module doc).  The projections are
    ``nn.Linear`` layers over the flattened (heads x head_dim) axis."""

    def __init__(self, hidden_size: int, num_heads: int,
                 drop_prob: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden size {hidden_size} is not divisible "
                             f"by {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.drop_prob = drop_prob
        self.dtype = compute_dtype(dtype)
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)
        self.out = nn.Linear(hidden_size, hidden_size)

    def _heads(self, x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        b, n, _ = x.shape
        return dense(x, layer.weight, layer.bias, self.dtype).view(
            b, n, self.num_heads, self.head_dim)

    def forward(self, xq: torch.Tensor, xkv: torch.Tensor,
                mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """xq (B, Lq, H), xkv (B, Lk, H), mask (Lq, Lk) bool (True =
        attend) -> (B, Lq, H)."""
        q = self._heads(xq, self.query)
        k = self._heads(xkv, self.key)
        v = self._heads(xkv, self.value)
        q = q / torch.tensor(self.head_dim ** 0.5, dtype=self.dtype)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            scores = scores.masked_fill(~mask,
                                        torch.finfo(scores.dtype).min)
        w = softmax(scores, dim=-1)
        if train and self.drop_prob > 0:
            keep = dropout_keep(w.shape[-2:], self.drop_prob, generator,
                                w.device)
            w = w * (keep.to(w.dtype)
                     / torch.tensor(1.0 - self.drop_prob, dtype=w.dtype))
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        b, n = out.shape[:2]
        return dense(out.reshape(b, n, -1), self.out.weight, self.out.bias,
                     self.dtype)


class TransformerBlock(nn.Module):
    """Pre-LN block: causal self-attention, cross-attention, MLP."""

    def __init__(self, hidden_size: int, num_heads: int,
                 drop_prob: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_prob = drop_prob
        self.dtype = compute_dtype(dtype)
        self.ln0 = LayerNorm(hidden_size, dtype=self.dtype)
        self.self_attn = MultiHeadAttention(hidden_size, num_heads,
                                            drop_prob, self.dtype)
        self.ln1 = LayerNorm(hidden_size, dtype=self.dtype)
        self.cross_attn = MultiHeadAttention(hidden_size, num_heads,
                                             drop_prob, self.dtype)
        self.ln2 = LayerNorm(hidden_size, dtype=self.dtype)
        self.mlp0 = nn.Linear(hidden_size, 4 * hidden_size)
        self.mlp1 = nn.Linear(4 * hidden_size, hidden_size)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                causal: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.ln0(x)
        x = x + self.self_attn(y, y, causal, train, generator)
        y = self.ln1(x)
        x = x + self.cross_attn(y, memory, None, train, generator)
        y = self.ln2(x)
        y = gelu(dense(y, self.mlp0.weight, self.mlp0.bias, self.dtype))
        y = dense(y, self.mlp1.weight, self.mlp1.bias, self.dtype)
        if train and self.drop_prob > 0:
            y = dropout(y, self.drop_prob, generator)
        return x + y


class TransformerDecoder(nn.Module):
    """Word embedding (V, H), positions (max_len, H), ``num_layers``
    blocks, final LayerNorm, vocab head."""

    def __init__(self, vocab_size: int, hidden_size: int = 512,
                 num_layers: int = 2, num_heads: int = 8,
                 drop_prob: float = 0.0, max_len: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_len = max_len
        self.dtype = compute_dtype(dtype)
        self.embed = nn.Embedding(vocab_size, hidden_size)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, hidden_size))
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden_size, num_heads, drop_prob, self.dtype)
            for _ in range(num_layers))
        self.ln = LayerNorm(hidden_size, dtype=self.dtype)
        self.logit = nn.Linear(hidden_size, vocab_size)

    def hidden(self, inputs: torch.Tensor, memory: torch.Tensor,
               pooled: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, L) tokens -> (B, L, H) after the final LayerNorm."""
        length = inputs.shape[1]
        if length > self.max_len:
            raise ValueError(f"sequence {length} exceeds max_len "
                             f"{self.max_len}")
        x = (embed(inputs, self.embed.weight, self.dtype)
             + self.pos_embed[:length].to(self.dtype)[None]
             + pooled.to(self.dtype)[:, None, :])
        causal = torch.ones(length, length, dtype=torch.bool,
                            device=inputs.device).tril()
        for block in self.blocks:
            x = block(x, memory, causal, train, generator)
        return self.ln(x)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return dense(h, self.logit.weight, self.logit.bias, self.dtype)

    def forward(self, inputs: torch.Tensor, memory: torch.Tensor,
                pooled: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced parallel decode: (B, L) tokens -> (B, L, V)."""
        return self.logits(self.hidden(inputs, memory, pooled, train,
                                       generator))

    def decode(self, carry: TxCarry, tokens: torch.Tensor,
               memory: torch.Tensor, pooled: torch.Tensor,
               train: bool = False,
               generator: Optional[torch.Generator] = None,
               full: bool = False):
        """tokens (B, L) written at ``[pos, pos + L)`` of the buffer ->
        ((buffer, pos + L), logits (B, L, V)).  The blocks run over the
        prefix ``[0, pos + L)``, or the whole buffer with ``full``."""
        buf, pos = carry
        n = tokens.shape[1]
        if pos + n > buf.shape[1]:
            raise ValueError(f"decode past the buffer: positions "
                             f"[{pos}, {pos + n}) of {buf.shape[1]}")
        buf = buf.clone()
        buf[:, pos:pos + n] = tokens
        h = self.hidden(buf if full else buf[:, :pos + n], memory, pooled,
                        train, generator)
        return (buf, pos + n), self.logits(h[:, pos:pos + n])
