"""CaptionModel — encoder + attention-LSTM decoder (counterpart of the
reference's ``models/captioner.py``, LSTM decoder only).

Surfaces, as in the reference:
- ``encode(feats)`` -> (memory (B,T,H), proj_mem (B,T,A), pooled (B,H));
- ``init_carry(pooled)`` -> per-layer (c, h) from ``state_init_{l}``;
- ``decode(carry, tokens (B, L), ...)`` -> (carry, logits (B, L, V));
  L == 1 is the autoregressive step the samplers drive;
- ``forward(feats, labels)`` — teacher-forced logits (inference
  semantics: the port has no dropout).

``decode_kernel`` selects the decode-step cell the samplers, beam search
and the serving engine bind (``ops/sampling.make_decode_step``):
``"reference"`` is this module's cell, ``"fused"`` the K2 CUDA kernel
(counterpart of the reference's ``"pallas"``).  ``"fused"`` on a model the
kernel does not cover raises here, at construction.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.decode_cell_kernel import fused_decode_supported
from .decoder_lstm import Carry, DecoderCell
from .encoder import FeatureEncoder

DECODE_KERNELS = ("reference", "fused")


def shift_right(labels: torch.Tensor) -> torch.Tensor:
    """Teacher-forcing inputs: BOS (=0) then the target prefix."""
    return torch.cat([torch.zeros_like(labels[:, :1]), labels[:, :-1]],
                     dim=1)


def repeat_for_captions(x: torch.Tensor, seq_per_img: int) -> torch.Tensor:
    """(B, ...) -> (B*S, ...): align per-video encodings with caption rows."""
    return x if seq_per_img == 1 else x.repeat_interleave(seq_per_img, 0)


class CaptionModel(nn.Module):
    def __init__(self, vocab_size: int, feat_dims: Sequence[int],
                 embed_size: int = 512, hidden_size: int = 512,
                 num_layers: int = 1, attn_size: int = 512,
                 use_attention: bool = True,
                 use_kernel_attention: bool = False,
                 decode_kernel: str = "reference"):
        super().__init__()
        if decode_kernel not in DECODE_KERNELS:
            raise ValueError(f"decode_kernel must be one of {DECODE_KERNELS}, "
                             f"got {decode_kernel!r}")
        self.vocab_size = vocab_size
        self.feat_dims = tuple(int(d) for d in feat_dims)
        self.embed_size = embed_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.attn_size = attn_size
        self.use_attention = use_attention
        self.decode_kernel = decode_kernel
        if decode_kernel == "fused":
            ok, reason = fused_decode_supported(self)
            if not ok:
                raise ValueError(f"decode_kernel='fused' does not cover "
                                 f"this model: {reason}")
        self.encoder = FeatureEncoder(self.feat_dims, hidden_size)
        self.memory_proj = nn.Linear(hidden_size, attn_size, bias=False)
        self.cell = DecoderCell(vocab_size, embed_size, hidden_size,
                                num_layers=num_layers, attn_size=attn_size,
                                use_attention=use_attention,
                                use_kernel_attention=use_kernel_attention)
        self.state_init = nn.ModuleList(
            nn.Linear(hidden_size, 2 * hidden_size)
            for _ in range(num_layers))
        # Shared vocab head, outside the cell (teacher forcing projects the
        # whole (B, L, H) sequence at once; samplers apply it per step).
        self.logit = nn.Linear(hidden_size, vocab_size)

    @property
    def device(self) -> torch.device:
        return self.logit.weight.device

    def encode(self, feats: Sequence[torch.Tensor]):
        """-> (memory (B,T,H), proj_mem (B,T,A), pooled (B,H))."""
        memory, pooled = self.encoder(feats)
        return memory, self.memory_proj(memory), pooled

    def init_carry(self, pooled: torch.Tensor) -> Carry:
        carry = []
        for layer in self.state_init:
            # contiguous: the kernels take dense (B, H) rows.
            c, h = (x.contiguous()
                    for x in torch.tanh(layer(pooled)).chunk(2, dim=-1))
            carry.append((c, h))
        return tuple(carry)

    def decode(self, carry: Carry, tokens: torch.Tensor,
               memory: torch.Tensor, proj_mem: torch.Tensor,
               pooled: torch.Tensor):
        """tokens (B, L) -> (carry, logits (B, L, V))."""
        hs = []
        for t in range(tokens.shape[1]):
            carry, h = self.cell(carry, tokens[:, t], memory, proj_mem,
                                 pooled)
            hs.append(h)
        return carry, self.logit(torch.stack(hs, dim=1))

    def forward(self, feats: Sequence[torch.Tensor], labels: torch.Tensor,
                seq_per_img: int = 1) -> torch.Tensor:
        """Teacher-forced logits (B*seq_per_img, L, V)."""
        memory, proj_mem, pooled = self.encode(feats)
        memory = repeat_for_captions(memory, seq_per_img)
        proj_mem = repeat_for_captions(proj_mem, seq_per_img)
        pooled = repeat_for_captions(pooled, seq_per_img)
        carry = self.init_carry(pooled)
        _, logits = self.decode(carry, shift_right(labels), memory,
                                proj_mem, pooled)
        return logits
