"""CaptionModel — encoder + attention-LSTM decoder (counterpart of the
reference's ``models/captioner.py``, LSTM decoder only).

Surfaces, as in the reference:
- ``encode(feats)`` -> (memory (B,T,H), proj_mem (B,T,A), pooled (B,H));
- ``init_carry(pooled)`` -> per-layer (c, h) from ``state_init_{l}``;
- ``decode(carry, tokens (B, L), ...)`` -> (carry, logits (B, L, V));
  L == 1 is the autoregressive step the samplers drive;
- ``forward(feats, labels, seq_per_img, train, generator)`` —
  teacher-forced logits.  ``train=True`` turns dropout on (``drop_prob``,
  default 0.5 as the reference's ``--drop_prob``) at the reference's
  sites: the encoder's ``pooled`` and ``memory`` and the cell's output
  ``h``, with masks from the caller's ``torch.Generator``.

``decode_kernel`` selects the decode-step cell the samplers, beam search
and the serving engine bind (``ops/sampling.make_decode_step``):
``"reference"`` is this module's cell, ``"fused"`` the K2 CUDA kernel
(counterpart of the reference's ``"pallas"``).  ``"fused"`` on a model the
kernel does not cover raises here, at construction.  ``"bf16"`` is the
low-precision decode variant (``ops/bf16_decode.py``): this model's cell
cloned at ``dtype=bfloat16`` over the same float32 parameters.

``dtype`` is the compute dtype (``precision.py``; the reference's
``dtype``, set by ``--use_bfloat16``): the encoder, ``memory_proj``,
``state_init``, the cell and the logit head compute in it over float32
parameters, so the carry, the encodings and the logits are in it.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.decode_cell_kernel import fused_decode_supported
from ..precision import compute_dtype, dense
from .decoder_lstm import Carry, DecoderCell
from .encoder import FeatureEncoder

DECODE_KERNELS = ("reference", "fused", "bf16")


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
                 decode_kernel: str = "reference",
                 drop_prob: float = 0.5, dtype: torch.dtype = torch.float32):
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
        self.drop_prob = drop_prob
        self.dtype = compute_dtype(dtype)
        if decode_kernel == "fused":
            ok, reason = fused_decode_supported(self)
            if not ok:
                raise ValueError(f"decode_kernel='fused' does not cover "
                                 f"this model: {reason}")
        self.encoder = FeatureEncoder(self.feat_dims, hidden_size,
                                      drop_prob=drop_prob, dtype=self.dtype)
        self.memory_proj = nn.Linear(hidden_size, attn_size, bias=False)
        self.cell = DecoderCell(vocab_size, embed_size, hidden_size,
                                num_layers=num_layers, attn_size=attn_size,
                                use_attention=use_attention,
                                use_kernel_attention=use_kernel_attention,
                                drop_prob=drop_prob, dtype=self.dtype)
        self.state_init = nn.ModuleList(
            nn.Linear(hidden_size, 2 * hidden_size)
            for _ in range(num_layers))
        # Shared vocab head, outside the cell (teacher forcing projects the
        # whole (B, L, H) sequence at once; samplers apply it per step).
        self.logit = nn.Linear(hidden_size, vocab_size)

    @property
    def device(self) -> torch.device:
        return self.logit.weight.device

    def clone(self, dtype: Optional[torch.dtype] = None,
              decode_kernel: Optional[str] = None) -> "CaptionModel":
        """This model at another compute dtype or decode kernel, over the
        SAME parameter tensors (flax's ``model.clone(dtype=...)`` applied
        to one parameter tree): every module is copied shallowly, its
        parameters shared, and ``dtype`` set on every module that has
        one."""
        dtype = self.dtype if dtype is None else compute_dtype(dtype)

        def retyped(module: nn.Module) -> nn.Module:
            out = copy.copy(module)
            out._modules = type(module._modules)(
                (k, None if m is None else retyped(m))
                for k, m in module._modules.items())
            if "dtype" in module.__dict__:
                out.dtype = dtype
            return out

        out = retyped(self)
        if decode_kernel is not None:
            if decode_kernel not in DECODE_KERNELS:
                raise ValueError(f"decode_kernel must be one of "
                                 f"{DECODE_KERNELS}, got {decode_kernel!r}")
            out.decode_kernel = decode_kernel
        return out

    def encode(self, feats: Sequence[torch.Tensor], train: bool = False,
               generator: Optional[torch.Generator] = None):
        """-> (memory (B,T,H), proj_mem (B,T,A), pooled (B,H))."""
        memory, pooled = self.encoder(feats, train=train,
                                      generator=generator)
        return (memory, dense(memory, self.memory_proj.weight, None,
                              self.dtype), pooled)

    def init_carry(self, pooled: torch.Tensor) -> Carry:
        carry = []
        for layer in self.state_init:
            # contiguous: the kernels take dense (B, H) rows.
            c, h = (x.contiguous()
                    for x in torch.tanh(dense(pooled, layer.weight,
                                              layer.bias, self.dtype)
                                        ).chunk(2, dim=-1))
            carry.append((c, h))
        return tuple(carry)

    def decode(self, carry: Carry, tokens: torch.Tensor,
               memory: torch.Tensor, proj_mem: torch.Tensor,
               pooled: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None):
        """tokens (B, L) -> (carry, logits (B, L, V))."""
        hs = []
        for t in range(tokens.shape[1]):
            carry, h = self.cell(carry, tokens[:, t], memory, proj_mem,
                                 pooled, train=train, generator=generator)
            hs.append(h)
        return carry, self.logits(torch.stack(hs, dim=1))

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """The vocab head in the compute dtype: (..., H) -> (..., V)."""
        return dense(h, self.logit.weight, self.logit.bias, self.dtype)

    def forward(self, feats: Sequence[torch.Tensor], labels: torch.Tensor,
                seq_per_img: int = 1, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced logits (B*seq_per_img, L, V)."""
        memory, proj_mem, pooled = self.encode(feats, train=train,
                                               generator=generator)
        memory = repeat_for_captions(memory, seq_per_img)
        proj_mem = repeat_for_captions(proj_mem, seq_per_img)
        pooled = repeat_for_captions(pooled, seq_per_img)
        carry = self.init_carry(pooled)
        _, logits = self.decode(carry, shift_right(labels), memory,
                                proj_mem, pooled, train=train,
                                generator=generator)
        return logits
