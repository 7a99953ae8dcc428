"""CaptionModel — encoder + caption decoder (counterpart of the
reference's ``models/captioner.py``).

Variants, as the reference's: ``decoder_type`` ``"lstm"`` (the
attention-LSTM, ``num_layers`` deep; ``use_attention=False`` is the
pooled model, whose context is the fused feature) or ``"transformer"``
(``models/decoder_transformer.py``: ``num_tx_layers`` blocks of
``num_heads`` heads, positions up to ``tx_max_len``); ``fusion_type``
``"temporal"`` or ``"modality"`` (the "manet" memory of one token per
modality, ``models/encoder.py``).

Surfaces, as in the reference:
- ``encode(feats)`` -> (memory (B,T,H), proj_mem (B,T,A), pooled (B,H));
  the transformer's ``proj_mem`` is ``memory`` (its cross-attention
  projects inside);
- ``init_carry(pooled, max_len)`` -> per-layer (c, h) from
  ``state_init_{l}``; the transformer's is the (token buffer (B,
  max_len), position 0) pair and needs ``max_len`` > 0;
- ``decode(carry, tokens (B, L), ...)`` -> (carry, logits (B, L, V));
  L == 1 is the autoregressive step the samplers drive;
- ``forward(feats, labels, seq_per_img, train, generator)`` —
  teacher-forced logits.  ``train=True`` turns dropout on (``drop_prob``,
  default 0.5 as the reference's ``--drop_prob``) at the reference's
  sites: the encoder's ``pooled`` and ``memory``, the LSTM cell's output
  ``h`` and the transformer's attention weights and MLP outputs, with
  masks from the caller's ``torch.Generator``.

``remat_cell`` (the reference's ``--remat_cell``, ``nn.remat`` over the
cell) recomputes each LSTM step in the backward instead of keeping its
activations (``RecomputedStep``, a plain autograd Function:
``torch.utils.checkpoint`` loads torch's compiler stack on its first
call, seconds of start-up for every training process).  The step's
dropout mask is drawn before the step and passed in, so the recompute
applies the same mask: the gradients equal those without remat bit for
bit.

``decode_kernel`` selects the decode-step cell the samplers, beam search
and the serving engine bind (``ops/sampling.make_decode_step``):
``"reference"`` is this module's cell, ``"fused"`` the K2 CUDA kernel
(counterpart of the reference's ``"pallas"``).  ``"fused"`` on a model the
kernel does not cover raises here, at construction (or ``clone``).
``"bf16"`` is the low-precision decode variant (``ops/bf16_decode.py``):
this model's cell cloned at ``dtype=bfloat16`` over the same float32
parameters.

``shard_time(time_shard)`` makes the model context-parallel
(``parallel/cp.py``, the reference's ``encode_constraint=
time_shard_memory(mesh)``): the encoder's memory is this rank's time
block and the transformer's cross-attention combines the blocks over
the model axis.

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
from .decoder_transformer import TransformerDecoder
from .encoder import FeatureEncoder, dropout_keep

DECODE_KERNELS = ("reference", "fused", "bf16")
DECODER_TYPES = ("lstm", "transformer")


def shift_right(labels: torch.Tensor) -> torch.Tensor:
    """Teacher-forcing inputs: BOS (=0) then the target prefix."""
    return torch.cat([torch.zeros_like(labels[:, :1]), labels[:, :-1]],
                     dim=1)


def repeat_for_captions(x: torch.Tensor, seq_per_img: int) -> torch.Tensor:
    """(B, ...) -> (B*S, ...): align per-video encodings with caption rows."""
    return x if seq_per_img == 1 else x.repeat_interleave(seq_per_img, 0)


class RecomputedStep(torch.autograd.Function):
    """One LSTM step that keeps no activations: the forward runs ``cell``
    without a graph; the backward runs it again with one and returns the
    gradients of the step's inputs and of the cell's parameters, which
    are inputs here so the outer graph reaches them.  The cell draws
    nothing at random (the dropout mask ``keep`` is an input), so the
    recompute is the forward's function, bit for bit."""

    @staticmethod
    def forward(ctx, cell, n_layers, keep, token, memory, proj_mem, pooled,
                *rest):
        ctx.set_materialize_grads(False)
        ctx.cell, ctx.n_layers = cell, n_layers
        ctx.save_for_backward(keep, token, memory, proj_mem, pooled, *rest)
        carry = tuple(zip(rest[:2 * n_layers:2], rest[1:2 * n_layers:2]))
        carry, h = cell(carry, token, memory, proj_mem, pooled, keep)
        return (*(x for ch in carry for x in ch), h)

    @staticmethod
    def backward(ctx, *grads):
        keep, token, *saved = ctx.saved_tensors
        n = 2 * ctx.n_layers
        inputs = [x.detach().requires_grad_(x.requires_grad)
                  for x in saved[:3 + n]]
        params = saved[3 + n:]
        memory, proj_mem, pooled, *flat = inputs
        with torch.enable_grad():
            carry, h = ctx.cell(tuple(zip(flat[::2], flat[1::2])), token,
                                memory, proj_mem, pooled, keep)
            outs = [x for ch in carry for x in ch] + [h]
            # sum(o * g) has the gradient g at each output o, exactly;
            # explicit grad_outputs would load torch's symbolic-shape
            # stack on first use.
            surrogate = sum((o * g).sum() for o, g in zip(outs, grads)
                            if g is not None and o.requires_grad)
        wrt = [x for x in (*inputs, *params) if x.requires_grad]
        got = iter(torch.autograd.grad(surrogate, wrt, allow_unused=True))
        return (None, None, None, None,
                *(next(got) if x.requires_grad else None
                  for x in (*inputs, *params)))


class CaptionModel(nn.Module):
    def __init__(self, vocab_size: int, feat_dims: Sequence[int],
                 embed_size: int = 512, hidden_size: int = 512,
                 num_layers: int = 1, attn_size: int = 512,
                 use_attention: bool = True,
                 use_kernel_attention: bool = False,
                 decode_kernel: str = "reference",
                 drop_prob: float = 0.5, dtype: torch.dtype = torch.float32,
                 decoder_type: str = "lstm", num_heads: int = 8,
                 num_tx_layers: int = 2, tx_max_len: int = 64,
                 fusion_type: str = "temporal", remat_cell: bool = False):
        super().__init__()
        if decode_kernel not in DECODE_KERNELS:
            raise ValueError(f"decode_kernel must be one of {DECODE_KERNELS}, "
                             f"got {decode_kernel!r}")
        if decoder_type not in DECODER_TYPES:
            raise ValueError(f"unknown decoder_type {decoder_type!r}")
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
        self.decoder_type = decoder_type
        self.fusion_type = fusion_type
        self.remat_cell = bool(remat_cell)
        self.time_shard = None
        self._check_decode_kernel()
        self.encoder = FeatureEncoder(self.feat_dims, hidden_size,
                                      drop_prob=drop_prob, dtype=self.dtype,
                                      fusion=fusion_type)
        if decoder_type == "transformer":
            self.tx = TransformerDecoder(
                vocab_size, hidden_size, num_layers=num_tx_layers,
                num_heads=num_heads, drop_prob=drop_prob,
                max_len=tx_max_len, dtype=self.dtype)
            return
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
        return self.encoder.fuse.weight.device

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
            out._check_decode_kernel()
        return out

    def shard_time(self, time_shard) -> "CaptionModel":
        """Make this model context-parallel over ``time_shard``
        (``parallel.cp.TimeShard``): the transformer over the temporal
        memory only, as the reference tests it."""
        if self.decoder_type != "transformer" or self.fusion_type != \
                "temporal":
            raise ValueError("context parallelism covers the transformer "
                             "decoder over the temporal memory")
        if tuple(time_shard.feat_times) and len(time_shard.feat_times) != \
                len(self.feat_dims):
            raise ValueError(f"{len(time_shard.feat_times)} modalities "
                             f"sharded, the model has {len(self.feat_dims)}")
        self.time_shard = time_shard
        self.encoder.time_shard = time_shard
        for block in self.tx.blocks:
            block.cross_attn.time_axis = time_shard.axis
        return self

    def _check_decode_kernel(self) -> None:
        if self.decode_kernel == "fused":
            ok, reason = fused_decode_supported(self)
            if not ok:
                raise ValueError(f"decode_kernel='fused' does not cover "
                                 f"this model: {reason}")

    def encode(self, feats: Sequence[torch.Tensor], train: bool = False,
               generator: Optional[torch.Generator] = None):
        """-> (memory (B,T,H), proj_mem (B,T,A), pooled (B,H))."""
        memory, pooled = self.encoder(feats, train=train,
                                      generator=generator)
        if self.decoder_type == "transformer":
            return memory, memory, pooled
        return (memory, dense(memory, self.memory_proj.weight, None,
                              self.dtype), pooled)

    def init_carry(self, pooled: torch.Tensor, max_len: int = 0):
        """The decoder's start state: per-layer (c, h) from the fused
        feature, or the transformer's (buffer, position) of ``max_len``
        (> 0) slots."""
        if self.decoder_type == "transformer":
            if max_len <= 0:
                raise ValueError("transformer carry needs max_len > 0")
            return (torch.zeros(pooled.shape[0], max_len, dtype=torch.long,
                                device=pooled.device), 0)
        carry = []
        for layer in self.state_init:
            # contiguous: the kernels take dense (B, H) rows.
            c, h = (x.contiguous()
                    for x in torch.tanh(dense(pooled, layer.weight,
                                              layer.bias, self.dtype)
                                        ).chunk(2, dim=-1))
            carry.append((c, h))
        return tuple(carry)

    def decode(self, carry, tokens: torch.Tensor,
               memory: torch.Tensor, proj_mem: torch.Tensor,
               pooled: torch.Tensor, train: bool = False,
               generator: Optional[torch.Generator] = None):
        """tokens (B, L) -> (carry, logits (B, L, V))."""
        if self.decoder_type == "transformer":
            return self.tx.decode(carry, tokens, memory, pooled, train=train,
                                  generator=generator)
        drop = train and self.drop_prob > 0
        remat = self.remat_cell and torch.is_grad_enabled()
        hs = []
        for t in range(tokens.shape[1]):
            keep = (dropout_keep((tokens.shape[0], self.hidden_size),
                                 self.drop_prob, generator, tokens.device)
                    if drop else None)
            if remat:
                *flat, h = RecomputedStep.apply(
                    self.cell, len(carry), keep, tokens[:, t], memory,
                    proj_mem, pooled, *(x for ch in carry for x in ch),
                    *self.cell.parameters())
                carry = tuple(zip(flat[::2], flat[1::2]))
            else:
                carry, h = self.cell(carry, tokens[:, t], memory, proj_mem,
                                     pooled, keep)
            hs.append(h)
        return carry, self.logits(torch.stack(hs, dim=1))

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """The LSTM's vocab head in the compute dtype: (..., H) ->
        (..., V)."""
        return dense(h, self.logit.weight, self.logit.bias, self.dtype)

    def forward(self, feats: Sequence[torch.Tensor], labels: torch.Tensor,
                seq_per_img: int = 1, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced logits (B*seq_per_img, L, V)."""
        memory, proj_mem, pooled = self.encode(feats, train=train,
                                               generator=generator)
        memory = repeat_for_captions(memory, seq_per_img)
        pooled = repeat_for_captions(pooled, seq_per_img)
        inputs = shift_right(labels)
        if self.decoder_type == "transformer":
            return self.tx(inputs, memory, pooled, train=train,
                           generator=generator)
        proj_mem = repeat_for_captions(proj_mem, seq_per_img)
        carry = self.init_carry(pooled)
        _, logits = self.decode(carry, inputs, memory, proj_mem, pooled,
                                train=train, generator=generator)
        return logits
