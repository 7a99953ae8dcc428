"""The attention-LSTM decode cell — K2, counterpart of the reference's
``ops/pallas_decode_cell.py``.

``fused_decode_cell`` runs one whole decode step (attention -> context ->
gate product -> LSTM state update) through ``csrc/decode_cell.cu`` for
CUDA tensors, and through ``decode_cell_plain`` for CPU tensors.
``make_fused_decode_step`` binds it into the ``step(carry, token) ->
(carry, logits)`` contract every sampler drives.  As in the reference,
the embedding gather, the query projection ``W_q h`` and the vocab head
stay outside the kernel (plain ``torch`` ops).

Scope: the single-layer attention-LSTM.  Any other model asked to run
with ``decode_kernel="fused"`` raises — the port never falls back to the
reference cell behind the caller's back.

Gate weights are the reference's flax layout, ``(in, out)``: ``w`` is
``[W_i; W_h]`` of shape ``(E + 2H, 4H)`` (input-side rows for ``[x, ctx]``
first, recurrent rows for ``h`` after), gate columns ``i | f | g | o``;
``bias`` (4H,) is the h-side bias.  ``models/decoder_lstm.py`` stores its
weights in exactly this layout, so binding a step copies nothing.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from . import _cuda
from .attention_kernel import additive_attention_plain


def decode_cell_plain(x, c, h, q, proj_mem, memory, score_v, w, bias
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step in plain PyTorch, mirroring the reference kernel's
    op order: float32 attention, ``gh = h @ W_h + b``, ``gi = [x, ctx] @
    W_i``, gates ``gh + gi`` in i, f, g, o order, ``c' = f*c + i*g``,
    ``h' = o * tanh(c')``.  -> (c' (B, H), h' (B, H))."""
    ctx, _ = additive_attention_plain(q, proj_mem, memory, score_v)
    n_in = x.shape[-1] + ctx.shape[-1]
    inp = torch.cat([x, ctx.to(x.dtype)], dim=-1)
    gh = h @ w[n_in:] + bias
    gi = inp @ w[:n_in]
    i, f, g, o = (gh + gi).chunk(4, dim=-1)
    new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_c, new_h


def fused_decode_cell(x, c, h, q, proj_mem, memory, score_v, w, bias
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (c' (B, H), h' (B, H)).  x (B, E), c/h (B, H), q (B, A),
    proj_mem (B, T, A), memory (B, T, H), score_v (A,), w (E + 2H, 4H),
    bias (4H,).  On CUDA tensors: the two launches of the K2 kernel
    (attention; gate product with the state update), each counted in
    ``fused_decode_cell.launches``; on CPU tensors: the plain version."""
    what = "fused_decode_cell"
    args = {"x": x, "c": c, "h": h, "q": q, "proj_mem": proj_mem,
            "memory": memory, "score_v": score_v, "w": w, "bias": bias}
    if not _cuda.on_cuda(what, args):
        return decode_cell_plain(x, c, h, q, proj_mem, memory, score_v, w,
                                 bias)
    b, t, a = proj_mem.shape
    e = x.shape[-1]
    hid = h.shape[-1]
    want = {"x": (b, e), "c": (b, hid), "h": (b, hid), "q": (b, a),
            "memory": (b, t, hid), "score_v": (a,),
            "w": (e + 2 * hid, 4 * hid), "bias": (4 * hid,)}
    for key, shape in want.items():
        if tuple(args[key].shape) != shape:
            raise ValueError(f"{what}: {key} has shape "
                             f"{tuple(args[key].shape)}, expected {shape}")
    if hid % 4 or w.data_ptr() % 16:
        raise ValueError(f"{what}: the gate kernel reads 4 hidden units as "
                         "one 16-byte load; needs H % 4 == 0 and a 16-byte "
                         "aligned w")
    dev = x.device
    ctx = torch.empty((b, hid), dtype=torch.float32, device=dev)
    new_c = torch.empty((b, hid), dtype=torch.float32, device=dev)
    new_h = torch.empty((b, hid), dtype=torch.float32, device=dev)
    fn = _cuda.load("decode_cell")
    rc = fn(x.data_ptr(), c.data_ptr(), h.data_ptr(), q.data_ptr(),
            proj_mem.data_ptr(), memory.data_ptr(), score_v.data_ptr(),
            w.data_ptr(), bias.data_ptr(), ctx.data_ptr(), new_c.data_ptr(),
            new_h.data_ptr(), b, t, e, a, hid,
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(rc, what)
    fused_decode_cell.launches += 2     # attention; gates + update
    return new_c, new_h


#: Kernel launches since the last reset (two per decode step).
fused_decode_cell.launches = 0


def fused_decode_supported(model) -> Tuple[bool, str]:
    """(eligible, reason): the fused cell covers the single-layer
    attention-LSTM; every other configuration must be refused."""
    if getattr(model, "decoder_type", "lstm") != "lstm":
        return False, "decoder_type != lstm"
    if getattr(model, "num_layers", 1) != 1:
        return False, "num_layers != 1"
    if not getattr(model, "use_attention", True):
        return False, "use_attention=0 (pooled context has no attention chain)"
    return True, ""


def make_fused_decode_step(model, memory: torch.Tensor,
                           proj_mem: torch.Tensor) -> Callable:
    """``step(carry, token (N,)) -> (carry, logits (N, V))`` on the fused
    cell — the contract of ``ops.sampling.make_decode_step``.  Raises for
    a model the cell does not cover."""
    ok, reason = fused_decode_supported(model)
    if not ok:
        raise ValueError(f"decode_kernel='fused' does not cover this "
                         f"model: {reason}")
    cell = model.cell
    emb = cell.embed.weight
    wq = cell.attn.query_proj.weight
    score_v = cell.attn.score_v
    w = cell.lstm[0].w
    bias = cell.lstm[0].bias
    w_logit, b_logit = model.logit.weight, model.logit.bias

    def step(carry, token):
        (c, h), = carry
        x = F.embedding(token, emb)                       # (N, E)
        q = F.linear(h, wq)                               # (N, A)
        new_c, new_h = fused_decode_cell(x, c, h, q, proj_mem, memory,
                                         score_v, w, bias)
        return ((new_c, new_h),), F.linear(new_h, w_logit, b_logit)

    return step
