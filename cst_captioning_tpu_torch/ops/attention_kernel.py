"""Fused additive attention — K1, counterpart of the reference's
``ops/pallas_attention.py``.

``fused_additive_attention`` is a ``torch.autograd.Function``, the
counterpart of the reference's ``jax.custom_vjp``.  Its forward launches
the CUDA kernel ``csrc/attention.cu`` for CUDA tensors and takes
``additive_attention_plain`` for CPU tensors; nothing else.  Its backward
is ``additive_attention_backward`` on both devices: plain PyTorch, the
reference's ``_bwd`` (plain XLA there too, not a TPU kernel), which
recomputes ``tanh`` and the softmax weights in float32 from the saved
inputs.  Autograd therefore keeps only references to the inputs, which
the teacher-forced steps share (``proj_mem``, ``memory``), not per-step
(B, T, A) residuals: the recompute trade of the reference's remat cell.

``attention_geometry`` is the kernel's launch geometry (one cluster of
``ATTN_CLUSTER`` blocks per row, each with its share of time steps and of
H) in plain Python: the wrapper computes it before it touches CUDA and
raises ``ValueError`` for a shape the kernel does not take.

Storage: float32, or bfloat16 as the reference kernel runs under
``--use_bfloat16`` (``pallas_attention.py``): q, proj_mem and memory are
read in bfloat16, ``score_v`` stays float32, every sum runs in float32,
and ctx and w are written in bfloat16.  A 16-byte copy then carries 8
values instead of 4, which the geometry follows (``elem_bytes``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import _cuda

#: Blocks per batch row (a thread-block cluster), as ``kAttnCluster``.
ATTN_CLUSTER = 4
#: Shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232448
#: The C launcher of each storage dtype (``csrc/attention.cu``).
LAUNCHERS = {torch.float32: "additive_attention_forward",
             torch.bfloat16: "additive_attention_forward_bf16"}
#: Storage dtype -> the key of ``launches_by_dtype``.
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


@functools.lru_cache(maxsize=None)
def attention_geometry(b: int, t: int, a: int, h: int,
                       elem_bytes: int = 4) -> dict:
    """Launch geometry of ``attention_kernel`` (``csrc/attention.cuh``)
    for B rows of a (T, A) / (T, H) memory stored in ``elem_bytes``-byte
    values (4: float32, 2: bfloat16): ``cluster`` blocks per row,
    ``blocks`` in all, ``time_steps`` (most a block scores), ``h_slice``
    (context columns a block writes) and ``smem_bytes`` a block (q, its
    proj_mem rows and its memory columns in the storage type; v and the
    scores in float32).
    Raises ``ValueError`` for a shape the kernel does not take: with
    ``per_copy = 16 // elem_bytes`` values in a 16-byte copy, the copies
    need A % per_copy == 0 and H % (per_copy * cluster) == 0."""
    if elem_bytes not in (2, 4):
        raise ValueError(f"attention kernel: {elem_bytes}-byte storage; "
                         "takes float32 (4) or bfloat16 (2)")
    per_copy = 16 // elem_bytes
    if min(b, t, a, h) < 1 or b > 65535:
        raise ValueError(f"attention kernel: takes 1 <= B <= 65535 (one "
                         f"grid row each) and non-empty T, A, H; got B={b} "
                         f"T={t} A={a} H={h}")
    if a % per_copy or h % (per_copy * ATTN_CLUSTER):
        raise ValueError(
            f"attention kernel: needs A % {per_copy} == 0 and H % "
            f"{per_copy * ATTN_CLUSTER} == 0 (16-byte copies of each "
            f"block's share); got A={a}, H={h}")
    time_steps = -(-t // ATTN_CLUSTER)
    h_slice = h // ATTN_CLUSTER
    smem = elem_bytes * (a + time_steps * a + t * h_slice) + 4 * (a + t)
    if smem > SMEM_LIMIT:
        raise ValueError(f"attention kernel: T={t}, A={a}, H={h} needs "
                         f"{smem} bytes of shared memory a block, over the "
                         f"{SMEM_LIMIT} an H100 block has")
    return {"cluster": ATTN_CLUSTER, "blocks": ATTN_CLUSTER * b,
            "time_steps": time_steps, "h_slice": h_slice,
            "smem_bytes": smem}


def additive_attention_plain(q: torch.Tensor, proj_mem: torch.Tensor,
                             memory: torch.Tensor, score_v: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, float32 math throughout:
    ``w = softmax_t(sum_a tanh(proj_mem + q) * v)``, ``ctx = sum_t w *
    memory``.  q (B, A), proj_mem (B, T, A), memory (B, T, H), score_v
    (A,) -> (ctx (B, H), w (B, T)) in memory's dtype (the storage dtype).
    Operands are cast to float32 BEFORE the add, as the reference does."""
    tanh = torch.tanh(proj_mem.float() + q.float()[:, None, :])
    scores = (tanh * score_v.float()).sum(-1)
    w = torch.softmax(scores, dim=-1)
    ctx = (w[:, :, None] * memory.float()).sum(1)
    return ctx.to(memory.dtype), w.to(memory.dtype)


def additive_attention_backward(q, proj_mem, memory, score_v, g_ctx, g_w
                                ) -> Tuple[torch.Tensor, ...]:
    """Gradients of ``(ctx, w)`` with respect to ``(q, proj_mem, memory,
    score_v)`` from the upstream gradients ``g_ctx`` (B, H) and ``g_w``
    (B, T): the reference's ``_bwd`` (``ops/pallas_attention.py``).  It
    recomputes ``tanh`` and ``w`` in float32 from the inputs, so the result
    depends on the inputs and upstream gradients only, not on which forward
    ran."""
    g_ctx = g_ctx.float()
    g_w = g_w.float()
    v = score_v.float()
    memory_f = memory.float()
    tanh = torch.tanh(proj_mem.float() + q.float()[:, None, :])
    w = torch.softmax(torch.einsum("bta,a->bt", tanh, v), dim=-1)
    g_w_total = g_w + torch.einsum("bh,bth->bt", g_ctx, memory_f)
    ds = w * (g_w_total - (w * g_w_total).sum(-1, keepdim=True))
    dt = ds[:, :, None] * v * (1.0 - tanh * tanh)
    g_q = dt.sum(1)
    g_v = torch.einsum("bta,bt->a", tanh, ds)
    g_mem = torch.einsum("bt,bh->bth", w, g_ctx)
    return (g_q.to(q.dtype), dt.to(proj_mem.dtype), g_mem.to(memory.dtype),
            g_v.to(score_v.dtype))


def _attention_forward(q, proj_mem, memory, score_v):
    """The forward of ``fused_additive_attention``: one kernel launch on
    CUDA tensors, the plain version on CPU tensors."""
    what = "fused_additive_attention"
    store = _cuda.storage_dtype(what, memory)
    if not _cuda.on_cuda(what, {"q": q, "proj_mem": proj_mem,
                                "memory": memory, "score_v": score_v},
                         {"q": store, "proj_mem": store, "memory": store,
                          "score_v": torch.float32}):
        return additive_attention_plain(q, proj_mem, memory, score_v)
    b, t, a = proj_mem.shape
    h = memory.shape[-1]
    if q.shape != (b, a) or memory.shape[:2] != (b, t) \
            or score_v.shape != (a,):
        raise ValueError(
            f"{what}: shapes q {tuple(q.shape)}, proj_mem "
            f"{tuple(proj_mem.shape)}, memory {tuple(memory.shape)}, "
            f"score_v {tuple(score_v.shape)} do not agree")
    geo = attention_geometry(b, t, a, h, memory.element_size())
    _cuda.check_aligned(what, {"q": q, "proj_mem": proj_mem,
                               "memory": memory, "score_v": score_v})
    ctx = torch.empty((b, h), dtype=store, device=q.device)
    w = torch.empty((b, t), dtype=store, device=q.device)
    fn = _cuda.load("attention", LAUNCHERS[store])
    rc = fn(q.data_ptr(), proj_mem.data_ptr(), memory.data_ptr(),
            score_v.data_ptr(), ctx.data_ptr(), w.data_ptr(), b, t, a, h,
            geo["smem_bytes"],
            torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(rc, what)
    fused_additive_attention.launches += 1
    fused_additive_attention.launches_by_dtype[DTYPE_NAMES[store]] += 1
    return ctx, w


class _FusedAttention(torch.autograd.Function):
    """K1 forward (kernel or plain version), plain backward."""

    @staticmethod
    def forward(ctx, q, proj_mem, memory, score_v):
        ctx.save_for_backward(q, proj_mem, memory, score_v)
        return _attention_forward(q, proj_mem, memory, score_v)

    @staticmethod
    def backward(ctx, g_ctx, g_w):
        return additive_attention_backward(*ctx.saved_tensors, g_ctx, g_w)


def fused_additive_attention(q: torch.Tensor, proj_mem: torch.Tensor,
                             memory: torch.Tensor, score_v: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (ctx (B, H), w (B, T)) in the storage dtype (memory's: float32,
    or bfloat16 with a float32 ``score_v``); one launch of the K1 kernel
    on CUDA tensors (counted in ``fused_additive_attention.launches``),
    the plain version on CPU tensors.  Differentiable on both devices
    through ``additive_attention_backward``."""
    return _FusedAttention.apply(q, proj_mem, memory, score_v)


#: Kernel launches since the last reset (a run shows its main path went
#: through the kernel by this count moving), in all and per storage
#: dtype.  The backward launches none.
fused_additive_attention.launches = 0
fused_additive_attention.launches_by_dtype = dict.fromkeys(
    DTYPE_NAMES.values(), 0)
