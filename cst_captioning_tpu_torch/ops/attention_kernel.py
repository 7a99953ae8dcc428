"""Fused additive attention — K1, counterpart of the reference's
``ops/pallas_attention.py``.

``fused_additive_attention`` launches the CUDA kernel ``csrc/attention.cu``
for CUDA tensors and takes ``additive_attention_plain`` for CPU tensors;
nothing else.  Forward only: the backward (the reference's ``_bwd``)
comes with the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda


def additive_attention_plain(q: torch.Tensor, proj_mem: torch.Tensor,
                             memory: torch.Tensor, score_v: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, float32 throughout:
    ``w = softmax_t(sum_a tanh(proj_mem + q) * v)``, ``ctx = sum_t w *
    memory``.  q (B, A), proj_mem (B, T, A), memory (B, T, H), score_v
    (A,) -> (ctx (B, H), w (B, T)).  Operands are cast to float32 BEFORE
    the add, as the reference does."""
    tanh = torch.tanh(proj_mem.float() + q.float()[:, None, :])
    scores = (tanh * score_v.float()).sum(-1)
    w = torch.softmax(scores, dim=-1)
    ctx = (w[:, :, None] * memory.float()).sum(1)
    return ctx, w


def fused_additive_attention(q: torch.Tensor, proj_mem: torch.Tensor,
                             memory: torch.Tensor, score_v: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (ctx (B, H), w (B, T)); one launch of the K1 kernel on CUDA
    tensors (counted in ``fused_additive_attention.launches``), the plain
    version on CPU tensors."""
    what = "fused_additive_attention"
    if not _cuda.on_cuda(what, {"q": q, "proj_mem": proj_mem,
                                "memory": memory, "score_v": score_v}):
        return additive_attention_plain(q, proj_mem, memory, score_v)
    b, t, a = proj_mem.shape
    h = memory.shape[-1]
    if q.shape != (b, a) or memory.shape[:2] != (b, t) \
            or score_v.shape != (a,):
        raise ValueError(
            f"{what}: shapes q {tuple(q.shape)}, proj_mem "
            f"{tuple(proj_mem.shape)}, memory {tuple(memory.shape)}, "
            f"score_v {tuple(score_v.shape)} do not agree")
    ctx = torch.empty((b, h), dtype=torch.float32, device=q.device)
    w = torch.empty((b, t), dtype=torch.float32, device=q.device)
    fn = _cuda.load("attention")
    rc = fn(q.data_ptr(), proj_mem.data_ptr(), memory.data_ptr(),
            score_v.data_ptr(), ctx.data_ptr(), w.data_ptr(), b, t, a, h,
            torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(rc, what)
    fused_additive_attention.launches += 1
    return ctx, w


#: Kernel launches since the last reset (a run shows its main path went
#: through the kernel by this count moving).
fused_additive_attention.launches = 0
