"""Sequence parallelism: attention over a time-sharded encoder memory
(counterpart of the reference's ``parallel/sequence.py``).

Each rank of a model axis holds one time block of the memory ``(B, T,
H)``; the cross-attention combines the blocks with the streaming softmax
and no rank ever holds the full T.  The reference writes these as
``shard_map`` bodies with ``pmax``/``psum``/``ppermute``; here they are
plain functions of a rank's local blocks over an ``Axis``
(``parallel/mesh.py``):

- ``_combine``: each rank's local max ``m_i``, exp-sum ``s_i`` and
  context numerator ``n_i``; ``m = max_i m_i`` (all-reduce MAX), ``s =
  sum_i s_i exp(m_i - m)``, ``ctx = sum_i n_i exp(m_i - m) / s``
  (all-reduce SUM), scores in float32 whatever the storage dtype, masked
  scores at the finite ``_NEG_INF`` so a rank (or a row) whose block is
  all padding stays NaN-free.  The SUMs are autograd-aware (``AllSum``:
  the backward of a sum over ranks is the sum of the ranks' upstream
  gradients), and ``m`` carries no gradient (the softmax does not depend
  on it), so the combine is differentiable: the CP step of
  ``parallel/cp.py`` trains through it;
- ``ring_cross_attention``: the same merge on a ring schedule, the K/V
  blocks hopping to the next rank of the axis with
  ``dist.batch_isend_irecv`` while each rank folds one block per hop.
  It agrees with the combine to float tolerance, not bit for bit: the
  merges run in another order (the reference's test asks 1e-6 of the
  two);
- ``sp_cross_attention``: the global-tensor form (the reference's
  ``sp_cross_attention_jit``): global q, k, v in, the rank's rows and
  time block taken here (``time_sharding``), the global context out on
  every rank.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import Axis, Mesh, host_local_slice

#: A finite "masked" score: keeps the max and exp NaN-free when a whole
#: block, or a whole row, is padding.
_NEG_INF = -1e30


class AllSum(torch.autograd.Function):
    """A sum over the ranks of ``axis`` whose backward sums the upstream
    gradients over the same ranks (each rank's replica of the downstream
    computation contributes its own)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_sum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_sum(g), None


def all_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` summed over ``axis``, differentiable (``AllSum``)."""
    if axis.group is None:
        return x
    return AllSum.apply(x, axis)


def time_sharding(mesh: Mesh, batch: int, time: int) -> Tuple[slice, slice]:
    """-> (this rank's rows of a global batch of ``batch`` rows, its time
    range of ``time`` steps): rows by its data index, time by its model
    index (both must divide)."""
    return (host_local_slice(batch, mesh.data.index, mesh.data.size),
            host_local_slice(time, mesh.model.index, mesh.model.size))


def _combine(scores: torch.Tensor, values: torch.Tensor, axis: Axis,
             contract: str):
    """Streaming-softmax combine of the ranks' blocks: ``scores`` are the
    local float32 logits with the local time last (masked already);
    ``contract`` folds the exp'd scores with ``values`` into the local
    numerator.  -> (ctx, s, m)."""
    m_local = scores.detach().amax(dim=-1)
    m = axis.all_max(m_local)
    e = torch.exp(scores - m[..., None])
    s = all_sum(e.sum(dim=-1), axis)
    n = torch.einsum(contract, e, values)
    ctx = all_sum(n, axis) / s.clamp(min=1e-30)[..., None]
    return ctx, s, m


def sp_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     axis: Axis, mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Scaled dot-product cross-attention over a time-sharded memory: q
    (B, Lq, D) full, k (B, Tl, D) and v (B, Tl, Dv) this rank's block,
    ``mask`` (B, Tl) True = attend -> the (B, Lq, Dv) context, the same
    on every rank of ``axis``.  Multi-head callers fold the heads into
    the batch (``sp_multihead_cross_attention``)."""
    scores = torch.einsum("bqd,btd->bqt", q.float(), k.float()) / math.sqrt(
        q.shape[-1])
    if mask is not None:
        scores = torch.where(mask[:, None, :], scores,
                             torch.full_like(scores, _NEG_INF))
    ctx, _, _ = _combine(scores, v.float(), axis, "bqt,btd->bqd")
    return ctx.to(v.dtype)


def sp_additive_attention(q_proj: torch.Tensor, memory: torch.Tensor,
                          projected_memory: torch.Tensor,
                          score_v: torch.Tensor, axis: Axis,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Additive (Bahdanau) attention over a time-sharded memory, the SP
    form of the attention-LSTM's score -> softmax -> context (K1's
    function): q_proj (B, A), this rank's memory (B, Tl, H) and
    projected memory (B, Tl, A), score vector (A,), ``mask`` (B, Tl) ->
    the (B, H) context."""
    scores = torch.einsum(
        "bta,a->bt",
        torch.tanh(projected_memory.float() + q_proj.float()[:, None, :]),
        score_v.float())
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    ctx, _, _ = _combine(scores, memory.float(), axis, "bt,bth->bh")
    return ctx.to(memory.dtype)


def _hop(blocks, axis: Axis):
    """Send ``blocks`` (one float32 buffer) to the next rank of the axis
    and receive the previous rank's."""
    send = torch.cat([b.reshape(-1) for b in blocks])
    to = axis.ranks[(axis.index + 1) % axis.size]
    frm = axis.ranks[(axis.index - 1) % axis.size]
    staged = axis.backend == "gloo" and send.is_cuda
    if staged:
        # gloo sends host memory only: the hop copies the CUDA block to
        # the host, and the received block back to the card.
        send = send.cpu()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, to, axis.group),
            dist.P2POp(dist.irecv, recv, frm, axis.group)]):
        req.wait()
    if staged:
        recv = recv.to(blocks[0].device)
    out, at = [], 0
    for b in blocks:
        out.append(recv[at:at + b.numel()].view_as(b))
        at += b.numel()
    return out


@torch.no_grad()
def ring_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis: Axis, mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The ring schedule of ``sp_dot_attention`` (forward only): the K/V
    blocks (and the mask) hop around the axis, each rank folding one
    block per hop into its running (max, sum, numerator); no collective
    touches the full T.  Every rank's block must have the same shape."""
    qf = q.float()
    scale = 1.0 / math.sqrt(q.shape[-1])

    def block_stats(kb, vb, mb):
        s = torch.einsum("bqd,btd->bqt", qf, kb) * scale
        s = torch.where(mb[:, None, :] > 0.5, s, torch.full_like(s, _NEG_INF))
        m = s.amax(dim=-1)
        e = torch.exp(s - m[..., None])
        return m, e.sum(dim=-1), torch.einsum("bqt,btd->bqd", e, vb)

    def merge(acc, blk):
        m0, s0, n0 = acc
        m1, s1, n1 = blk
        m = torch.maximum(m0, m1)
        a0, a1 = torch.exp(m0 - m), torch.exp(m1 - m)
        return m, s0 * a0 + s1 * a1, n0 * a0[..., None] + n1 * a1[..., None]

    mb = (torch.ones(k.shape[:2], device=k.device) if mask is None
          else mask.float())
    kb, vb = k.float(), v.float()
    acc = block_stats(kb, vb, mb)
    for _ in range(axis.size - 1):
        kb, vb, mb = _hop((kb, vb, mb), axis)
        acc = merge(acc, block_stats(kb, vb, mb))
    _, s, n = acc
    return (n / s.clamp(min=1e-30)[..., None]).to(v.dtype)


def sp_multihead_cross_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, axis: Axis,
                                 mask: Optional[torch.Tensor] = None,
                                 ring: bool = False) -> torch.Tensor:
    """Multi-head wrapper: q (B, Lq, nH, Dh), this rank's k and v (B, Tl,
    nH, Dh) -> (B, Lq, nH, Dh); heads folded into the batch."""
    b, lq, nh, dh = q.shape
    tl = k.shape[1]

    def fold(x, length):
        return x.permute(0, 2, 1, 3).reshape(b * nh, length, dh)

    mf = None if mask is None else mask.repeat_interleave(nh, dim=0)
    fn = ring_cross_attention if ring else sp_dot_attention
    ctx = fn(fold(q, lq), fold(k, tl), fold(v, tl), axis, mask=mf)
    return ctx.reshape(b, nh, lq, dh).permute(0, 2, 1, 3)


def sp_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mesh: Mesh, mask: Optional[torch.Tensor] = None,
                       ring: bool = False) -> torch.Tensor:
    """The global-tensor form: global q (B, Lq, D), k, v (B, T, D) and
    ``mask`` (B, T) on every rank; this rank takes its rows (data axis)
    and its time block (model axis), attends with the combine (or the
    ring), and the rows are gathered over the data axis: the global (B,
    Lq, Dv) context on every rank."""
    rows, times = time_sharding(mesh, q.shape[0], k.shape[1])
    if mask is None:
        mask = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    fn = ring_cross_attention if ring else sp_dot_attention
    ctx = fn(q[rows], k[rows, times], v[rows, times], mesh.model,
             mask=mask[rows, times])
    return torch.cat(mesh.data.all_gather(ctx.contiguous()), dim=0)
