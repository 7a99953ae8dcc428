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
weights in exactly this layout, so binding a step copies nothing: the
gate kernel reads ``w`` as it lies.

``gate_geometry`` is the gate kernel's launch geometry (column tiles of
``GATE_UNITS`` hidden units, each a cluster of ``GATE_CLUSTER`` blocks
that split K, batch rows in groups of ``GATE_ROWS``) in plain Python: the
wrapper computes it before it touches CUDA and raises ``ValueError`` for
a shape the kernel does not take.

Storage: float32, or bfloat16 as the reference kernel runs under
``--use_bfloat16`` (``pallas_decode_cell.py``): x, c, h, q, the
encodings, ``w`` and ``bias`` in bfloat16, ``score_v`` float32.  The
attention runs in float32 and its context is rounded to bfloat16; the
gates round where the reference's ops round: the h-side and input-side
products (each summed in float32) to bfloat16, ``+ b``, ``gh + gi``, each
activation, ``f*c``, ``i*g``, ``c'``, ``tanh(c')`` and ``h'``.  A 16-byte
copy carries 8 bfloat16 values, so each K slice must be a multiple of 8
rows (``gate_geometry``'s ``elem_bytes``).  ``make_fused_decode_step``
prepares the weights in the model's compute dtype once per binding.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from ..precision import dense, embed, sigmoid
from . import _cuda
from .attention_kernel import (DTYPE_NAMES, SMEM_LIMIT,
                               additive_attention_plain, attention_geometry)

#: The gate kernel's constants (``csrc/decode_cell.cu``): blocks a column
#: tile (a thread-block cluster; one K slice each), hidden units a tile,
#: rows of K a warp takes at a time, warps a block, batch rows a group,
#: batch rows a pair exchange of block sums.
GATE_CLUSTER = 2
GATE_UNITS = 8
GATE_SUB = 4
GATE_WARPS = 8
GATE_ROWS = 8
GATE_CHUNK_ROWS = 64
#: The C launcher of each storage dtype (``csrc/decode_cell.cu``).
LAUNCHERS = {torch.float32: "decode_cell_forward",
             torch.bfloat16: "decode_cell_forward_bf16"}


@functools.lru_cache(maxsize=None)
def gate_geometry(b: int, e: int, h: int, elem_bytes: int = 4) -> dict:
    """Launch geometry of ``gate_kernel`` for B rows, input width E and
    hidden width H, stored in ``elem_bytes``-byte values (4: float32, 2:
    bfloat16): ``cluster`` (blocks a tile, one K slice each),
    ``column_tiles``, ``blocks``, ``k_rows`` (the K rows a block holds:
    its share of each of the x, h and ctx segments), ``row_groups`` and
    ``smem_bytes`` a block (the warps' partial sums, the weight slice, two
    row groups' inputs, the block sums its peer sends it; in bfloat16 the
    sums of the h side and of the input side are kept apart, since each
    rounds on its own).  Raises ``ValueError`` for a shape the kernel
    does not take: each block's share of a segment must be whole 16-byte
    copies (4 float32 or 8 bfloat16 values) and whole warp steps of
    ``GATE_SUB`` rows, so E and H must be multiples of 8 in float32 and
    of 16 in bfloat16, and the slice must fit in a block's shared
    memory."""
    if elem_bytes not in (2, 4):
        raise ValueError(f"gate kernel: {elem_bytes}-byte storage; takes "
                         "float32 (4) or bfloat16 (2)")
    if min(b, e, h) < 1:
        raise ValueError(f"gate kernel: empty shape B={b} E={e} H={h}")
    step = GATE_CLUSTER * max(GATE_SUB, 16 // elem_bytes)
    if e % step or h % step:
        raise ValueError(f"gate kernel: E and H must be multiples of "
                         f"{step}; got E={e}, H={h}")
    k_rows = (e + 2 * h) // GATE_CLUSTER
    cols = 4 * GATE_UNITS
    parts = 1 if elem_bytes == 4 else 2
    # Partial sums (float32, per part), weights and two input buffers
    # (storage type), and the peer's sums of this rank's units (float32,
    # per part: GATE_CLUSTER x GATE_CHUNK_ROWS x cols / cluster).
    smem = (4 * parts * (GATE_WARPS * GATE_ROWS + GATE_CHUNK_ROWS) * cols
            + elem_bytes * (k_rows * cols + 2 * GATE_ROWS * k_rows))
    if smem > SMEM_LIMIT:
        raise ValueError(f"gate kernel: E={e}, H={h} puts {k_rows} rows of "
                         f"K in a block, {smem} bytes of shared memory, "
                         f"over the {SMEM_LIMIT} an H100 block has")
    tiles = h // GATE_UNITS
    return {"cluster": GATE_CLUSTER, "column_tiles": tiles,
            "blocks": GATE_CLUSTER * tiles, "k_rows": k_rows,
            "row_groups": -(-b // GATE_ROWS), "smem_bytes": smem}


def decode_cell_plain(x, c, h, q, proj_mem, memory, score_v, w, bias
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step in plain PyTorch, mirroring the reference kernel's
    op order: float32 attention, ``gh = h @ W_h + b``, ``gi = [x, ctx] @
    W_i``, gates ``gh + gi`` in i, f, g, o order, ``c' = f*c + i*g``,
    ``h' = o * tanh(c')``, each op in the storage dtype (float32 or
    bfloat16).  -> (c' (B, H), h' (B, H))."""
    ctx, _ = additive_attention_plain(q, proj_mem, memory, score_v)
    n_in = x.shape[-1] + ctx.shape[-1]
    inp = torch.cat([x, ctx.to(x.dtype)], dim=-1)
    gh = h @ w[n_in:] + bias
    gi = inp @ w[:n_in]
    i, f, g, o = (gh + gi).chunk(4, dim=-1)
    new_c = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
    new_h = sigmoid(o) * torch.tanh(new_c)
    return new_c, new_h


def fused_decode_cell(x, c, h, q, proj_mem, memory, score_v, w, bias
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (c' (B, H), h' (B, H)).  x (B, E), c/h (B, H), q (B, A),
    proj_mem (B, T, A), memory (B, T, H), score_v (A,), w (E + 2H, 4H),
    bias (4H,), all in the storage dtype (memory's: float32, or bfloat16
    with a float32 ``score_v``).  On CUDA tensors: the two launches of
    the K2 kernel (attention; gate product with the state update, started
    early by programmatic dependent launch), each counted in
    ``fused_decode_cell.launches``; on CPU tensors: the plain version.
    Forward only on both devices: raises ``RuntimeError`` in grad mode
    when an input requires grad, instead of returning outputs that
    autograd would silently treat as constants."""
    what = "fused_decode_cell"
    args = {"x": x, "c": c, "h": h, "q": q, "proj_mem": proj_mem,
            "memory": memory, "score_v": score_v, "w": w, "bias": bias}
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in args.values()):
        raise RuntimeError(
            f"{what}: K2 is forward only, as in the reference; call it "
            "under torch.no_grad() (rollouts and decodes need no gradient)")
    store = _cuda.storage_dtype(what, memory)
    dtypes = dict.fromkeys(args, store)
    dtypes["score_v"] = torch.float32
    if not _cuda.on_cuda(what, args, dtypes):
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
    attn = attention_geometry(b, t, a, hid, memory.element_size())
    gate = gate_geometry(b, e, hid, memory.element_size())
    _cuda.check_aligned(what, {"x": x, "h": h, "q": q,
                               "proj_mem": proj_mem, "memory": memory,
                               "score_v": score_v, "w": w})
    dev = x.device
    ctx = torch.empty((b, hid), dtype=store, device=dev)
    new_c = torch.empty((b, hid), dtype=store, device=dev)
    new_h = torch.empty((b, hid), dtype=store, device=dev)
    fn = _cuda.load("decode_cell", LAUNCHERS[store])
    rc = fn(x.data_ptr(), c.data_ptr(), h.data_ptr(), q.data_ptr(),
            proj_mem.data_ptr(), memory.data_ptr(), score_v.data_ptr(),
            w.data_ptr(), bias.data_ptr(), ctx.data_ptr(), new_c.data_ptr(),
            new_h.data_ptr(), b, t, e, a, hid, attn["smem_bytes"],
            gate["smem_bytes"], torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(rc, what)
    fused_decode_cell.launches += 2     # attention; gates + update
    fused_decode_cell.launches_by_dtype[DTYPE_NAMES[store]] += 2
    return new_c, new_h


#: Kernel launches since the last reset (two per decode step), in all and
#: per storage dtype.
fused_decode_cell.launches = 0
fused_decode_cell.launches_by_dtype = dict.fromkeys(DTYPE_NAMES.values(), 0)


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
    cell — the contract of ``ops.sampling.make_decode_step``.  The
    embedding, the query projection and the vocab head run in the model's
    compute dtype around the kernel, whose weights are prepared in that
    dtype once here (the parameters themselves in float32).  Raises for a
    model the cell does not cover."""
    ok, reason = fused_decode_supported(model)
    if not ok:
        raise ValueError(f"decode_kernel='fused' does not cover this "
                         f"model: {reason}")
    dtype = model.dtype
    cell = model.cell
    emb = cell.embed.weight.to(dtype)
    wq = cell.attn.query_proj.weight.to(dtype)
    score_v = cell.attn.score_v                          # float32 always
    w = cell.lstm[0].w.to(dtype)
    bias = cell.lstm[0].bias.to(dtype)
    w_logit = model.logit.weight.to(dtype)
    b_logit = model.logit.bias.to(dtype)

    def step(carry, token):
        (c, h), = carry
        x = embed(token, emb, dtype)                      # (N, E)
        q = dense(h, wq, None, dtype)                     # (N, A)
        new_c, new_h = fused_decode_cell(x, c, h, q, proj_mem, memory,
                                         score_v, w, bias)
        return ((new_c, new_h),), dense(new_h, w_logit, b_logit, dtype)

    return step
