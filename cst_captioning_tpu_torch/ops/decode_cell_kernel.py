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

``gate_geometry`` picks the gate kernel for (B, E, H, storage) and
computes its launch geometry in plain Python, before the wrapper touches
CUDA; it raises ``ValueError`` for a shape no gate kernel takes.  Three
gate kernels (``csrc/decode_cell.cu``), one summation tree:
``gate_kernel`` (both storage dtypes, B <= ``GATE_STREAM_MAX_B``: the
weight stream, K split by chunks over a cluster of blocks),
``gate_tile_kernel`` (float32, larger B: register tiles over rows) and
``gate_mma_kernel`` (bfloat16, larger B: the tensor cores).  K's rows go
in chunks of ``GATE_CHUNK`` (E and H must be multiples of it), and a
row's outputs have the same bits whichever kernel runs it.

Storage: float32, or bfloat16 as the reference kernel runs under
``--use_bfloat16`` (``pallas_decode_cell.py``): x, c, h, q, the
encodings, ``w`` and ``bias`` in bfloat16, ``score_v`` float32.  The
attention runs in float32 and its context is rounded to bfloat16; the
gates round where the reference's ops round: the h-side and input-side
products (each summed in float32) to bfloat16, ``+ b``, ``gh + gi``, each
activation, ``f*c``, ``i*g``, ``c'``, ``tanh(c')`` and ``h'``.
``make_fused_decode_step`` prepares the weights in the model's compute
dtype once per binding.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch

from ..precision import dense, embed, sigmoid
from . import _cuda
from .attention_kernel import (DTYPE_NAMES, SMEM_LIMIT,
                               additive_attention_plain, attention_geometry)

#: Rows of K a tile, and chunks of a side of the summation tree
#: (``csrc/decode_cell.cu``).
GATE_CHUNK = 32
GATE_TREE_CHUNKS = 8
#: ``gate_kernel`` (B <= GATE_STREAM_MAX_B), by storage bytes: blocks a
#: cluster, hidden units a cluster's column tile, batch rows a block
#: (bfloat16: an m16 tile), tiles in flight a group.  A block has a group
#: of GATE_STREAM_GROUP threads for each of its chunks of the tree
#: (GATE_TREE_CHUNKS / cluster).
GATE_STREAM_GROUP = 64
GATE_STREAM_CLUSTER = {4: 2, 2: 4}
GATE_STREAM_UNITS = {4: 8, 2: 16}
GATE_STREAM_ROWS = {4: 8, 2: 16}
GATE_STREAM_SLOTS = {4: 3, 2: 4}
GATE_STREAM_MAX_B = 128
#: ``gate_tile_kernel`` (float32, larger B): batch rows a block (32 up to
#: GATE_TILE_MID_MAX_B rows, to fill the card; 64 above), hidden units a
#: block, tiles in flight by rows, floats a row of a tile's inputs.  A
#: thread holds 4 rows x 2 units.
GATE_TILE_ROWS = 64
GATE_TILE_ROWS_MID = 32
GATE_TILE_MID_MAX_B = 640
GATE_TILE_UNITS = 32
GATE_TILE_STAGES = {64: 4, 32: 2}
GATE_TILE_PITCH = 36
#: ``gate_mma_kernel`` (bfloat16, larger B): warps over rows, warps over
#: units, m16 tiles a warp, tiles in flight; bf16 padding a row.
GATE_MMA = (4, 2, 2, 3)
GATE_MMA_PAD = 8
#: The gate kernels' CUDA symbols, as a profiler names them.
GATE_KERNELS = ("gate_kernel", "gate_tile_kernel", "gate_mma_kernel")
#: The C launcher of each storage dtype (``csrc/decode_cell.cu``).
LAUNCHERS = {torch.float32: "decode_cell_forward",
             torch.bfloat16: "decode_cell_forward_bf16"}


@functools.lru_cache(maxsize=None)
def gate_geometry(b: int, e: int, h: int, elem_bytes: int = 4) -> dict:
    """The gate kernel for B rows, input width E and hidden width H,
    stored in ``elem_bytes``-byte values (4: float32, 2: bfloat16), and
    its launch geometry: ``kernel`` (its CUDA symbol), ``variant`` (the
    launcher's number for it), ``cluster`` (blocks that split a column
    tile's K), ``units`` a column tile and ``rows`` a block,
    ``threads``, ``column_tiles`` x ``row_tiles`` x ``cluster`` =
    ``blocks``, ``k_tiles`` (of ``GATE_CHUNK`` rows of K) and
    ``smem_bytes`` a block.  Raises ``ValueError`` for a shape no gate
    kernel takes: E or H not a multiple of ``GATE_CHUNK``."""
    if elem_bytes not in (2, 4):
        raise ValueError(f"gate kernel: {elem_bytes}-byte storage; takes "
                         "float32 (4) or bfloat16 (2)")
    if min(b, e, h) < 1:
        raise ValueError(f"gate kernel: empty shape B={b} E={e} H={h}")
    if e % GATE_CHUNK or h % GATE_CHUNK:
        raise ValueError(f"gate kernel: E and H must be multiples of "
                         f"{GATE_CHUNK}; got E={e}, H={h}")
    k_tiles = (e + 2 * h) // GATE_CHUNK
    cluster = 1
    if b <= GATE_STREAM_MAX_B:
        kernel, variant = "gate_kernel", 0
        cluster = GATE_STREAM_CLUSTER[elem_bytes]
        units, rows = GATE_STREAM_UNITS[elem_bytes], GATE_STREAM_ROWS[elem_bytes]
        groups = GATE_TREE_CHUNKS // cluster
        threads = groups * GATE_STREAM_GROUP
        cols = 4 * units
        # Each group's slots (a tile's weights, then its inputs; bfloat16
        # rows padded for ldmatrix), in the storage dtype; then the tree's
        # chunk sums (float32) of this block's rows and of the units it
        # finishes (units / cluster of each gate).
        pad = GATE_MMA_PAD if elem_bytes == 2 else 0
        smem = (elem_bytes * groups * GATE_STREAM_SLOTS[elem_bytes]
                * (GATE_CHUNK * (cols + pad) + rows * (GATE_CHUNK + pad))
                + 4 * GATE_TREE_CHUNKS * rows * 4 * (units // cluster))
    elif elem_bytes == 4:
        mid = b <= GATE_TILE_MID_MAX_B
        kernel, variant = "gate_tile_kernel", 2 if mid else 1
        units = GATE_TILE_UNITS
        rows = GATE_TILE_ROWS_MID if mid else GATE_TILE_ROWS
        threads = (rows // 4) * (units // 2)
        smem = 4 * GATE_TILE_STAGES[rows] * (rows * GATE_TILE_PITCH
                                             + GATE_CHUNK * 4 * units)
    else:
        warps_m, warps_n, m_tiles, stages = GATE_MMA
        kernel, variant = "gate_mma_kernel", 1
        units, rows = 8 * warps_n, 16 * m_tiles * warps_m
        threads = 32 * warps_m * warps_n
        # The ring (a tile's inputs and weights, rows padded; bfloat16),
        # then the h side's running sums (float32, 16 a thread an m16 tile).
        smem = (2 * stages * (rows * (GATE_CHUNK + GATE_MMA_PAD)
                              + GATE_CHUNK * (4 * units + GATE_MMA_PAD))
                + 4 * 16 * m_tiles * threads)
    tiles, row_tiles = h // units, -(-b // rows)
    return {"kernel": kernel, "variant": variant, "cluster": cluster,
            "units": units, "rows": rows, "threads": threads,
            "column_tiles": tiles, "row_tiles": row_tiles,
            "blocks": tiles * row_tiles * cluster, "k_tiles": k_tiles,
            "smem_bytes": smem}


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
    ``fused_decode_cell.launches`` (the gate launch also in
    ``launches_by_gate`` under the kernel ``gate_geometry`` picked); on
    CPU tensors: the plain version.
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
            gate["variant"], gate["smem_bytes"],
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(rc, what)
    fused_decode_cell.launches += 2     # attention; gates + update
    fused_decode_cell.launches_by_dtype[DTYPE_NAMES[store]] += 2
    fused_decode_cell.launches_by_gate[gate["kernel"]] += 1
    return new_c, new_h


#: Kernel launches since the last reset (two per decode step), in all and
#: per storage dtype; and the gate launches per gate kernel.
fused_decode_cell.launches = 0
fused_decode_cell.launches_by_dtype = dict.fromkeys(DTYPE_NAMES.values(), 0)
fused_decode_cell.launches_by_gate = dict.fromkeys(GATE_KERNELS, 0)


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
