"""The launch geometry of the port's CUDA kernels, checked on the CPU.

Each kernel wrapper computes its kernel's geometry (clusters, column
tiles, K slices, row groups, shared-memory bytes) in plain Python before
it touches CUDA, and the C launcher refuses a shared-memory size that
disagrees with its own layout.  These tests hold the geometry to what one
H100 offers at the serving width (E = H = A = 512, T = 29, MSR-VTT) and at
the width of the port's small test model (E = H = A = 32), and check that
the wrappers raise ``ValueError`` for a shape the kernels do not take.
"""

import re

import pytest
import torch

from cst_captioning_tpu_torch.ops import _cuda
from cst_captioning_tpu_torch.ops import attention_kernel as k1
from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2

SMS = 132                  # streaming multiprocessors of an H100 SXM
SM_SMEM = 233472           # shared memory of one SM (228 KB)
BLOCK_RESERVED = 1024      # the runtime's shared memory a block
SERVING = dict(t=29, e=512, h=512, a=512)
SMALL = dict(t=5, e=32, h=32, a=32)


@pytest.mark.parametrize("b", [1, 8, 40])
@pytest.mark.parametrize("dims", [SERVING, SMALL, dict(SMALL, t=6)],
                         ids=["serving", "small-t5", "small-t6"])
def test_geometry_fits_one_card(dims, b):
    """Serving batches take the weight stream (``gate_kernel``): a cluster
    of 2 blocks a column tile of 8 units, 8 rows a block, each block
    keeping the tree's 8 chunk sums of the 4 units it finishes."""
    gate = k2.gate_geometry(b, dims["e"], dims["h"])
    attn = k1.attention_geometry(b, dims["t"], dims["a"], dims["h"])
    assert (gate["kernel"], gate["variant"], gate["cluster"]) == (
        "gate_kernel", 0, 2)
    assert gate["smem_bytes"] <= k1.SMEM_LIMIT
    assert attn["smem_bytes"] <= k1.SMEM_LIMIT
    assert gate["column_tiles"] == dims["h"] // 8
    assert gate["row_tiles"] == -(-b // 8)
    assert gate["blocks"] == 2 * gate["column_tiles"] * gate["row_tiles"]
    if b <= 8:
        assert gate["blocks"] <= SMS        # the weight stream is one wave
    # A gate block and an attention block fit on one SM together, so the
    # gate launch can start while the attention runs.
    assert (gate["smem_bytes"] + attn["smem_bytes"] + 2 * BLOCK_RESERVED
            <= SM_SMEM)
    assert attn["blocks"] == attn["cluster"] * b


def test_serving_geometry():
    """At the serving width the float32 stream has 64 column tiles of 8
    units (a gate strip of a row is 32 bytes), each a cluster of 2 blocks
    that take 4 of the tree's 8 chunks each, a group of 64 threads a
    chunk with 3 of its 6 tiles in flight (a tile's weights 4 KB, its
    inputs 1 KB), then the 8 chunks' sums of 8 rows x 4 units x 4 gates (4
    KB): 64 KB a block.  A row of the attention is a cluster of 4
    blocks."""
    gate = k2.gate_geometry(8, 512, 512)
    assert gate == {"kernel": "gate_kernel", "variant": 0, "cluster": 2,
                    "units": 8, "rows": 8, "threads": 256,
                    "column_tiles": 64, "row_tiles": 1, "blocks": 128,
                    "k_tiles": 48,
                    "smem_bytes": 4 * (4 * 3 * (32 * 32 + 8 * 32)
                                       + 8 * 8 * 16)}
    assert gate["smem_bytes"] == 64 * 1024
    attn = k1.attention_geometry(8, 29, 512, 512)
    assert attn == {"cluster": 4, "blocks": 32, "time_steps": 8,
                    "h_slice": 128, "smem_bytes": 35444}


@pytest.mark.parametrize("b, groups", [(1, 1), (3, 1), (8, 1), (9, 2),
                                       (40, 5), (64, 8), (100, 13)])
def test_gate_row_groups(b, groups):
    assert k2.gate_geometry(b, 512, 512)["row_tiles"] == groups


#: Width of the learning check's chain (``tools/stage_chain.py``).
CHAIN = dict(t=29, e=192, h=192, a=192)


@pytest.mark.parametrize("elem", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b, dims, tiles", [(160, CHAIN, 24),
                                            (320, SERVING, 64)],
                         ids=["chain-160", "serving-320"])
def test_eval_beam_geometry(b, dims, tiles, elem):
    """The beam-5 eval's K2 batches: 32 videos x 5 beams at the chain's
    width, 64 x 5 at MSR-VTT's.  Both take the large-batch kernels:
    float32's register tiles (32 rows x 32 units at these middling
    batches), bfloat16's tensor cores (128 rows x 16 units); ``tiles`` is
    the width's count of 8-unit strips.  The attention is a 4-block
    cluster a row."""
    gate = k2.gate_geometry(b, dims["e"], dims["h"], elem)
    attn = k1.attention_geometry(b, dims["t"], dims["a"], dims["h"], elem)
    if elem == 4:
        assert (gate["kernel"], gate["variant"], gate["units"],
                gate["rows"]) == ("gate_tile_kernel", 2, 32, 32)
    else:
        assert (gate["kernel"], gate["variant"], gate["units"],
                gate["rows"]) == ("gate_mma_kernel", 1, 16, 128)
    assert gate["column_tiles"] * gate["units"] == 8 * tiles
    assert gate["row_tiles"] == -(-b // gate["rows"])
    assert gate["smem_bytes"] <= k1.SMEM_LIMIT
    assert attn["smem_bytes"] <= k1.SMEM_LIMIT
    assert attn["blocks"] == attn["cluster"] * b == 4 * b
    assert (gate["smem_bytes"] + attn["smem_bytes"] + 2 * BLOCK_RESERVED
            <= SM_SMEM)


@pytest.mark.parametrize("args, match", [
    ((8, 512, 20), "multiples of 32"),      # H not a multiple of 32
    ((8, 16, 32), "multiples of 32"),       # E not a multiple of 32
    ((0, 512, 512), "empty"),
    ((8, 512, 0), "empty"),
])
def test_gate_geometry_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        k2.gate_geometry(*args)


@pytest.mark.parametrize("args, match", [
    ((8, 29, 30, 512), "A % 4 == 0"),
    ((8, 29, 512, 40), "H % 16 == 0"),
    ((0, 29, 512, 512), "1 <= B"),
    ((70000, 29, 512, 512), "1 <= B"),
    ((8, 400, 512, 512), "shared memory"),
])
def test_attention_geometry_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        k1.attention_geometry(*args)


def _cell_args(b, t, e, h, a):
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    return (r(b, e), r(b, h), r(b, h), r(b, a), r(b, t, a), r(b, t, h), r(a),
            r(e + 2 * h, 4 * h), r(4 * h))


@pytest.mark.parametrize("kernel, dims, match", [
    ("K2", dict(t=5, e=32, h=40, a=32), "H % 16 == 0"),
    ("K2", dict(t=5, e=16, h=32, a=32), "multiples of 32"),
    ("K1", dict(t=5, e=32, h=32, a=30), "A % 4 == 0"),
])
def test_wrappers_raise_before_touching_cuda(monkeypatch, kernel, dims,
                                             match):
    """The wrappers check the geometry on the route that launches the
    kernel: made to take that route with CPU tensors, they raise
    ValueError and never load a kernel library."""
    def no_cuda(*args, **kwargs):
        raise AssertionError("the wrapper reached CUDA")

    monkeypatch.setattr(_cuda, "on_cuda", lambda what, tensors, dtypes: True)
    monkeypatch.setattr(_cuda, "load", no_cuda)
    args = _cell_args(2, **dims)
    with pytest.raises(ValueError, match=match):
        if kernel == "K2":
            k2.fused_decode_cell(*args)
        else:
            k1.fused_additive_attention(*args[3:7])


def _constants(name):
    text = (_cuda.CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_geometry_constants_match_the_cuda_sources():
    gate = _constants("decode_cell.cu")
    assert (gate["kChunk"], gate["kTreeChunks"]) == (k2.GATE_CHUNK,
                                                      k2.GATE_TREE_CHUNKS)
    assert gate["kStreamGroup"] == k2.GATE_STREAM_GROUP
    for name, table in (("Units", k2.GATE_STREAM_UNITS),
                        ("Cluster", k2.GATE_STREAM_CLUSTER),
                        ("Rows", k2.GATE_STREAM_ROWS),
                        ("Slots", k2.GATE_STREAM_SLOTS)):
        assert {4: gate[f"kStream{name}F32"],
                2: gate[f"kStream{name}Bf16"]} == table, name
    assert (gate["kTileRows"], gate["kTileRowsMid"], gate["kTileUnits"],
            gate["kTilePitch"]) == (
        k2.GATE_TILE_ROWS, k2.GATE_TILE_ROWS_MID, k2.GATE_TILE_UNITS,
        k2.GATE_TILE_PITCH)
    assert {gate["kTileRows"]: gate["kTileStages"],
            gate["kTileRowsMid"]: gate["kTileStagesMid"]} == \
        k2.GATE_TILE_STAGES
    assert (gate["kMmaWarpsM"], gate["kMmaWarpsN"], gate["kMmaMt"],
            gate["kMmaStages"]) == k2.GATE_MMA
    assert gate["kMmaPad"] == k2.GATE_MMA_PAD
    text = (_cuda.CSRC / "decode_cell.cu").read_text()
    for symbol in k2.GATE_KERNELS:
        assert re.search(rf"\b{symbol}\(", text), symbol
    assert _constants("attention.cuh")["kAttnCluster"] == k1.ATTN_CLUSTER


# -- bfloat16 storage: a 16-byte copy carries 8 values ---------------------

@pytest.mark.parametrize("b", [1, 8, 40, 1344])
@pytest.mark.parametrize("dims", [SERVING, SMALL, dict(SMALL, t=6)],
                         ids=["serving", "small-t5", "small-t6"])
def test_bf16_geometry_fits_one_card(dims, b):
    """bfloat16 runs on the tensor cores in both its kernels: the stream
    (``gate_kernel``, 4-block clusters of 4 warps) up to 128 rows, the
    tiles (``gate_mma_kernel``, 128 x 16 a block of 8 warps) above; a gate
    block and an attention block share an SM."""
    gate = k2.gate_geometry(b, dims["e"], dims["h"], 2)
    attn = k1.attention_geometry(b, dims["t"], dims["a"], dims["h"], 2)
    small = b <= k2.GATE_STREAM_MAX_B
    assert (gate["kernel"], gate["variant"], gate["cluster"], gate["rows"],
            gate["units"], gate["threads"]) == (
        ("gate_kernel", 0, 4, 16, 16, 128) if small
        else ("gate_mma_kernel", 1, 1, 128, 16, 256))
    assert gate["blocks"] == gate["cluster"] * (
        dims["h"] // gate["units"]) * -(-b // gate["rows"])
    assert gate["smem_bytes"] <= k1.SMEM_LIMIT
    assert attn["smem_bytes"] <= k1.SMEM_LIMIT
    assert (gate["smem_bytes"] + attn["smem_bytes"] + 2 * BLOCK_RESERVED
            <= SM_SMEM)


def test_bf16_serving_geometry():
    """At the serving width bfloat16 streams the weights through 32
    clusters of 4 blocks (16 units, a gate strip of a row 32 bytes; 16
    rows, one m16 tile), 2 chunks a block, a group of 2 warps a chunk with
    4 slots of a tile's weights (32 x 64, rows padded by 8) and inputs (16
    x 32 + 8), then the 8 chunk sums of 16 rows x 16 columns; at the
    rollout batch 11 x 32 blocks of 8 warps (128 rows x 16 units), 3
    tiles in flight and the h side's running sums (32 KB)."""
    gate = k2.gate_geometry(8, 512, 512, 2)
    assert gate == {"kernel": "gate_kernel", "variant": 0, "cluster": 4,
                    "units": 16, "rows": 16, "threads": 128,
                    "column_tiles": 32, "row_tiles": 1, "blocks": 128,
                    "k_tiles": 48,
                    "smem_bytes": 2 * 2 * 4 * (32 * 72 + 16 * 40)
                    + 4 * 8 * 16 * 16}
    # Each weight is read once a step: 2 chunks of 6 tiles a block.
    assert gate["blocks"] * 2 * 6 * 32 * 4 * 16 * 2 == \
        (512 + 2 * 512) * 4 * 512 * 2
    big = k2.gate_geometry(1344, 512, 512, 2)
    assert (big["variant"], big["column_tiles"], big["row_tiles"],
            big["smem_bytes"]) == (1, 32, 11, 2 * 3 * (128 * 40 + 32 * 72)
                                   + 4 * 32 * 256)
    attn = k1.attention_geometry(8, 29, 512, 512, 2)
    assert attn == {"cluster": 4, "blocks": 32, "time_steps": 8,
                    "h_slice": 128,
                    "smem_bytes": 2 * (512 + 8 * 512 + 29 * 128)
                    + 4 * (512 + 29)}


@pytest.mark.parametrize("args, match", [
    ((8, 512, 48, 2), "multiples of 32"),   # H: 1.5 chunks
    ((8, 16, 32, 2), "multiples of 32"),    # E: half a chunk
    ((8, 512, 512, 3), "float32 \\(4\\) or bfloat16 \\(2\\)"),
])
def test_bf16_gate_geometry_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        k2.gate_geometry(*args)


@pytest.mark.parametrize("args, match", [
    ((8, 29, 36, 512, 2), "A % 8 == 0"),
    ((8, 29, 512, 48, 2), "H % 32 == 0"),
    ((8, 29, 512, 512, 8), "float32 \\(4\\) or bfloat16 \\(2\\)"),
])
def test_bf16_attention_geometry_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        k1.attention_geometry(*args)


@pytest.mark.parametrize("kernel, dims, match", [
    ("K2", dict(t=5, e=32, h=48, a=32), "H % 32 == 0"),
    ("K2", dict(t=5, e=16, h=32, a=32), "multiples of 32"),
    ("K1", dict(t=5, e=32, h=32, a=36), "A % 8 == 0"),
])
def test_bf16_wrappers_raise_before_touching_cuda(monkeypatch, kernel,
                                                   dims, match):
    def no_cuda(*args, **kwargs):
        raise AssertionError("the wrapper reached CUDA")

    monkeypatch.setattr(_cuda, "on_cuda", lambda what, tensors, dtypes: True)
    monkeypatch.setattr(_cuda, "load", no_cuda)
    args = [a if i == 6 else a.to(torch.bfloat16)
            for i, a in enumerate(_cell_args(2, **dims))]
    with pytest.raises(ValueError, match=match):
        if kernel == "K2":
            k2.fused_decode_cell(*args)
        else:
            k1.fused_additive_attention(*args[3:7])


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("case", ["mixed", "bf16-score_v", "half"])
def test_wrappers_refuse_mixed_or_unsupported_storage(kernel, case):
    """Storage is float32, or bfloat16 with a float32 score_v, on either
    device: a float32 operand among bfloat16 ones, a bfloat16 score_v or
    a half-precision storage raise TypeError, on CPU tensors too."""
    args = list(_cell_args(3, **SMALL))
    if case == "half":
        args = [a if i == 6 else a.half() for i, a in enumerate(args)]
    else:
        args = [a if i == 6 else a.to(torch.bfloat16)
                for i, a in enumerate(args)]
        if case == "mixed":
            args[4] = args[4].float()           # proj_mem
        else:
            args[6] = args[6].to(torch.bfloat16)
    with pytest.raises(TypeError, match="float32|bfloat16"):
        if kernel == "K2":
            k2.fused_decode_cell(*args)
        else:
            k1.fused_additive_attention(*args[3:7])


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_wrappers_take_bf16_plain_version_on_cpu(kernel):
    """bfloat16 storage on CPU tensors: the plain version, outputs in
    bfloat16, no launch counted."""
    args = [a if i == 6 else a.to(torch.bfloat16)
            for i, a in enumerate(_cell_args(3, **SMALL))]
    fn, plain, args = ((k2.fused_decode_cell, k2.decode_cell_plain, args)
                       if kernel == "K2" else
                       (k1.fused_additive_attention,
                        k1.additive_attention_plain, args[3:7]))
    fn.launches = 0
    fn.launches_by_dtype = {"float32": 0, "bfloat16": 0}
    with torch.no_grad():
        got, want = fn(*args), plain(*args)
    assert all(g.dtype == torch.bfloat16 and torch.equal(g, w)
               for g, w in zip(got, want))
    assert fn.launches == 0 and sum(fn.launches_by_dtype.values()) == 0


# -- which gate kernel runs ------------------------------------------------

@pytest.mark.parametrize("elem, b, kernel, variant", [
    (4, 1, "gate_kernel", 0), (4, 8, "gate_kernel", 0),
    (4, 40, "gate_kernel", 0), (4, 128, "gate_kernel", 0),
    (4, 129, "gate_tile_kernel", 2), (4, 320, "gate_tile_kernel", 2),
    (4, 640, "gate_tile_kernel", 2), (4, 641, "gate_tile_kernel", 1),
    (4, 1344, "gate_tile_kernel", 1),
    (2, 1, "gate_kernel", 0), (2, 8, "gate_kernel", 0),
    (2, 40, "gate_kernel", 0), (2, 128, "gate_kernel", 0),
    (2, 129, "gate_mma_kernel", 1), (2, 320, "gate_mma_kernel", 1),
    (2, 1344, "gate_mma_kernel", 1)])
def test_gate_kernel_dispatch(elem, b, kernel, variant):
    """Both storage dtypes: the weight stream up to 128 rows; above,
    float32's register tiles (32 rows a block up to 640, 64 above),
    bfloat16's tensor-core tiles.  Every choice covers the batch with
    whole tiles and fits a block."""
    gate = k2.gate_geometry(b, 512, 512, elem)
    assert (gate["kernel"], gate["variant"]) == (kernel, variant)
    assert gate["row_tiles"] * gate["rows"] >= b > (
        gate["row_tiles"] - 1) * gate["rows"]
    assert gate["column_tiles"] * gate["units"] == 512
    assert gate["threads"] % 32 == 0 and gate["threads"] <= 1024
    assert gate["smem_bytes"] <= k1.SMEM_LIMIT


def test_rollout_geometry():
    """The CST rollout (1344 rows): float32 in 21 x 16 register-tiled
    blocks (64 rows x 128 columns, four 25 KB tiles in flight: two blocks
    an SM), bfloat16 in 11 x 32 tensor-core blocks."""
    f32 = k2.gate_geometry(1344, 512, 512, 4)
    assert (f32["row_tiles"], f32["column_tiles"], f32["threads"]) == (
        21, 16, 256)
    assert f32["smem_bytes"] == 4 * 4 * (64 * 36 + 32 * 128) == 102400
    assert 2 * (f32["smem_bytes"] + BLOCK_RESERVED) <= SM_SMEM
    bf16 = k2.gate_geometry(1344, 512, 512, 2)
    assert (bf16["row_tiles"], bf16["column_tiles"], bf16["blocks"]) == (
        11, 32, 352)


@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b", [8, 320])
def test_wrapper_passes_the_gate_variant_and_counts_it(monkeypatch, store,
                                                       b):
    """Made to take the kernel route with CPU tensors and a stand-in
    launcher, the wrapper hands the launcher the variant and shared
    memory that ``gate_geometry`` picked and counts the gate launch under
    that kernel's symbol (``ops.gate_launch_counts``)."""
    from cst_captioning_tpu_torch import ops

    calls = []

    def launcher(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_cuda, "on_cuda", lambda what, tensors, dtypes: True)
    monkeypatch.setattr(_cuda, "load", lambda lib, fn: launcher)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    args = [a if i == 6 else a.to(store)
            for i, a in enumerate(_cell_args(b, **SMALL))]
    ops.reset_launch_counts()
    k2.fused_decode_cell(*args)
    gate = k2.gate_geometry(b, 32, 32, 4 if store == torch.float32 else 2)
    assert len(calls) == 1
    assert calls[0][-3:-1] == (gate["variant"], gate["smem_bytes"])
    counts = ops.gate_launch_counts()
    assert counts == {f"fused_decode_cell/{name}": int(name == gate["kernel"])
                      for name in k2.GATE_KERNELS}
    assert k2.fused_decode_cell.launches == 2
    ops.reset_launch_counts()
    assert sum(ops.gate_launch_counts().values()) == 0


@pytest.mark.parametrize("elem", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b", [8, 1344])
def test_gate_shared_memory_does_not_grow_with_k(elem, b):
    """Every gate kernel streams K in tiles and keeps 8 chunk sums, so its
    shared memory is the same at E = 4096 as at the serving width."""
    wide = k2.gate_geometry(b, 4096, 512, elem)
    assert wide["smem_bytes"] == k2.gate_geometry(b, 512, 512,
                                                  elem)["smem_bytes"]
    assert wide["k_tiles"] == (4096 + 2 * 512) // 32
