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
    gate = k2.gate_geometry(b, dims["e"], dims["h"])
    attn = k1.attention_geometry(b, dims["t"], dims["a"], dims["h"])
    assert gate["smem_bytes"] <= k1.SMEM_LIMIT
    assert attn["smem_bytes"] <= k1.SMEM_LIMIT
    assert gate["blocks"] <= SMS            # the weight stream is one wave
    assert gate["blocks"] == gate["cluster"] * gate["column_tiles"]
    # A gate block and an attention block fit on one SM together, so the
    # gate launch can start while the attention runs.
    assert (gate["smem_bytes"] + attn["smem_bytes"] + 2 * BLOCK_RESERVED
            <= SM_SMEM)
    assert attn["blocks"] == attn["cluster"] * b


def test_serving_geometry():
    """At the serving width every one of the 64 column tiles is a cluster
    of 2 blocks, each holding half of each segment of K (768 rows, 96 KB
    of weights); a row of the attention is a cluster of 4 blocks."""
    gate = k2.gate_geometry(8, 512, 512)
    assert gate == {"cluster": 2, "column_tiles": 64, "blocks": 128,
                    "k_rows": 768, "row_groups": 1, "smem_bytes": 163840}
    assert 4 * gate["k_rows"] * 4 * k2.GATE_UNITS == 96 * 1024
    attn = k1.attention_geometry(8, 29, 512, 512)
    assert attn == {"cluster": 4, "blocks": 32, "time_steps": 8,
                    "h_slice": 128, "smem_bytes": 35444}


@pytest.mark.parametrize("b, groups", [(1, 1), (3, 1), (8, 1), (9, 2),
                                       (40, 5), (64, 8), (100, 13)])
def test_gate_row_groups(b, groups):
    assert k2.gate_geometry(b, 512, 512)["row_groups"] == groups


#: Width of the learning check's chain (``tools/stage_chain.py``).
CHAIN = dict(t=29, e=192, h=192, a=192)


@pytest.mark.parametrize("elem", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b, dims, tiles", [(160, CHAIN, 24),
                                            (320, SERVING, 64)],
                         ids=["chain-160", "serving-320"])
def test_eval_beam_geometry(b, dims, tiles, elem):
    """The beam-5 eval's K2 batches: 32 videos x 5 beams at the chain's
    width, 64 x 5 at MSR-VTT's.  The weight stream stays one wave of
    2-block clusters and the rows go in groups of 8; the attention is a
    4-block cluster a row."""
    gate = k2.gate_geometry(b, dims["e"], dims["h"], elem)
    attn = k1.attention_geometry(b, dims["t"], dims["a"], dims["h"], elem)
    assert (gate["cluster"], gate["column_tiles"]) == (2, tiles)
    assert gate["blocks"] == 2 * tiles <= SMS
    assert gate["row_groups"] == b // 8
    assert gate["smem_bytes"] <= k1.SMEM_LIMIT
    assert attn["smem_bytes"] <= k1.SMEM_LIMIT
    assert attn["blocks"] == attn["cluster"] * b == 4 * b
    assert (gate["smem_bytes"] + attn["smem_bytes"] + 2 * BLOCK_RESERVED
            <= SM_SMEM)


@pytest.mark.parametrize("args, match", [
    ((8, 512, 20), "multiples of 8"),       # H not a multiple of 8
    ((8, 12, 32), "multiples of 8"),        # E not a multiple of 8
    ((0, 512, 512), "empty"),
    ((8, 4096, 512), "shared memory"),      # the K slice does not fit
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
    ("K2", dict(t=5, e=12, h=32, a=32), "multiples of 8"),
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
    assert (gate["kGateCluster"], gate["kGateUnits"], gate["kGateSub"],
            gate["kGateWarps"], gate["kGateRows"], gate["kChunkRows"]) == (
        k2.GATE_CLUSTER, k2.GATE_UNITS, k2.GATE_SUB, k2.GATE_WARPS,
        k2.GATE_ROWS, k2.GATE_CHUNK_ROWS)
    assert _constants("attention.cuh")["kAttnCluster"] == k1.ATTN_CLUSTER


# -- bfloat16 storage: a 16-byte copy carries 8 values ---------------------

@pytest.mark.parametrize("b", [1, 8, 40, 1344])
@pytest.mark.parametrize("dims", [SERVING, SMALL, dict(SMALL, t=6)],
                         ids=["serving", "small-t5", "small-t6"])
def test_bf16_geometry_fits_one_card(dims, b):
    gate = k2.gate_geometry(b, dims["e"], dims["h"], 2)
    attn = k1.attention_geometry(b, dims["t"], dims["a"], dims["h"], 2)
    assert gate["smem_bytes"] <= k1.SMEM_LIMIT
    assert attn["smem_bytes"] <= k1.SMEM_LIMIT
    assert gate["blocks"] <= SMS
    assert (gate["smem_bytes"] + attn["smem_bytes"] + 2 * BLOCK_RESERVED
            <= SM_SMEM)


def test_bf16_serving_geometry():
    """bfloat16 halves the weight slice (48 KB a block, 6.3 MB in all) and
    the input buffers; the partial sums double (the h side and the input
    side are summed apart); the tiles and K slices are those of float32."""
    gate = k2.gate_geometry(8, 512, 512, 2)
    assert gate == {"cluster": 2, "column_tiles": 64, "blocks": 128,
                    "k_rows": 768, "row_groups": 1,
                    "smem_bytes": 2 * 4 * (8 * 8 * 32 + 64 * 32)
                    + 2 * (768 * 32 + 2 * 8 * 768)}
    assert 2 * gate["k_rows"] * 4 * k2.GATE_UNITS == 48 * 1024
    assert gate["blocks"] * 48 * 1024 == (512 + 2 * 512) * 4 * 512 * 2
    attn = k1.attention_geometry(8, 29, 512, 512, 2)
    assert attn == {"cluster": 4, "blocks": 32, "time_steps": 8,
                    "h_slice": 128,
                    "smem_bytes": 2 * (512 + 8 * 512 + 29 * 128)
                    + 4 * (512 + 29)}


@pytest.mark.parametrize("args, match", [
    ((8, 512, 24, 2), "multiples of 16"),   # H: 12 rows a slice, not 8k
    ((8, 8, 32, 2), "multiples of 16"),     # E: 4 rows a slice
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
    ("K2", dict(t=5, e=24, h=32, a=32), "multiples of 16"),
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
