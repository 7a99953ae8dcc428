"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The file imports neither JAX nor the reference
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.ops import attention_kernel as k1
from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2
from cst_captioning_tpu_torch.ops import launch_counts, reset_launch_counts
from cst_captioning_tpu_torch.ops.sampling import greedy_decode
from cst_captioning_tpu_torch.serving.engine import serve_decode_batch
from cst_captioning_tpu_torch.weights import init_random_

pytestmark = pytest.mark.cuda

T, E, H, A = 29, 512, 512, 512        # the serving shapes (MSR-VTT width)
SMALL = dict(t=5, e=32, h=32, a=32)   # the width of the served model below
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _attention_inputs(b, seed, t=T, a=A, h=H):
    """(q, proj_mem, memory, score_v) on the CPU."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, a, generator=g), torch.randn(b, t, a, generator=g),
            torch.randn(b, t, h, generator=g),
            torch.randn(a, generator=g) / a ** 0.5)


def _cell_inputs(b, seed, t=T, e=E, h=H, a=A):
    """(x, c, h, q, proj_mem, memory, score_v, w, bias) on the CPU."""
    g = torch.Generator().manual_seed(100 + seed)
    q, pm, mem, v = _attention_inputs(b, seed, t, a, h)
    return (torch.randn(b, e, generator=g), torch.randn(b, h, generator=g),
            torch.tanh(torch.randn(b, h, generator=g)), q, pm, mem, v,
            torch.randn(e + 2 * h, 4 * h, generator=g) / (e + h) ** 0.5,
            0.1 * torch.randn(4 * h, generator=g))


def _max_err(got, want):
    return max((g - w).abs().max().item() for g, w in zip(got, want))


@pytest.mark.parametrize("b", [1, 8, 40])
def test_attention_kernel_matches_plain(cuda, b):
    args = [a.to(cuda) for a in _attention_inputs(b, b)]
    before = k1.fused_additive_attention.launches
    ctx, w = k1.fused_additive_attention(*args)
    torch.cuda.synchronize()
    assert k1.fused_additive_attention.launches == before + 1
    ref_ctx, ref_w = k1.additive_attention_plain(*args)
    assert (ctx - ref_ctx).abs().max().item() <= TOL
    assert (w - ref_w).abs().max().item() <= TOL


@pytest.mark.parametrize("b", [1, 3, 8, 40, 64, 100, 320, 1344])
def test_decode_cell_kernel_matches_plain(cuda, b):
    """B up to 128 take the weight stream in several row tiles; 320 (the
    beam-5 eval at 64 videos a batch) and 1344 (the CST rollout) the
    register tiles.  The gate launch is counted under its kernel."""
    args = [t.to(cuda) for t in _cell_inputs(b, b)]
    before = k2.fused_decode_cell.launches
    gate = k2.gate_geometry(b, E, H)["kernel"]
    gates = k2.fused_decode_cell.launches_by_gate[gate]
    c, h = k2.fused_decode_cell(*args)
    torch.cuda.synchronize()
    assert k2.fused_decode_cell.launches == before + 2
    assert k2.fused_decode_cell.launches_by_gate[gate] == gates + 1
    ref_c, ref_h = k2.decode_cell_plain(*args)
    assert (c - ref_c).abs().max().item() <= TOL
    assert (h - ref_h).abs().max().item() <= TOL


def test_decode_cell_kernel_matches_plain_at_the_chain_width(cuda):
    """E = H = A = 192, B = 160: the learning check's beam-5 eval (32
    videos x 5 beams)."""
    args = [a.to(cuda) for a in _cell_inputs(160, 5, e=192, h=192, a=192)]
    got = k2.fused_decode_cell(*args)
    torch.cuda.synchronize()
    assert _max_err(got, k2.decode_cell_plain(*args)) <= TOL


@pytest.mark.parametrize("t", [5, 6])
def test_kernels_match_plain_at_the_test_width(cuda, t):
    """E = H = A = 32: one gate cluster, one or two rows of K a warp."""
    args = [a.to(cuda) for a in _cell_inputs(6, 7, **dict(SMALL, t=t))]
    got = k2.fused_decode_cell(*args)
    torch.cuda.synchronize()
    assert _max_err(got, k2.decode_cell_plain(*args)) <= TOL
    att = args[3:7]
    got = k1.fused_additive_attention(*att)
    torch.cuda.synchronize()
    assert _max_err(got, k1.additive_attention_plain(*att)) <= TOL


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_kernels_are_batch_invariant_bitwise(cuda, kernel):
    """A row's outputs have the same bits run in a batch of 40, run alone,
    and run at another index of the batch."""
    b = 40
    args = [a.to(cuda) for a in _cell_inputs(b, 11)]
    if kernel == "K1":      # (q, proj_mem, memory | score_v)
        fn, args, per_row = k1.fused_additive_attention, args[3:7], 3
    else:                   # (x, c, h, q, proj_mem, memory | v, w, bias)
        fn, per_row = k2.fused_decode_cell, 6

    def rows(idx):
        return [a[idx].contiguous() if i < per_row else a
                for i, a in enumerate(args)]

    full = fn(*args)
    perm = torch.roll(torch.arange(b, device=cuda), 17)
    for out, moved in zip(full, fn(*rows(perm))):
        assert torch.equal(out[perm], moved)
    for r in (0, 13, 39):
        for out, alone in zip(full, fn(*rows(slice(r, r + 1)))):
            assert torch.equal(out[r:r + 1], alone)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, pm, mem, v = (a.to(cuda) for a in _attention_inputs(4, 0))
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_additive_attention(q, pm.transpose(1, 2).contiguous()
                                    .transpose(1, 2), mem, v)
    with pytest.raises(ValueError, match="several devices"):
        k1.fused_additive_attention(q.cpu(), pm, mem, v)
    with pytest.raises(TypeError, match="float32"):
        k1.fused_additive_attention(q.half(), pm, mem, v)
    with pytest.raises(ValueError, match="16-byte"):
        k1.fused_additive_attention(q, pm, mem, torch.empty(
            A + 1, device=cuda)[1:])
    args = [a.to(cuda) for a in _cell_inputs(2, 0, t=5, e=32, h=40, a=32)]
    with pytest.raises(ValueError, match="H % 16 == 0"):
        k2.fused_decode_cell(*args)


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["float32", "bfloat16"])
def test_gate_clusters_fit_in_one_wave(cuda, elem_bytes):
    """The card holds every gate cluster of the serving width at once (the
    weight stream's 16 clusters of 8 blocks; a second wave would read its
    weights late), in either storage dtype."""
    import ctypes

    from cst_captioning_tpu_torch.ops import _cuda

    n = ctypes.c_int(0)
    fn = _cuda.load("decode_cell", "decode_cell_gate_max_clusters")
    gate = k2.gate_geometry(8, E, H, elem_bytes)
    assert fn(E, H, elem_bytes, gate["variant"], ctypes.byref(n)) == 0
    assert n.value >= gate["column_tiles"]


def test_served_greedy_captions_equal_offline_on_card(cuda):
    model = CaptionModel(64, [32, 16], embed_size=32, hidden_size=32,
                         attn_size=32, decode_kernel="fused")
    init_random_(model, 0, eos_bias=0.3)
    model = model.eval().to(cuda)
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((6, 5, 32), dtype=np.float32),
             rng.standard_normal((6, 1, 16), dtype=np.float32)]
    reset_launch_counts()
    served = serve_decode_batch(model, [[f[i] for f in feats]
                                        for i in range(6)], 12,
                                decode_chunk=4, bucket_sizes=(1, 4))
    assert launch_counts()["fused_decode_cell"] > 0
    offline = greedy_decode(model, [torch.from_numpy(f).to(cuda)
                                    for f in feats], 12, decode_chunk=4)
    np.testing.assert_array_equal(np.stack(served), offline.cpu().numpy())


def test_attention_kernel_gradients_equal_plain_backward(cuda):
    """K1's autograd route at the training shapes (T=29, A=H=512, B=64):
    gradients through the kernel equal, bit for bit, the plain backward on
    the same inputs and upstream gradients (it recomputes from the
    inputs), and autograd through the plain forward within 1e-5 of the
    largest gradient (float32 sums in another order)."""
    inputs = [a.to(cuda) for a in _attention_inputs(64, 5)]
    g = torch.Generator().manual_seed(6)
    g_ctx = torch.randn(64, H, generator=g).to(cuda)
    g_w = torch.randn(64, T, generator=g).to(cuda)
    leaves = [a.clone().requires_grad_() for a in inputs]
    before = k1.fused_additive_attention.launches
    torch.autograd.backward(list(k1.fused_additive_attention(*leaves)),
                            [g_ctx, g_w])
    assert k1.fused_additive_attention.launches == before + 1
    want = k1.additive_attention_backward(*inputs, g_ctx, g_w)
    for leaf, grad in zip(leaves, want):
        assert torch.equal(leaf.grad, grad)
    plain = [a.clone().requires_grad_() for a in inputs]
    torch.autograd.backward(list(k1.additive_attention_plain(*plain)),
                            [g_ctx, g_w])
    for leaf, ref in zip(leaves, plain):
        scale = max(1.0, ref.grad.abs().max().item())
        assert (leaf.grad - ref.grad).abs().max().item() <= TOL * scale


def test_decode_cell_kernel_refuses_grad_mode(cuda):
    args = [t.to(cuda) for t in _cell_inputs(8, 2)]
    args[7].requires_grad_()
    with pytest.raises(RuntimeError, match="forward only"):
        k2.fused_decode_cell(*args)
    with torch.no_grad():
        c, h = k2.fused_decode_cell(*args)
    assert not c.requires_grad and torch.isfinite(h).all()


def test_full_width_xe_step_gradients_k1_on_and_off(cuda):
    """One XE step at full width (E=H=A=512, feats 28x2048 + 1x4096,
    V=7752, 8 videos x 20 captions, dropout on with the same masks): the
    parameter gradients with the decoder's attention on K1 equal those of
    the plain attention within 1e-5 of each tensor's largest gradient."""
    from cst_captioning_tpu_torch.ops.losses import cross_entropy_loss
    from cst_captioning_tpu_torch.weights import init_like_flax_

    rng = np.random.default_rng(0)
    feats = [torch.from_numpy(rng.standard_normal((8, 28, 2048),
                                                  dtype=np.float32)).to(cuda),
             torch.from_numpy(rng.standard_normal((8, 1, 4096),
                                                  dtype=np.float32)).to(cuda)]
    labels = torch.from_numpy(rng.integers(1, 7752, size=(160, 30))).to(cuda)
    labels[::3, 12:] = 0
    grads = {}
    for use_kernel in (True, False):
        model = CaptionModel(7752, [2048, 4096],
                             use_kernel_attention=use_kernel)
        init_like_flax_(model, torch.Generator().manual_seed(0))
        model.to(cuda)
        reset_launch_counts()
        logits = model(feats, labels, 20, train=True,
                       generator=torch.Generator(cuda).manual_seed(1))
        cross_entropy_loss(logits, labels).backward()
        assert launch_counts()["fused_additive_attention"] == (
            30 if use_kernel else 0)
        grads[use_kernel] = {n: p.grad for n, p in model.named_parameters()}
    for name, ref in grads[False].items():
        scale = max(1.0, ref.abs().max().item())
        assert (grads[True][name] - ref).abs().max().item() <= TOL * scale, \
            name


def _ciderd_world(device, seed=0, n_videos=64, n_refs=20, words=300):
    """Seeded references (some words outside the vocabulary) and their
    on-device CIDEr-D tables on ``device``."""
    from cst_captioning_tpu_torch.training.device_rewards import \
        build_device_tables

    rng = np.random.default_rng(seed)
    pool = [f"w{i}" for i in range(words)]
    w2i = {w: i + 1 for i, w in enumerate(pool[:words - 20])}
    refs = {f"v{v}": [" ".join(rng.choice(pool[:40 + v], int(
        rng.integers(3, 10)))) for _ in range(n_refs)]
        for v in range(n_videos)}
    return build_device_tables(refs, w2i, device=device)


def test_device_ciderd_on_card_equals_cpu(cuda):
    """The on-device CIDEr-D on the card against the same function on the
    CPU: 64 videos x 20 references, 1344 rows of 30 tokens (a rollout's
    shape), within 1e-6 relative; the chunked match equal to the one-shot
    within 1e-6 as well."""
    from cst_captioning_tpu_torch.ops.device_ciderd import ciderd_scores

    cpu, card = _ciderd_world("cpu"), _ciderd_world(cuda)
    for want, got in zip((*cpu[0], *cpu[1]), (*card[0], *card[1])):
        assert torch.equal(want, got.cpu())
    rng = np.random.default_rng(1)
    rows = rng.integers(1, 60, size=(1344, 30))
    for i, n in enumerate(rng.integers(0, 31, 1344)):
        rows[i, n:] = 0
    rows = torch.from_numpy(rows)
    vix = torch.from_numpy(rng.integers(0, 64, 1344))
    want = ciderd_scores(rows, vix, cpu[0], cpu[1])
    for chunk in (None, 3):
        got = ciderd_scores(rows.to(cuda), vix.to(cuda), card[0], card[1],
                            ref_chunk=chunk).cpu()
        assert got.dtype == torch.float32
        err = ((got - want).abs() / want.abs().clamp(min=1e-6)).max().item()
        assert err <= 1e-6, (chunk, err)
    assert (want > 0).sum() > 1000


def test_guarded_fused_step_on_nan_features_changes_nothing_on_card(cuda):
    """A guarded fused CST step with K1 and K2 on all-NaN features:
    ``bad_step`` 1 and every parameter, Adam moment and the count
    bit-identical to before the step (after one good step)."""
    from cst_captioning_tpu_torch.ops.sampling import gumbel_noise
    from cst_captioning_tpu_torch.training.state import Optimizer
    from cst_captioning_tpu_torch.training.steps import fused_cst_step

    corpus, tables, _ = _ciderd_world(cuda, n_videos=8, n_refs=5, words=60)
    model = CaptionModel(61, [16, 8], embed_size=32, hidden_size=32,
                         attn_size=32, use_kernel_attention=True,
                         decode_kernel="fused")
    init_random_(model, 0, eos_bias=1.0)
    model.to(cuda)
    opt = Optimizer(model.parameters(), learning_rate=1e-2, grad_clip=1.0)
    g = torch.Generator().manual_seed(2)
    feats = [torch.randn(4, 5, 16, generator=g).to(cuda),
             torch.randn(4, 1, 8, generator=g).to(cuda)]
    vix = torch.tensor([0, 3, 5, 7], device=cuda)
    noise = gumbel_noise(torch.Generator(cuda).manual_seed(3))
    good = fused_cst_step(model, opt, feats, vix, noise, corpus, tables, 12,
                          5, guard=True, decode_chunk=4)
    assert good["bad_step"].item() == 0.0
    before = ([p.detach().clone() for p in model.parameters()],
              [{k: v.clone() for k, v in st.items()} for st in opt.state],
              opt.count.clone())
    reset_launch_counts()
    bad = fused_cst_step(model, opt, [torch.full_like(f, float("nan"))
                                      for f in feats], vix, noise, corpus,
                         tables, 12, 5, guard=True, decode_chunk=4)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert bad["bad_step"].item() == 1.0
    assert counts["fused_decode_cell"] == 2 * int(bad["rollout_steps"])
    assert counts["fused_additive_attention"] == 12
    assert all(torch.equal(a, p.detach())
               for a, p in zip(before[0], model.parameters()))
    assert all(torch.equal(a[k], st[k])
               for a, st in zip(before[1], opt.state) for k in st)
    assert torch.equal(before[2], opt.count) and opt.count.item() == 1.0


def _bf16_ulp(ref):
    """One bfloat16 ulp at the magnitude of ``ref`` (its largest |value|):
    the kernels' tolerance in bfloat16 storage, since their float32 sums
    run in another order than the plain version's before the rounding."""
    return 2.0 ** (np.floor(np.log2(ref.float().abs().max().item())) - 7)


#: K2's tolerance in bfloat16, in ulps of the output's magnitude.  Its
#: float32 gate sums run in another order than cuBLAS's, so now and then
#: one rounds to the neighbouring bfloat16 value; the gate chain rounds
#: ten times after the sums, and where two such flips meet in one
#: element (a gate and the cell state) c' or h' moves by up to two ulps
#: of the magnitude (seen at B = 1344: 1.5).  K1 rounds once, at the end:
#: one ulp.
K2_BF16_ULPS = 2


def _bf16(args, keep_float=()):
    return [a if i in keep_float else a.to(torch.bfloat16)
            for i, a in enumerate(args)]


@pytest.mark.parametrize("b", [1, 8, 40, 1280])
def test_attention_kernel_bf16_matches_plain(cuda, b):
    """K1 in bfloat16 storage (score_v float32) against its plain version
    on the card, compared in bfloat16: within one bfloat16 ulp of each
    output's magnitude; one launch, counted under bfloat16."""
    args = _bf16([a.to(cuda) for a in _attention_inputs(b, b)],
                 keep_float=(3,))
    before = dict(k1.fused_additive_attention.launches_by_dtype)
    ctx, w = k1.fused_additive_attention(*args)
    torch.cuda.synchronize()
    after = k1.fused_additive_attention.launches_by_dtype
    assert after["bfloat16"] == before["bfloat16"] + 1
    assert after["float32"] == before["float32"]
    for got, want in zip((ctx, w), k1.additive_attention_plain(*args)):
        assert got.dtype == want.dtype == torch.bfloat16
        assert (got.float() - want.float()).abs().max().item() <= \
            _bf16_ulp(want)


@pytest.mark.parametrize("b", [1, 3, 8, 40, 64, 100, 320, 1344])
def test_decode_cell_kernel_bf16_matches_plain(cuda, b):
    """K2 in bfloat16 storage against its plain version on the card,
    compared in bfloat16: c' and h' within two bfloat16 ulps of their
    magnitude (K2_BF16_ULPS); B = 64, 100 and 1344 take several row groups
    and chunks."""
    args = _bf16([t.to(cuda) for t in _cell_inputs(b, b)], keep_float=(6,))
    before = k2.fused_decode_cell.launches_by_dtype["bfloat16"]
    c, h = k2.fused_decode_cell(*args)
    torch.cuda.synchronize()
    assert k2.fused_decode_cell.launches_by_dtype["bfloat16"] == before + 2
    for got, want in zip((c, h), k2.decode_cell_plain(*args)):
        assert got.dtype == want.dtype == torch.bfloat16
        assert (got.float() - want.float()).abs().max().item() <= \
            K2_BF16_ULPS * _bf16_ulp(want)


@pytest.mark.parametrize("t", [5, 6])
def test_kernels_bf16_match_plain_at_the_test_width(cuda, t):
    args = _bf16([a.to(cuda) for a in _cell_inputs(7, t, **dict(SMALL, t=t))],
                 keep_float=(6,))
    for got, want in ((k2.fused_decode_cell(*args),
                       k2.decode_cell_plain(*args)),
                      (k1.fused_additive_attention(*args[3:7]),
                       k1.additive_attention_plain(*args[3:7]))):
        for g, w in zip(got, want):
            assert (g.float() - w.float()).abs().max().item() <= \
                K2_BF16_ULPS * _bf16_ulp(w)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_kernels_bf16_are_batch_invariant_bitwise(cuda, kernel):
    """In bfloat16 storage too, a row's outputs have the same bits in a
    batch of 40, alone, and at another index of the batch."""
    b = 40
    args = _bf16([a.to(cuda) for a in _cell_inputs(b, 12)], keep_float=(6,))
    if kernel == "K1":
        fn, args, per_row = k1.fused_additive_attention, args[3:7], 3
    else:
        fn, per_row = k2.fused_decode_cell, 6

    def rows(idx):
        return [a[idx].contiguous() if i < per_row else a
                for i, a in enumerate(args)]

    full = fn(*args)
    perm = torch.roll(torch.arange(b, device=cuda), 17)
    for out, moved in zip(full, fn(*rows(perm))):
        assert torch.equal(out[perm], moved)
    for r in (0, 13, 39):
        for out, alone in zip(full, fn(*rows(slice(r, r + 1)))):
            assert torch.equal(out[r:r + 1], alone)


def test_attention_kernel_bf16_gradients_equal_plain_backward(cuda):
    """K1's autograd route in bfloat16 storage: the gradients through the
    kernel equal, bit for bit, the plain backward on the same inputs and
    upstream gradients, each in its input's dtype (score_v float32)."""
    inputs = _bf16([a.to(cuda) for a in _attention_inputs(64, 7)],
                   keep_float=(3,))
    g = torch.Generator().manual_seed(8)
    g_ctx = torch.randn(64, H, generator=g).to(cuda, torch.bfloat16)
    g_w = torch.randn(64, T, generator=g).to(cuda, torch.bfloat16)
    leaves = [a.clone().requires_grad_() for a in inputs]
    torch.autograd.backward(list(k1.fused_additive_attention(*leaves)),
                            [g_ctx, g_w])
    want = k1.additive_attention_backward(*inputs, g_ctx, g_w)
    for leaf, grad in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        assert torch.equal(leaf.grad, grad)


def test_cuda_wrappers_refuse_mixed_storage(cuda):
    """bfloat16 storage is all-or-nothing (score_v float32): a float32
    operand among bfloat16 ones, a bfloat16 score_v, or a half-precision
    storage is refused before anything launches."""
    q, pm, mem, v = (a.to(cuda) for a in _attention_inputs(4, 0))
    bq, bpm, bmem = (a.to(torch.bfloat16) for a in (q, pm, mem))
    with pytest.raises(TypeError, match="bfloat16"):
        k1.fused_additive_attention(q, bpm, bmem, v)
    with pytest.raises(TypeError, match="score_v"):
        k1.fused_additive_attention(bq, bpm, bmem, v.to(torch.bfloat16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k1.fused_additive_attention(q.half(), pm.half(), mem.half(), v)
    args = _bf16([a.to(cuda) for a in _cell_inputs(2, 0)], keep_float=(6,))
    args[7] = args[7].float()
    with pytest.raises(TypeError, match="w is torch.float32"):
        k2.fused_decode_cell(*args)


def _rows_of(args, idx, per_row=6):
    return [a[idx].contiguous() if i < per_row else a
            for i, a in enumerate(args)]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_decode_cell_is_batch_invariant_at_the_rollout_batch(cuda, storage):
    """At the CST rollout's 1344 rows (the register or tensor-core tiles)
    a row's outputs have the same bits moved to another index, alone (the
    weight stream), and inside batches of 8, 40 (the stream) and 320 (the
    tiles again): one summation tree for every batch and every kernel."""
    args = [a.to(cuda) for a in _cell_inputs(1344, 13)]
    if storage == "bfloat16":
        args = _bf16(args, keep_float=(6,))
    fn = k2.fused_decode_cell
    full = fn(*args)
    perm = torch.roll(torch.arange(1344, device=cuda), 517)
    for out, moved in zip(full, fn(*_rows_of(args, perm))):
        assert torch.equal(out[perm], moved)
    for r in (0, 700, 1343):
        for out, alone in zip(full, fn(*_rows_of(args, slice(r, r + 1)))):
            assert torch.equal(out[r:r + 1], alone)
    for lo, n in ((0, 8), (1336, 8), (600, 40), (1000, 320)):
        for out, part in zip(full, fn(*_rows_of(args, slice(lo, lo + n)))):
            assert torch.equal(out[lo:lo + n], part)
