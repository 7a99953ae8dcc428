"""The port's on-device CIDEr-D (``ops/device_ciderd.py``) and its table
builder (``training/device_rewards.py``) against the reference's
``ops/jax_ciderd.py`` and ``training/device_rewards.py``.

Tolerances: hashes bit-identical; the tables array-equal, field by field
(``key1`` ... ``ref_mask``, the slot of every n-gram included); scores
within 1e-5 relative (atol 1e-6) of ``jax_ciderd.ciderd_scores`` (float32
on both sides, sums in another order) and within 1e-4 relative (atol
1e-5) of the port's float64 host scorer ``metrics/ciderd.py``; scores
with the match chunked over the references within 4 ULP (rtol 5e-7) of
the one-shot scores, and equal when the chunk covers every reference.
"""

import jax
import numpy as np
import pytest
import torch

from cst_captioning_tpu.ops import jax_ciderd
from cst_captioning_tpu.training import device_rewards as jax_builder
from cst_captioning_tpu_torch.metrics.ciderd import CiderD, build_corpus_df
from cst_captioning_tpu_torch.ops import device_ciderd
from cst_captioning_tpu_torch.training import device_rewards

WORDS = [f"w{i}" for i in range(40)]
W2I = {w: i + 1 for i, w in enumerate(WORDS)}
OOV = ["x0", "x1", "x2", "x3"]        # reference words outside the vocab


def make_refs(num_videos=10, max_refs=5, seed=0, oov=False, min_refs=1):
    rng = np.random.default_rng(seed)
    pool = WORDS + (OOV if oov else [])
    return {f"v{v}": [" ".join(rng.choice(pool, int(rng.integers(1, 10))))
                      for _ in range(int(rng.integers(min_refs,
                                                      max_refs + 1)))]
            for v in range(num_videos)}


def host_scores(refs, video_ids, rows):
    """The port's float64 host scorer on the decoded rows."""
    df, n = build_corpus_df(refs)
    scorer = CiderD(df_mode="corpus", df=df, ref_len=float(n))
    i2w = {i: w for w, i in W2I.items()}
    gts, res = {}, []
    for i, row in enumerate(rows):
        words = []
        for t in row:
            if t == 0:
                break
            words.append(i2w[int(t)])
        gts[str(i)] = list(refs[video_ids[i]])
        res.append({"image_id": str(i), "caption": [" ".join(words)]})
    return scorer.compute_score(gts, res)[1]


def both_tables(refs):
    return (jax_builder.build_device_tables(refs, W2I),
            device_rewards.build_device_tables(refs, W2I))


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_hash_is_the_reference_hash_bit_for_bit(order):
    ids = np.random.default_rng(order).integers(
        0, 2 ** 32, size=(500, order), dtype=np.int64)
    ids[0] = 0
    ids[1] = 2 ** 32 - 1
    want = jax_ciderd.hash_ngrams_np(ids, order)
    want_jnp = jax_ciderd.hash_ngrams_jnp(ids.astype(np.uint32), order)
    got_np = device_ciderd.hash_ngrams_np(ids, order)
    got_t = device_ciderd.hash_ngrams_torch(torch.from_numpy(ids), order)
    for w, wj, g, t in zip(want, want_jnp, got_np, got_t):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(np.asarray(wj), w)
        assert t.dtype == torch.int64 and int(t.min()) >= 0
        np.testing.assert_array_equal(t.numpy(), w.astype(np.int64))


@pytest.mark.parametrize("case", ["small", "oov", "twenty_refs"])
def test_tables_array_equal_reference(case):
    refs = {"small": make_refs(),
            "oov": make_refs(seed=1, oov=True),
            "twenty_refs": make_refs(num_videos=12, max_refs=20,
                                     min_refs=15, seed=2, oov=True)}[case]
    (jc, jt, jrow), (tc, tt, trow) = both_tables(refs)
    assert trow == jrow
    for want, got in ((jc, tc), (jt, tt)):
        for name in want._fields:
            w = np.asarray(getattr(want, name))
            g = getattr(got, name).numpy()
            assert g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert tc.key1.dtype == torch.int64 and tt.slot.dtype == torch.int32


def test_hash_table_growth_keeps_the_reference_slots(monkeypatch):
    """With the probe bound cut to 2 the first table overflows and both
    builders grow and rebuild: the grown tables still agree slot for
    slot."""
    monkeypatch.setattr(jax_builder, "PROBES", 2)
    monkeypatch.setattr(device_rewards, "PROBES", 2)
    refs = make_refs(num_videos=6, max_refs=4, seed=3)
    (jc, jt, _), (tc, tt, _) = both_tables(refs)
    n_keys = int(np.asarray(jc.occupied).sum())
    first = 1 << max(8, int(np.ceil(np.log2(n_keys * 2 + 1))))
    assert tc.key1.shape[0] > first          # it grew
    for name in jc._fields:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    np.testing.assert_array_equal(tt.slot.numpy(), np.asarray(jt.slot))


def _scores(rows, vix, tables_pair, ref_chunk=None):
    (jc, jt, _), (tc, tt, _) = tables_pair
    want = np.asarray(jax.jit(
        jax_ciderd.ciderd_scores, static_argnames=("sigma", "ref_chunk"))(
        rows.astype(np.int32), vix.astype(np.int32), jc, jt,
        ref_chunk=ref_chunk))
    got = device_ciderd.ciderd_scores(
        torch.from_numpy(rows), torch.from_numpy(vix), tc, tt,
        ref_chunk=ref_chunk)
    assert got.dtype == torch.float32 and got.shape == (len(rows),)
    return got.numpy(), want


def _encode(captions, length=12):
    rows = np.zeros((len(captions), length), np.int64)
    for i, c in enumerate(captions):
        ids = [W2I[w] for w in c.split() if w in W2I][:length]
        rows[i, :len(ids)] = ids
    return rows


@pytest.mark.parametrize("case", ["random", "references", "empty_and_repeats",
                                  "oov_refs"])
def test_scores_match_reference_and_host_scorer(case):
    refs = make_refs(seed=4, oov=case == "oov_refs")
    pair = both_tables(refs)
    vids = list(refs)
    rng = np.random.default_rng(5)
    if case == "references":
        video_ids = vids[:6]
        rows = _encode([refs[v][0] for v in video_ids])
    elif case == "empty_and_repeats":
        video_ids = vids[:4]
        rows = _encode(["", "w3 w3 w3 w3 w3 w3 w3", "w1 w2 w1 w2 w1 w2",
                        refs[vids[3]][0] + " " + refs[vids[3]][0]])
    else:
        video_ids = [vids[i] for i in rng.integers(0, len(vids), 16)]
        rows = _encode([" ".join(rng.choice(WORDS, int(rng.integers(1, 12))))
                        for _ in video_ids])
    vix = np.asarray([vids.index(v) for v in video_ids], np.int64)
    got, want = _scores(rows, vix, pair)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, host_scores(refs, video_ids, rows),
                               rtol=1e-4, atol=1e-5)
    if case == "references":
        assert (got > 0.0).all()       # a reference matches itself
    if case == "empty_and_repeats":
        assert got[0] == 0.0


def test_scores_fuzz_200_rows():
    """200 rows of random lengths (0 to the full row, so some rows have
    no EOS) against 20-reference videos."""
    refs = make_refs(num_videos=12, max_refs=20, min_refs=10, seed=6,
                     oov=True)
    pair = both_tables(refs)
    vids = list(refs)
    rng = np.random.default_rng(7)
    rows = np.zeros((200, 10), np.int64)
    for i in range(200):
        n = int(rng.integers(0, 11))
        rows[i, :n] = rng.integers(1, 12, n)   # a small word range: matches
    vix = rng.integers(0, len(vids), 200)
    got, want = _scores(rows, vix, pair)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, host_scores(refs, [vids[i] for i in vix], rows),
        rtol=1e-4, atol=1e-5)
    assert (got > 0).sum() > 100


@pytest.mark.parametrize("chunk", [1, 2, 3, "R", "R+5"])
def test_ref_chunk_within_4_ulp_of_one_shot(chunk):
    refs = make_refs(num_videos=8, max_refs=7, min_refs=3, seed=8)
    pair = both_tables(refs)
    r = pair[1][1].slot.shape[1]
    chunk = {"R": r, "R+5": r + 5}.get(chunk, chunk)
    rng = np.random.default_rng(9)
    rows = _encode([" ".join(rng.choice(WORDS[:12], int(rng.integers(1, 10))))
                    for _ in range(24)])
    vix = rng.integers(0, len(refs), 24)
    base, _ = _scores(rows, vix, pair)
    got, want = _scores(rows, vix, pair, ref_chunk=chunk)
    np.testing.assert_allclose(got, base, rtol=5e-7, atol=1e-8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if chunk >= r:
        np.testing.assert_array_equal(got, base)


def test_match_envelope_and_auto_chunk_match_reference():
    (_, jt, _), (_, tt, _) = both_tables(make_refs(max_refs=6, seed=10))
    total = device_ciderd.match_tensor_bytes(640, 30, tt)
    assert total == jax_ciderd.match_tensor_bytes(640, 30, jt) > 0
    for budget in (total, total // 2, total // 4, 1):
        assert (device_ciderd.auto_ref_chunk(640, 30, tt, budget)
                == jax_ciderd.auto_ref_chunk(640, 30, jt, budget))
    assert device_ciderd.auto_ref_chunk(640, 30, tt, total) is None


@pytest.mark.parametrize("width", [7, 255, 256, 600])
def test_count_last_counts_past_255(width):
    """The uint8 count reduces in slices of 255: no count wraps."""
    mask = torch.from_numpy(
        np.random.default_rng(width).random((3, 5, width)) < 0.9)
    got = device_ciderd._count_last(mask)
    assert got.dtype == torch.float32
    assert torch.equal(got, mask.sum(dim=-1).float())


def test_tables_on_the_cpu_by_default():
    """The builder puts the tables where it is told, the CPU by default."""
    (_, _, _), (tc, tt, _) = both_tables(make_refs(num_videos=3))
    assert all(t.device.type == "cpu" for t in (*tc, *tt))
