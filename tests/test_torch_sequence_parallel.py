"""Sequence and context parallelism of the port
(``parallel/sequence.py``, ``parallel/cp.py``) against the JAX package's
ops on its 8-device CPU mesh with ``model_parallel=2`` and against full
attention on one rank, within 1e-5 (the ring against the combine within
1e-6: the merges run in another order, as the reference's own test
says); and the context-parallel transformer XE step against the port's
unsharded step and the reference's ``context_parallel_jit`` step (loss
within 1e-5, parameters within 2e-5, the reference test's bounds).

The port's ranks are spawned gloo processes: 2 ranks are a (1, 2) mesh,
4 ranks a (2, 2) one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.parallel.cp import (context_parallel_jit,
                                            time_shard_memory as jax_tsm)
from cst_captioning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cst_captioning_tpu.parallel.sequence import (
    _SM_CHECK_KW, shard_map, sp_additive_attention, sp_cross_attention_jit,
    sp_multihead_cross_attention)
from cst_captioning_tpu.training.state import create_train_state
from cst_captioning_tpu.training.steps import make_xe_step
from cst_captioning_tpu_torch.ops.attention_kernel import \
    additive_attention_plain
from cst_captioning_tpu_torch.parallel import Axis, TimeShard, make_mesh
from cst_captioning_tpu_torch.parallel import dryrun
from cst_captioning_tpu_torch.weights import from_flax

import torch_rank_bodies as bodies

TOL, RING_TOL, CP_LOSS_TOL, CP_PARAM_TOL = 1e-5, 1e-6, 1e-5, 2e-5


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(jax.devices()[:8], model_parallel=2)


def ref_attention(q, k, v, mask=None):
    """Full-T softmax attention on one device, float64."""
    s = np.einsum("bqd,btd->bqt", q, k) / np.sqrt(q.shape[-1])
    if mask is not None:
        s = np.where(mask[:, None, :], s, -1e30)
    w = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bqt,btd->bqd", w / w.sum(-1, keepdims=True), v)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    """The reference tests' shapes: a ragged T of 19 padded to 20 (row 0
    attends to the first shard's block only), 2 heads of 6, and the
    additive attention at T = 24 with its last step masked."""
    rng = np.random.default_rng(0)
    b, lq, t, d = 8, 5, 20, 16
    mask = np.zeros((b, t), bool)
    mask[:, :19] = True
    mask[0, :] = False
    mask[0, :4] = True
    amask = np.ones((b, 24), bool)
    amask[:, 23] = False
    return {"q": _rand(rng, b, lq, d), "k": _rand(rng, b, t, d),
            "v": _rand(rng, b, t, d), "mask": mask,
            "q4": _rand(rng, b, 4, 2, 6), "k4": _rand(rng, b, 16, 2, 6),
            "v4": _rand(rng, b, 16, 2, 6),
            "qp": _rand(rng, b, 10), "mem": _rand(rng, b, 24, 12),
            "pm": _rand(rng, b, 24, 10), "sv": _rand(rng, 10),
            "amask": amask}


def _jax_ops(jmesh, x):
    j = {k: jnp.asarray(v) for k, v in x.items()}
    out = {}
    for ring in (False, True):
        tag = "ring" if ring else "dot"
        fn = sp_cross_attention_jit(jmesh, ring=ring)
        out[tag] = fn(j["q"], j["k"], j["v"])
        out[f"{tag}_masked"] = fn(j["q"], j["k"], j["v"], j["mask"])
        out[f"multihead_{tag}"] = shard_map(
            lambda q, k, v, ring=ring: sp_multihead_cross_attention(
                q, k, v, axis_name="model", ring=ring),
            mesh=jmesh, in_specs=(P("data"), P("data", "model"),
                                  P("data", "model")),
            out_specs=P("data"), **({_SM_CHECK_KW: False} if ring else {})
        )(j["q4"], j["k4"], j["v4"])
    out["additive"] = shard_map(
        lambda qp, m, p, v, mk: sp_additive_attention(
            qp, m, p, v, axis_name="model", mask=mk),
        mesh=jmesh, in_specs=(P("data"), P("data", "model"),
                              P("data", "model"), P(), P("data", "model")),
        out_specs=P("data"))(j["qp"], j["mem"], j["pm"], j["sv"],
                             j["amask"])
    return {k: np.asarray(v) for k, v in out.items()}


def _full(x):
    """Each op on the whole T, one device."""
    out = {}
    for tag in ("dot", "ring"):
        out[tag] = ref_attention(x["q"], x["k"], x["v"])
        out[f"{tag}_masked"] = ref_attention(x["q"], x["k"], x["v"],
                                             x["mask"])
        out[f"multihead_{tag}"] = np.stack(
            [ref_attention(x["q4"][:, :, h], x["k4"][:, :, h],
                           x["v4"][:, :, h]) for h in range(2)], axis=2)
    s = np.einsum("bta,a->bt", np.tanh(x["pm"] + x["qp"][:, None, :]),
                  x["sv"])
    s = np.where(x["amask"], s, -1e30)
    w = np.exp(s - s.max(-1, keepdims=True))
    out["additive"] = np.einsum("bt,bth->bh", w / w.sum(-1, keepdims=True),
                                x["mem"])
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_sp_ops_match_the_reference_and_full_attention(jmesh, inputs, n):
    got = dryrun.run_ranks(n, bodies.sp_ops_rank, inputs, model_parallel=2)
    want_jax, want_full = _jax_ops(jmesh, inputs), _full(inputs)
    for r in got:           # every rank returns the global result
        assert r.keys() == want_full.keys()
        for k in want_full:
            np.testing.assert_allclose(r[k], want_full[k], atol=TOL,
                                       err_msg=k)
            np.testing.assert_allclose(r[k], want_jax[k], atol=TOL,
                                       err_msg=k)
        for k in ("", "_masked"):
            np.testing.assert_allclose(r[f"ring{k}"], r[f"dot{k}"],
                                       atol=RING_TOL)
        np.testing.assert_allclose(r["multihead_ring"], r["multihead_dot"],
                                   atol=RING_TOL)


def test_a_single_shard_axis_is_plain_attention(inputs):
    got = bodies.sp_ops_rank(make_mesh(), inputs)
    want = _full(inputs)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, err_msg=k)
    np.testing.assert_array_equal(got["ring"], got["dot"])


def test_sp_additive_equals_k1_plain_version_over_a_ragged_split(inputs):
    """The additive op over 2 ranks, the padded step masked, against
    K1's plain version on the 23 valid steps."""
    got = dryrun.run_ranks(2, bodies.sp_ops_rank, inputs,
                           model_parallel=2)[0]["additive"]
    x = {k: torch.from_numpy(inputs[k]) for k in ("qp", "mem", "pm", "sv")}
    want, _ = additive_attention_plain(x["qp"], x["pm"][:, :23],
                                       x["mem"][:, :23], x["sv"])
    np.testing.assert_allclose(got, want.numpy(), atol=TOL)


def test_time_shard_ranges_cover_the_memory_and_refuse_indivisible_t():
    blocks = []
    for r in range(2):
        ts = TimeShard(Axis("model", None, r, 2), (62, 2), (True, False))
        blocks.append(ts.ranges)
    assert blocks == [[(0, 32), (0, 0)], [(32, 62), (0, 2)]]
    for times in ((61, 3), (62, 1)):
        with pytest.raises(ValueError, match="multiples of 2"):
            TimeShard(Axis("model", None, 0, 2), times, (True, False))


CP = {"vocab": 40, "hidden": 16, "heads": 2, "layers": 1, "max_len": 6,
      "seq_per_img": 2, "feat_shapes": [(62, 12), (2, 6)]}


@pytest.fixture(scope="module")
def cp_reference(jmesh):
    """The reference's CP test: its unsharded and its
    ``context_parallel_jit`` XE steps (SGD 1e-2) from one state."""
    B, S, L = 8, CP["seq_per_img"], CP["max_len"]
    kw = dict(vocab_size=CP["vocab"], embed_size=CP["hidden"],
              hidden_size=CP["hidden"], attn_size=CP["hidden"],
              num_layers=1, use_attention=True, dropout_rate=0.0,
              decoder_type="transformer", num_heads=CP["heads"],
              num_tx_layers=CP["layers"], tx_max_len=L + 1)
    model_ref = JaxCaptionModel(**kw)
    model_cp = JaxCaptionModel(**kw, encode_constraint=jax_tsm(jmesh))
    tx = optax.sgd(1e-2)
    shapes = CP["feat_shapes"]
    state0 = create_train_state(model_ref, jax.random.PRNGKey(0), shapes, L,
                                S, tx, batch_size=B)
    rng = np.random.default_rng(7)
    feats = [rng.standard_normal((B,) + s).astype(np.float32)
             for s in shapes]
    labels = rng.integers(1, CP["vocab"], (B * S, L)).astype(np.int32)
    jf = [jnp.asarray(f) for f in feats]
    args = (jf, jnp.asarray(labels), jnp.ones((B * S,), jnp.float32),
            jax.random.PRNGKey(3))
    ref_state, ref_m = jax.jit(make_xe_step(model_ref, S))(state0, *args)
    cp_step = context_parallel_jit(make_xe_step(model_cp, S), jmesh,
                                   feats_time_sharded=(True, False),
                                   batch_argnums=(1, 2, 3))
    state0b = create_train_state(model_cp, jax.random.PRNGKey(0), shapes,
                                 L, S, tx, batch_size=B)
    cp_state, cp_m = cp_step(state0b, *args)

    def params(p):
        return {k: v.numpy() for k, v in from_flax(
            jax.tree_util.tree_map(np.asarray, p)).items()}

    x = {f"feats{m}": f for m, f in enumerate(feats)}
    x["labels"] = labels
    return {"params0": params(state0.params), "x": x,
            "ref": (float(ref_m["loss"]), params(ref_state.params)),
            "cp": (float(cp_m["loss"]), params(cp_state.params))}


def _close_step(got, want):
    loss, params = want
    np.testing.assert_allclose(got["loss"], loss, atol=CP_LOSS_TOL)
    assert got["params"].keys() == params.keys()
    for k in params:
        np.testing.assert_allclose(got["params"][k], params[k],
                                   atol=CP_PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_cp_transformer_step_matches_unsharded_and_reference(cp_reference,
                                                             n):
    args = (CP, cp_reference["params0"], cp_reference["x"], (True, False))
    plain = bodies.cp_xe_rank(make_mesh(), *args)
    _close_step(plain, cp_reference["ref"])
    got = dryrun.run_ranks(n, bodies.cp_xe_rank, *args, model_parallel=2)
    for r in got:
        _close_step(r, (plain["loss"], plain["params"]))
        _close_step(r, cp_reference["cp"])
        _close_step(r, cp_reference["ref"])
    for k in got[0]["params"]:   # every rank holds the same parameters
        for r in got[1:]:
            np.testing.assert_array_equal(r["params"][k],
                                          got[0]["params"][k])
