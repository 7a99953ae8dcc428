"""Data parallelism of the port (``cst_captioning_tpu_torch/parallel``)
against the JAX package's mesh: the grid, the row slices, and the
pipeline of ``parallel/dryrun.py`` at 2 and 4 gloo ranks against itself
at 1 rank, which in turn equals the reference's ``run_dp_pipeline(1)``
on the reference's weights.

The ranks are spawned processes in a gloo group over a ``FileStore``
(no port).  The tolerances are the reference's own test's
(``tests/test_real_model_mesh.py``): tokens bit for bit, losses within
1e-5 relative, parameters within 1e-4 relative (1e-6 absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cst_captioning_tpu.models as jax_models
from cst_captioning_tpu.parallel import host_local_slice as jax_slice
from cst_captioning_tpu.parallel import make_mesh as jax_make_mesh
from cst_captioning_tpu.parallel.dryrun import run_dp_pipeline as jax_pipeline
from cst_captioning_tpu.training.state import (create_train_state,
                                               make_optimizer)
from cst_captioning_tpu_torch.models.captioner import CaptionModel
from cst_captioning_tpu_torch.ops.losses import sequence_mask, token_logprobs
from cst_captioning_tpu_torch.parallel import (Axis, DataParallel, Mesh,
                                               distributed_init,
                                               host_local_slice, make_mesh,
                                               mesh_grid, shard_batch_arrays)
from cst_captioning_tpu_torch.parallel import dryrun
from cst_captioning_tpu_torch.weights import from_flax, init_like_flax_

import torch_rank_bodies as bodies

B = 8
RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6


def _assert_pipelines_equal(got, want):
    np.testing.assert_array_equal(got["sampled"], want["sampled"])
    np.testing.assert_array_equal(got["greedy"], want["greedy"])
    np.testing.assert_allclose(got["xe_losses"], want["xe_losses"],
                               rtol=RTOL)
    np.testing.assert_allclose(got["rl_loss"], want["rl_loss"], rtol=RTOL)
    np.testing.assert_allclose(got["fused_loss"], want["fused_loss"],
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got["fused_reward"], want["fused_reward"],
                               rtol=RTOL)
    assert got["params"].keys() == want["params"].keys()
    for k in want["params"]:
        np.testing.assert_allclose(got["params"][k], want["params"][k],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def one_rank():
    return dryrun.run_dp_pipeline(1, batch_size=B, xe_steps=2)


def test_mesh_grid_is_the_reference_make_mesh_grid():
    jmesh = jax_make_mesh(jax.devices()[:8], model_parallel=2)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    np.testing.assert_array_equal(mesh_grid(8, 2), ids)
    assert dict(jmesh.shape) == {"data": 4, "model": 2}
    for n, mp in ((6, 4), (8, 3)):
        with pytest.raises(ValueError):
            jax_make_mesh(jax.devices()[:n], model_parallel=mp)
        with pytest.raises(ValueError):
            mesh_grid(n, mp)


def test_ranks_sit_on_the_grid():
    got = dryrun.run_ranks(4, bodies.mesh_rank, model_parallel=2)
    grid = mesh_grid(4, 2)
    for r, m in enumerate(got):
        d, k = divmod(r, 2)
        assert m["coords"] == (d, k) and m["shape"] == {"data": 2,
                                                        "model": 2}
        assert m["data"] == list(grid[:, k])
        assert m["model"] == list(grid[d, :])
    one = bodies.mesh_rank(make_mesh())
    assert one["shape"] == {"data": 1, "model": 1} and one["coords"] == (0, 0)


@pytest.mark.parametrize("batch,index,count", [(32, 1, 4), (8, 0, 1),
                                               (12, 2, 3), (30, 0, 4)])
def test_host_local_slice_is_the_reference(batch, index, count):
    if batch % count:
        for fn in (jax_slice, host_local_slice):
            with pytest.raises(ValueError):
                fn(batch, index, count)
        return
    assert host_local_slice(batch, index, count) == jax_slice(batch, index,
                                                              count)


def test_shard_batch_arrays_keeps_videos_whole():
    """A rank's caption rows are its videos' rows (S per video)."""
    feats = np.arange(8)[:, None, None] * np.ones((8, 2, 3))
    caps = np.repeat(np.arange(8), 3)
    for r in range(2):
        mesh = Mesh(2, r, 1, Axis("data", None, r, 2),
                    Axis("model", None, 0, 1))
        f, c = shard_batch_arrays(mesh, [feats, caps])
        vids = list(range(4 * r, 4 * r + 4))
        assert [int(x) for x in f[:, 0, 0]] == vids
        assert [int(x) for x in c] == [v for v in vids for _ in range(3)]


def test_dp_pipeline_equals_one_rank(one_rank):
    """Two ranks (four: the ragged test below)."""
    n = 2
    got = dryrun.run_dp_pipeline(n, batch_size=B, xe_steps=2)
    want = one_rank
    assert got["mesh_shape"] == {"data": n, "model": 1}
    assert got["ranks_agree"] and got["garble_retries"] == 0
    _assert_pipelines_equal(got, want)
    assert got["sp_ctx_sum"] is not None and np.isfinite(got["sp_ctx_sum"])
    assert want["sp_ctx_sum"] is None
    assert all(np.isfinite(want["xe_losses"]))
    assert want["xe_losses"][-1] != want["xe_losses"][0]


def test_one_rank_equals_the_reference_pipeline(monkeypatch):
    """The reference's pipeline at one device with dropout off (the two
    stacks draw dropout masks from different generators: the port's own
    draws are held to world size 1 by ``test_dropout_draws_*``), on the
    reference's initial weights, with the reference's Gumbel draws fed to
    the port's rollouts."""
    real = jax_models.CaptionModel
    monkeypatch.setattr(jax_models, "CaptionModel",
                        lambda **kw: real(**{**kw, "dropout_rate": 0.0}))
    want = jax_pipeline(1, batch_size=B, xe_steps=2)
    S, L = dryrun.SEQ_PER_IMG, dryrun.MAX_LEN
    model = jax_models.CaptionModel(
        vocab_size=dryrun.VOCAB, embed_size=dryrun.HIDDEN,
        hidden_size=dryrun.HIDDEN, attn_size=dryrun.HIDDEN, num_layers=1,
        use_attention=True, dropout_rate=0.5)
    tx, _ = make_optimizer(learning_rate=1e-3, grad_clip=5.0)
    state = create_train_state(model, jax.random.PRNGKey(0),
                               dryrun.FEAT_SHAPES, L, S, tx, batch_size=B)
    params = {k: v.numpy() for k, v in from_flax(jax.tree_util.tree_map(
        np.asarray, state.params)).items()}

    def jax_noise():
        keys = jax.random.split(jax.random.PRNGKey(1), L)
        return lambda t, shape: torch.from_numpy(np.array(
            jax.random.gumbel(keys[t], tuple(shape), jnp.float32)))

    got = dryrun.run_dp_pipeline(1, batch_size=B, xe_steps=2,
                                 drop_prob=0.0, params=params,
                                 noise=jax_noise)
    want = dict(want, params={k: v.numpy() for k, v in from_flax(
        jax.tree_util.tree_map(np.asarray, want["params"])).items()})
    _assert_pipelines_equal(got, want)


def _local_means(labels, feats):
    """The loss DistributedDataParallel's default would report over 2
    ranks: the mean of each rank's own masked mean."""
    model = CaptionModel(dryrun.VOCAB, [d for _, d in dryrun.FEAT_SHAPES],
                         embed_size=dryrun.HIDDEN, hidden_size=dryrun.HIDDEN,
                         attn_size=dryrun.HIDDEN, drop_prob=0.0)
    init_like_flax_(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        lab = torch.from_numpy(labels).long()
        nll = -token_logprobs(model([torch.from_numpy(f) for f in feats],
                                    lab, dryrun.SEQ_PER_IMG), lab)
    mask = sequence_mask(lab)
    half = lab.shape[0] // 2
    means = [(nll[s] * mask[s]).sum() / mask[s].sum()
             for s in (slice(0, half), slice(half, None))]
    return float(sum(means) / 2), float((nll * mask).sum() / mask.sum()), [
        float(mask[s].sum()) for s in (slice(0, half), slice(half, None))]


def test_ragged_captions_take_the_global_denominator():
    """Caption lengths that differ across ranks, at four ranks with the
    rollouts' chunked early exit: the rank count changes nothing, while
    the average of the ranks' local means is a loss 10x the tolerance
    away."""
    kw = dict(batch_size=B, xe_steps=2, ragged=True, drop_prob=0.0,
              decode_chunk=3)
    one = dryrun.run_dp_pipeline(1, **kw)
    got = dryrun.run_dp_pipeline(4, **kw)
    assert got["ranks_agree"]
    _assert_pipelines_equal(got, one)
    assert got["fused_rollout_steps"] == one["fused_rollout_steps"]
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((B,) + s).astype(np.float32)
             for s in dryrun.FEAT_SHAPES]
    labels = dryrun.ragged_labels(rng, B * dryrun.SEQ_PER_IMG,
                                  dryrun.MAX_LEN, dryrun.VOCAB)
    local_means, global_mean, totals = _local_means(labels, feats)
    assert totals[0] != totals[1]
    np.testing.assert_allclose(one["xe_losses"][0], global_mean, rtol=RTOL)
    assert abs(local_means - global_mean) > 10 * RTOL * global_mean


def test_nan_rows_on_one_rank_make_every_rank_skip():
    for r in dryrun.run_ranks(2, bodies.guard_rank, 1):
        assert r == {"xe_bad": 1.0, "xe_unchanged": True, "fused_bad": 1.0,
                     "fused_unchanged": True}


@pytest.mark.parametrize("n", [2, 4])
def test_dropout_draws_equal_world_size_one(n):
    args = (8, 3, 5, 4, 11)
    want = bodies.dropout_rank(make_mesh(), *args)
    got = dryrun.run_ranks(n, bodies.dropout_rank, *args)
    assert want["memory"].shape == (8, 5, 4)
    assert want["noise0"].shape == (8 * 3 + 8, 11)
    for r in got:
        assert r.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(r[k], want[k], err_msg=k)


def test_a_host_flag_on_one_rank_reaches_every_rank():
    """Preemption: a signal on one rank stops every rank at the same
    step boundary."""
    assert dryrun.run_ranks(2, bodies.flag_rank, 1) == [[True, False]] * 2


def test_distributed_init_starts_no_group_for_one_process():
    assert distributed_init(None, 0, 0, device="cpu") is False
    assert distributed_init(None, 1, 0, device="cpu") is False
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed_init(None, 2, 0, device="cpu")
    with pytest.raises(ValueError, match="process_id"):
        distributed_init("127.0.0.1:1", 2, 2, device="cpu")
    dp = DataParallel()
    assert (dp.index, dp.count) == (0, 1)
    x = torch.arange(6.0)
    assert dp.mean(x) == x.mean() and dp.all_true(torch.tensor(True))
