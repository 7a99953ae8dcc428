"""The port's fused CST step (``steps.fused_cst_step``) and the guarded
update against the reference's ``make_fused_cst_step`` and
``_apply_gradients_guarded``; the train CLI's two CST paths.

Both sides draw with the same Gumbel noise (the reference's
``jax.random.gumbel`` arrays through the port's noise hook) and start from
the same weights (``weights.model_from_flax``).  Tolerances: sampled
tokens identical; per-row rewards, and the reward, baseline and advantage
means within 1e-5 (relative to max(1, |x|)); the loss, every gradient and
every updated parameter within 1e-5 * max(1, max|g|) of the reference's
(float32, sums in another order).  The update is SGD so that a parameter
moves by the rate times its gradient (Adam's first step, g / (|g| + eps),
would magnify the gradients' float32 rounding where |g| is near eps; the
optimizers are held to optax on identical gradients in
``test_torch_train_ops.py``).  A bad step leaves every tensor bit-identical.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.ops import jax_ciderd
from cst_captioning_tpu.ops import sampling as jsampling
from cst_captioning_tpu.ops.losses import reward_loss as jax_reward_loss
from cst_captioning_tpu.ops.losses import token_logprobs as jax_logprobs
from cst_captioning_tpu.training import device_rewards as jax_builder
from cst_captioning_tpu.training.state import TrainState, make_optimizer
from cst_captioning_tpu.training.steps import (_apply_gradients_guarded,
                                               make_fused_cst_step)
from cst_captioning_tpu_torch import train
from cst_captioning_tpu_torch.ops import device_ciderd
from cst_captioning_tpu_torch.training import device_rewards, steps
from cst_captioning_tpu_torch.training.state import Optimizer
from cst_captioning_tpu_torch.training.trainer import Trainer
from cst_captioning_tpu_torch.weights import from_flax, model_from_flax

WORDS = [f"w{i}" for i in range(14)]
W2I = {w: i + 1 for i, w in enumerate(WORDS)}
B, S, L, H = 4, 3, 8, 16
V = len(WORDS) + 1
FEAT_SHAPES = ((3, 8), (1, 5))
TOL = 1e-5
LR, CLIP = 0.05, 5.0


def _refs():
    rng = np.random.default_rng(2)
    return {f"v{v}": [" ".join(rng.choice(WORDS, int(rng.integers(2, 8))))
                      for _ in range(int(rng.integers(2, 6)))]
            for v in range(B + 2)}


@pytest.fixture(scope="module")
def world():
    refs = _refs()
    rng = np.random.default_rng(0)
    feats = [(rng.normal(size=(B,) + s) * 2.0).astype(np.float32)
             for s in FEAT_SHAPES]
    jm = JaxCaptionModel(vocab_size=V, embed_size=H, hidden_size=H,
                         attn_size=H, dropout_rate=0.0)
    params = jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats],
                     np.zeros((B, L), np.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["logit"]["bias"] = params["logit"]["bias"].copy()
    params["logit"]["bias"][0] += 1.0        # rows end at mixed lengths
    vix = np.asarray([5, 0, 3, 1], np.int64)  # not in video order
    return {"refs": refs, "feats": feats, "params": params, "vix": vix,
            "jax_tables": jax_builder.build_device_tables(refs, W2I),
            "tables": device_rewards.build_device_tables(refs, W2I)}


def jax_noise(rng, n):
    """The port's noise hook fed the reference's Gumbel draws."""
    keys = jax.random.split(rng, L)

    def noise(t, shape):
        assert tuple(shape) == (n, V)
        return torch.from_numpy(np.array(
            jax.random.gumbel(keys[t], tuple(shape), jnp.float32)))

    return noise


def _close(got, want, scale=1.0, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, scale), (err, tol * max(1.0, scale))


def _port_model(params, k1):
    return model_from_flax(params, device="cpu", use_kernel_attention=k1,
                           decode_kernel="fused" if k1 else "reference",
                           drop_prob=0.0)


@pytest.mark.parametrize("k1,chunk", [(True, 3), (False, 0)],
                         ids=["kernels-on-chunked", "kernels-off"])
@pytest.mark.parametrize("baseline", ["greedy", "scb-sample", "scb-gt"])
def test_fused_step_matches_reference(world, baseline, k1, chunk):
    params, feats, vix = world["params"], world["feats"], world["vix"]
    jc, jt, _ = world["jax_tables"]
    tc, tt, _ = world["tables"]
    scb = np.linspace(0.5, 2.0, B + 2).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jm = JaxCaptionModel(vocab_size=V, embed_size=H, hidden_size=H,
                         attn_size=H, dropout_rate=0.0,
                         use_pallas_attention=k1)
    jfeats = [jnp.asarray(f) for f in feats]
    tx, _ = make_optimizer("sgd", LR, CLIP)
    state = TrainState.create(apply_fn=jm.apply, params=params, tx=tx)
    fused = make_fused_cst_step(
        jm, L, S, jc, jt, baseline=baseline,
        scb_gt_baseline=jnp.asarray(scb) if baseline == "scb-gt" else None,
        guard=True, decode_chunk=chunk)
    new_state, jmet = jax.jit(fused)(state, jfeats, vix.astype(np.int32),
                                     key)

    # The reference's pieces, for the per-row and per-gradient checks.
    variables = {"params": params}
    if baseline == "greedy":
        jsampled, _, jgreedy = jsampling.sample_with_baseline(
            jm, variables, jfeats, key, L, seq_per_img=S,
            decode_chunk=chunk)
    else:
        jsampled, _ = jsampling.sample_captions(
            jm, variables, jfeats, key, L, seq_per_img=S, greedy=False,
            decode_chunk=chunk)
    jr = np.asarray(jax_ciderd.ciderd_scores(
        jsampled, np.repeat(vix, S).astype(np.int32), jc, jt))
    if baseline == "greedy":
        jbase = np.repeat(np.asarray(jax_ciderd.ciderd_scores(
            jgreedy, vix.astype(np.int32), jc, jt)), S)
    elif baseline == "scb-sample":
        per = jr.reshape(-1, S)
        jbase = ((per.sum(1, keepdims=True) - per) / (S - 1)).reshape(-1)
    else:
        jbase = np.repeat(scb[vix], S)
    jadv = (jr - jbase).astype(np.float32)

    def loss_fn(p):
        logits = jm.apply({"params": p}, jfeats, jsampled, S, train=False)
        return jax_reward_loss(jax_logprobs(logits, jsampled), jsampled,
                               jnp.asarray(jadv))

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)

    model = _port_model(params, k1)
    opt = Optimizer(model.parameters(), optim="sgd", learning_rate=LR,
                    grad_clip=CLIP)
    tfeats = [torch.from_numpy(f) for f in feats]
    n_rows = B * S + (B if baseline == "greedy" else 0)
    sampled, greedy, _ = steps.rollout(
        model, tfeats, L, S, jax_noise(key, n_rows),
        greedy_baseline=baseline == "greedy", decode_chunk=chunk)
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(jsampled))
    if baseline == "greedy":
        np.testing.assert_array_equal(greedy.numpy(), np.asarray(jgreedy))
    r = device_ciderd.ciderd_scores(
        sampled, torch.from_numpy(np.repeat(vix, S)), tc, tt)
    _close(r.numpy(), jr, float(np.abs(jr).max()))
    lengths = (np.asarray(jsampled) != 0).cumprod(axis=1).sum(axis=1)
    assert len(set(lengths.tolist())) > 1, "samples should end mixed"

    m = steps.fused_cst_step(
        model, opt, tfeats, torch.from_numpy(vix), jax_noise(key, n_rows),
        tc, tt, L, S, baseline=baseline,
        scb_gt_baseline=torch.from_numpy(scb) if baseline == "scb-gt"
        else None, guard=True, decode_chunk=chunk)
    for name in ("reward", "baseline", "advantage"):
        _close(m[name].item(), float(jmet[name]), abs(float(jmet[name])))
    assert m["bad_step"].item() == float(jmet["bad_step"]) == 0.0
    assert m["rollout_steps"].item() == float(jmet["rollout_steps"])
    _close(m["sample_len"].item(), float(jmet["sample_len"]))
    _close(m["loss"].item(), float(jmet["loss"]), abs(float(jloss)))
    _close(m["loss"].item(), float(jloss), abs(float(jloss)))
    _close(m["grad_norm"].item(), float(jmet["grad_norm"]),
           float(jmet["grad_norm"]))
    want_g = from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    want_p = from_flax(jax.tree_util.tree_map(np.asarray, new_state.params))
    for name, p in model.named_parameters():
        scale = float(np.abs(want_g[name].numpy()).max())
        _close(p.grad.numpy(), want_g[name].numpy(), scale)
        _close(p.detach().numpy(), want_p[name].numpy(), scale)


def test_fused_step_refuses_what_the_reference_refuses(world):
    tc, tt, _ = world["tables"]
    model = _port_model(world["params"], False)
    opt = Optimizer(model.parameters())
    args = (model, opt, [torch.from_numpy(f) for f in world["feats"]],
            torch.from_numpy(world["vix"]), None, tc, tt, L)
    with pytest.raises(ValueError, match="per-video baseline"):
        steps.fused_cst_step(*args, S, baseline="scb-gt")
    with pytest.raises(ValueError, match="seq_per_img >= 2"):
        steps.fused_cst_step(*args, 1, baseline="scb-sample")


def _snapshot(model, opt):
    return ([p.detach().clone() for p in model.parameters()],
            [{k: v.clone() for k, v in st.items()} for st in opt.state],
            opt.count.clone())


def _assert_unchanged(model, opt, snap):
    params, state, count = snap
    assert all(torch.equal(a, p.detach())
               for a, p in zip(params, model.parameters()))
    assert all(torch.equal(a[k], st[k]) for a, st in zip(state, opt.state)
               for k in st)
    assert torch.equal(count, opt.count)


def test_fused_step_on_nan_features_changes_nothing(world):
    """All-NaN features through a guarded fused step: ``bad_step`` 1 and
    every parameter, Adam moment and the count bit-identical."""
    tc, tt, _ = world["tables"]
    model = _port_model(world["params"], True)
    opt = Optimizer(model.parameters(), learning_rate=1e-2, grad_clip=CLIP)
    feats = [torch.from_numpy(f) for f in world["feats"]]
    noise = jax_noise(jax.random.PRNGKey(1), B * S + B)
    steps.fused_cst_step(model, opt, feats, torch.from_numpy(world["vix"]),
                         noise, tc, tt, L, S, guard=True)   # a good step
    snap = _snapshot(model, opt)
    m = steps.fused_cst_step(
        model, opt, [torch.full_like(f, float("nan")) for f in feats],
        torch.from_numpy(world["vix"]), noise, tc, tt, L, S, guard=True)
    assert m["bad_step"].item() == 1.0
    assert not np.isfinite(m["loss"].item())
    _assert_unchanged(model, opt, snap)
    assert opt.count.item() == 1.0


@pytest.mark.parametrize("optim", ["adam", "adagrad"])
def test_guarded_update_on_nan_matches_reference(optim):
    """One good step, then NaN gradients and loss: the reference's
    ``_apply_gradients_guarded`` and the port's keep the parameters, the
    optimizer state and its counts, and report ``bad_step`` 1."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx, _ = make_optimizer(optim, 1e-2, 1.0, 0.5, 2)
    state = TrainState.create(apply_fn=None, params=[jnp.asarray(p)
                                                     for p in init], tx=tx)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = Optimizer(params, optim=optim, learning_rate=1e-2, grad_clip=1.0,
                    decay_rate=0.5, decay_every_steps=2)

    def port_step(gs, loss):
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g.copy())
        return steps.apply_gradients_guarded(opt, torch.tensor(loss), True)

    state, jm = _apply_gradients_guarded(
        state, [jnp.asarray(g) for g in grads], jnp.float32(1.5), True)
    m = port_step(grads, 1.5)
    assert float(jm["bad_step"]) == m["bad_step"].item() == 0.0
    before = ([p.detach().clone() for p in params],
              [{k: v.clone() for k, v in st.items()} for st in opt.state],
              opt.count.clone())
    nan = [np.full(s, np.nan, np.float32) for s in shapes]
    new_state, jm = _apply_gradients_guarded(
        state, [jnp.asarray(g) for g in nan], jnp.float32(np.nan), True)
    m = port_step(nan, float("nan"))
    assert float(jm["bad_step"]) == m["bad_step"].item() == 1.0
    assert int(new_state.step) == int(state.step) + 1   # the step counts
    for a, b in zip(jax.tree_util.tree_leaves((new_state.params,
                                               new_state.opt_state)),
                    jax.tree_util.tree_leaves((state.params,
                                               state.opt_state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    counts = [int(x) for x in jax.tree_util.tree_leaves(new_state.opt_state)
              if np.ndim(x) == 0]
    assert opt.count.item() == 1.0 and counts and set(counts) == {1}
    assert all(torch.equal(a, p.detach()) for a, p in zip(before[0], params))
    assert all(torch.equal(a[k], st[k]) for a, st in zip(before[1], opt.state)
               for k in st)
    for p, jp in zip(params, new_state.params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=0, atol=1e-6)


def test_good_guarded_step_is_bit_identical_to_unguarded(world):
    """Three XE steps with the guard on and three with it off, from the
    same weights and masks: every parameter and Adam moment bit-equal."""
    out = []
    rng = np.random.default_rng(3)
    labels = torch.from_numpy(rng.integers(1, V, size=(B * S, L)))
    weights = torch.from_numpy(rng.uniform(0.5, 1.5, B * S)
                               .astype(np.float32))
    for guard in (True, False):
        model = _port_model(world["params"], True)
        model.drop_prob = model.encoder.drop_prob = model.cell.drop_prob = 0.3
        opt = Optimizer(model.parameters(), learning_rate=1e-2,
                        grad_clip=1.0)
        gen = torch.Generator().manual_seed(0)
        for _ in range(3):
            m = steps.xe_step(model, opt,
                              [torch.from_numpy(f) for f in world["feats"]],
                              labels, weights, S, gen, guard=guard)
        assert ("bad_step" in m) == guard
        out.append(_snapshot(model, opt))
    (p1, s1, c1), (p2, s2, c2) = out
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(s1, s2) for k in a)
    assert torch.equal(c1, c2) and c1.item() == 3.0


# -- the train CLI's two CST paths on the CPU --------------------------------

BASE = ["--device", "cpu", "--synthetic_videos", "12",
        "--synthetic_val_videos", "5", "--captions_per_video", "5",
        "--feat_shapes", "3x8,1x5", "--rnn_size", "16",
        "--input_encoding_size", "16", "--att_size", "16",
        "--batch_size", "4", "--seq_per_img", "5", "--max_length", "8",
        "--decode_chunk", "3", "--log_every", "1", "--pallas_attention", "1",
        "--decode_kernel", "fused"]
TINY = BASE + ["--use_rl", "1", "--max_epochs", "2"]


def _run(argv, capsys):
    assert train.main(TINY + argv) == 0
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("extra", [
    ["--device_rewards", "1"],
    ["--device_rewards", "1", "--device_feats", "1",
     "--rl_baseline", "scb-gt"],
    ["--device_rewards", "0", "--overlap_rewards", "2"],
    ["--device_rewards", "0", "--overlap_rewards", "0",
     "--rl_baseline", "scb-sample"]],
    ids=["fused", "fused-device-feats-scb-gt", "host-depth2",
         "host-serial-scb-sample"])
def test_cli_runs_cst_on_both_paths(tmp_path, capsys, extra):
    out, _ = _run(["--checkpoint_path", str(tmp_path)] + extra, capsys)
    assert out["last_step"] == 6 and out["best_score"] >= 0.0


def test_trainer_builds_the_path_it_is_asked_for(tmp_path):
    fused = Trainer(train.parse_args(TINY))
    assert fused.pipeline is None and fused.reward_computer is None
    setup = fused.reward_setup
    assert setup["ref_chunk"] is None and setup["table_bytes"] > 0
    assert setup["envelope_bytes"] == device_ciderd.match_tensor_bytes(
        20, 8, fused.fused["tables"])
    host = Trainer(train.parse_args(TINY + ["--device_rewards", "0"]))
    assert host.fused is None and host.pipeline.depth == 2
    tight = Trainer(train.parse_args(TINY + ["--device_cider_chunk_mb",
                                             "0.0001"]))
    assert tight.reward_setup["ref_chunk"] == 1
    # One host-path dispatch per iteration; depth 2 completes the first
    # step on the third push, and drain completes the rest.
    done = [len(host.iteration()) for _ in range(3)]
    assert done == [0, 0, 1] and len(host.drain()) == 2


def test_overlap_flag_warns_once_under_device_rewards(capsys):
    train.parse_args(TINY + ["--overlap_rewards", "1"])
    assert capsys.readouterr().err.count("--overlap_rewards is ignored") == 1
    train.parse_args(TINY + ["--device_rewards", "0", "--overlap_rewards",
                             "1"])
    train.parse_args(TINY)
    assert "ignored" not in capsys.readouterr().err


def test_device_feats_budget_refuses(tmp_path):
    with pytest.raises(ValueError, match="device_feats_max_gb"):
        Trainer(train.parse_args(TINY + ["--device_feats", "1",
                                         "--device_feats_max_gb", "1e-9"]))


def test_divergence_rolls_back_then_gives_up(tmp_path, monkeypatch):
    """XE with NaN consensus weights from epoch 2 (step 3) on: the guard
    skips the steps on the device, rolls back to the epoch-1 snapshot
    after 2 bad steps in a row, replays on re-seeded noise (salt 1), and
    raises once its one rollback is spent.  Every replayed step was
    skipped, so the state is still the snapshot's, bit for bit."""
    from cst_captioning_tpu_torch.resilience.guard import \
        DivergenceUnrecoverable

    trainer = Trainer(train.parse_args(
        BASE + ["--max_epochs", "4", "--divergence_max_bad", "2",
                "--divergence_max_rollbacks", "1",
                "--checkpoint_path", str(tmp_path)]))
    real = trainer.loader.next_batch

    def batch():
        b = real()
        if trainer.step >= 3:
            b.weights = np.full_like(b.weights, np.nan)
        return b

    monkeypatch.setattr(trainer.loader, "next_batch", batch)
    with pytest.raises(DivergenceUnrecoverable):
        trainer.train()
    assert trainer.guard.rollbacks == 2 and trainer.guard.total_skipped == 4
    assert trainer._rng_salt == 1
    good_step, model_state, opt_state = trainer._good_state
    assert good_step == 3 and trainer.optimizer.count.item() == 3.0
    for name, p in trainer.model.state_dict().items():
        assert torch.equal(p, model_state[name]), name
    for st, saved in zip(trainer.optimizer.state, opt_state["state"]):
        assert all(torch.equal(st[k], saved[k]) for k in st)


def test_stage_chain_picks_the_cst_reward_path():
    """``tools/stage_chain.py --cst_device_rewards``: the CST stage's
    argv runs the fused path (1, the default) or the host pipeline (0),
    each into its own directory; ``--use_bfloat16 1`` runs it in bfloat16
    with the features resident on the device, as the reference's chain."""
    from cst_captioning_tpu_torch.tools.stage_chain import stage_argv

    fused = stage_argv("out", use_bfloat16=1)["cst"]
    host = stage_argv("out", use_bfloat16=1, cst_device_rewards=0)["cst"]
    assert train.parse_args(fused).device_rewards == 1
    assert train.parse_args(host).device_rewards == 0
    for argv in (fused, host):
        opt = train.parse_args(argv)
        assert (opt.use_bfloat16, opt.bf16_feats, opt.device_feats) == (
            1, None, 1)
    assert train.parse_args(stage_argv("out")["cst"]).use_bfloat16 == 0
    dirs = [a[a.index("--checkpoint_path") + 1] for a in (fused, host)]
    assert dirs[1] == dirs[0] + "_host"


def test_fused_setup_refuses_a_video_without_references():
    from cst_captioning_tpu_torch.training.trainer import build_splits

    opt = train.parse_args(TINY)
    splits = build_splits(opt)
    del splits[0].refs[splits[0].video_ids[3]]
    with pytest.raises(ValueError, match="no reference captions"):
        Trainer(opt, splits)


def test_optimizer_state_round_trips_through_a_checkpoint(tmp_path):
    """``last.pt`` holds the optimizer's count and moments; loading them
    into a fresh optimizer restores every tensor."""
    from cst_captioning_tpu_torch.training import checkpoint

    trainer = Trainer(train.parse_args(BASE + ["--optim", "adamw"]))
    for _ in range(2):
        trainer.iteration()
    checkpoint.save(str(tmp_path), checkpoint.LAST,
                    trainer.checkpoint_payload(0.0, 0.0))
    fresh = Optimizer(trainer.model.parameters(), optim="adamw")
    fresh.load_state_dict(checkpoint.load(str(tmp_path),
                                          checkpoint.LAST)["optimizer"])
    assert fresh.count.item() == 2.0
    for a, b in zip(fresh.state, trainer.optimizer.state):
        assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="adamw"):
        Optimizer(trainer.model.parameters()).load_state_dict(
            trainer.optimizer.state_dict())
