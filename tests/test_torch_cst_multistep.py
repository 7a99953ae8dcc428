"""The port's CST over one epoch of Adam steps against the reference's,
on the CPU: the mechanics that one step cannot show (Adam's moments and
step count, the staircase schedule, the loader's batch order, a rollout
key per step) held step by step.

Per step the reference runs ``make_fused_cst_step`` (guard on) over a
``TrainState`` with ``make_optimizer("adam", ...)``, clip 10 and a
staircase schedule that decays twice inside the epoch, on the batches of
its own ``CaptionLoader`` (synthetic split written to HDF5); its rollout
key for step k is ``fold_in(base, k)``, as ``Trainer._rollout_rng``
makes it.  The port runs ``steps.fused_cst_step`` with its ``Optimizer``
on the batches of its own loader, and draws the reference's Gumbel noise
of that key through the noise hook.  Both start from one parameter tree
(``weights.model_from_flax``).

After every step, float32 (12 steps, one epoch, decays after steps 5
and 10): sampled tokens identical; reward, baseline, advantage, loss and
gradient norm within 1e-5 of max(1, |x|); the learning rate and the step
count equal; every parameter and both Adam moments within
1e-5 * max(1, max|x|) of the reference's (the one-step test's bound).

bfloat16 (the reference op by op, as ``test_torch_bf16.py`` runs it;
three steps with a decay after each of the first two, since op by op the
reference takes tens of seconds a step on a CPU): tokens identical; the
reward, baseline and advantage within 1e-5; the loss within 1e-2
relative; the learning rate and step count equal.  Adam's step is about
the rate times the sign of the gradient, so an entry near 0 that the two
backwards round to opposite signs moves by twice the rate: the gradients
are held through Adam's moments instead, mu and sqrt(nu) each within the
gradient tolerance of ``test_torch_bf16.py`` (2e-2 of the largest), and
the port goes on from the reference's parameters after each step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.data import synthetic as jsynthetic
from cst_captioning_tpu.data.dataset import CaptionDataset
from cst_captioning_tpu.data.loader import CaptionLoader as JaxLoader
from cst_captioning_tpu.metrics.tokenizer import \
    tokenize_corpus as jax_tokenize
from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.ops import sampling as jsampling
from cst_captioning_tpu.training import device_rewards as jrewards
from cst_captioning_tpu.training.state import TrainState, make_optimizer
from cst_captioning_tpu.training.steps import make_fused_cst_step
from cst_captioning_tpu_torch import train
from cst_captioning_tpu_torch.data import synthetic
from cst_captioning_tpu_torch.data.loader import CaptionLoader
from cst_captioning_tpu_torch.metrics.tokenizer import tokenize_corpus
from cst_captioning_tpu_torch.training import device_rewards, steps
from cst_captioning_tpu_torch.training.state import Optimizer
from cst_captioning_tpu_torch.training.trainer import Trainer
from cst_captioning_tpu_torch.weights import from_flax, model_from_flax

B, S, L, H = 4, 3, 8, 16
VIDEOS = 48                       # one epoch = 12 steps at B = 4
STEPS = VIDEOS // B
SPEC = dict(num_videos=VIDEOS, captions_per_video=5, max_len=L,
            feat_dims=(8, 5), feat_times=(3, 1), seed=0, rich_vocab=0)
SEED = 123
LR, CLIP, DECAY_RATE, DECAY_EVERY = 5e-3, 10.0, 0.8, 5   # decays at 5, 10
CHUNK = 3
TOL = 1e-5
LOSS_REL, UPDATE_REL = 1e-2, 2e-2    # bfloat16, as test_torch_bf16.py


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The reference's train split (HDF5) and loader inputs, the port's
    split, and both sides' reward tables in dataset video order."""
    root = tmp_path_factory.mktemp("cst_multistep")
    paths = jsynthetic.generate(str(root), "train",
                                jsynthetic.SyntheticSpec(**SPEC))
    ours = synthetic.generate("train", synthetic.SyntheticSpec(**SPEC),
                              consensus=False)
    with CaptionDataset(jsynthetic.split_paths(paths)) as ds:
        jrefs = jax_tokenize(ds.references())
        jrefs = {v: jrefs[v] for v in ds.video_ids}
        jtables = jrewards.build_device_tables(jrefs, ds.vocab.word_to_ix)
        split_paths = jsynthetic.split_paths(paths)
    refs = tokenize_corpus(ours.refs)
    refs = {v: refs[v] for v in ours.video_ids}
    tables = device_rewards.build_device_tables(refs, ours.vocab.word_to_ix,
                                                device="cpu")
    return {"split_paths": split_paths, "ours": ours, "jtables": jtables,
            "tables": tables}


def _noise(key, n, v, dtype):
    """The port's noise hook fed the reference's Gumbel draws of ``key``
    (in bfloat16 for a bfloat16 model, as ``jax.random.categorical``
    draws them on bfloat16 logits)."""
    keys = jax.random.split(key, L)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def noise(t, shape):
        assert tuple(shape) == (n, v)
        g = jax.random.gumbel(keys[t], tuple(shape), jdt)
        return torch.from_numpy(np.array(g.astype(jnp.float32))).to(dtype)

    return noise


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` inside the clip -> adam chain."""
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf
    raise AssertionError("no Adam state in the chain")


def _close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)
    return err


def _run(data, baseline, k1, bf16, n_steps=STEPS, decay_every=DECAY_EVERY):
    """Drive both sides over one epoch; -> per-step max errors."""
    ours = data["ours"]
    v = ours.vocab.size_with_pad
    jdtype = jnp.bfloat16 if bf16 else jnp.float32
    tdtype = torch.bfloat16 if bf16 else torch.float32
    feats0 = [np.zeros((B,) + s, np.float32)
              for s in zip(SPEC["feat_times"], SPEC["feat_dims"])]
    jm = JaxCaptionModel(vocab_size=v, embed_size=H, hidden_size=H,
                         attn_size=H, dropout_rate=0.0, dtype=jdtype,
                         use_pallas_attention=k1 and not bf16)
    params = jm.init(jax.random.PRNGKey(0),
                     [jnp.asarray(f) for f in feats0],
                     np.zeros((B * S, L), np.int32), S)["params"]
    params = jax.tree_util.tree_map(np.array, params)
    params["logit"]["bias"][0] += 1.0        # rows end at mixed lengths
    tx, sched = make_optimizer("adam", LR, CLIP, DECAY_RATE, decay_every)
    state = TrainState.create(apply_fn=jm.apply, params=params, tx=tx)
    jc, jt, _ = data["jtables"]
    fused = make_fused_cst_step(jm, L, S, jc, jt, baseline=baseline,
                                guard=True, decode_chunk=CHUNK)
    greedy = baseline == "greedy"
    if greedy:
        def sample(p, f, key):
            return jsampling.sample_with_baseline(
                jm, {"params": p}, f, key, L, seq_per_img=S,
                decode_chunk=CHUNK)[0]
    else:
        def sample(p, f, key):
            return jsampling.sample_captions(
                jm, {"params": p}, f, key, L, seq_per_img=S, greedy=False,
                decode_chunk=CHUNK)[0]
    if not bf16:
        fused, sample = jax.jit(fused), jax.jit(sample)

    model = model_from_flax(params, device="cpu", dtype=tdtype,
                            use_kernel_attention=k1,
                            decode_kernel="fused" if k1 else "reference",
                            drop_prob=0.0)
    opt = Optimizer(model.parameters(), optim="adam", learning_rate=LR,
                    grad_clip=CLIP, decay_rate=DECAY_RATE,
                    decay_every_steps=decay_every)
    tc, tt, _ = data["tables"]
    loader = CaptionLoader(ours, B, seq_per_img=S, seed=SEED)
    base = jax.random.split(jax.random.PRNGKey(SEED))[1]
    n_rows = B * S + (B if greedy else 0)
    errors, lrs, lengths = [], [], set()
    with CaptionDataset(data["split_paths"]) as ds:
        jloader = JaxLoader(ds, batch_size=B, seq_per_img=S, seed=SEED)
        assert jloader.batches_per_epoch == loader.batches_per_epoch == STEPS
        for k in range(n_steps):
            jb, tb = jloader.next_batch(), loader.next_batch()
            np.testing.assert_array_equal(tb.video_ix, jb.video_ix)
            key = jax.random.fold_in(base, k)
            jfeats = [jnp.asarray(f) for f in jb.feats]
            tfeats = [torch.from_numpy(f).to(tdtype) if bf16
                      else torch.from_numpy(f) for f in tb.feats]
            vix = jb.video_ix.astype(np.int32)

            if bf16:
                with jax.disable_jit():
                    jsampled = sample(state.params, jfeats, key)
                    new_state, jmet = fused(state, jfeats, vix, key)
            else:
                jsampled = sample(state.params, jfeats, key)
                new_state, jmet = fused(state, jfeats, vix, key)
            with torch.no_grad():
                sampled, _, _ = steps.rollout(
                    model, tfeats, L, S, _noise(key, n_rows, v, tdtype),
                    greedy_baseline=greedy, decode_chunk=CHUNK)
            np.testing.assert_array_equal(sampled.numpy(),
                                          np.asarray(jsampled),
                                          err_msg=f"step {k}")
            lengths.update(
                (np.asarray(jsampled) != 0).cumprod(1).sum(1).tolist())
            m = steps.fused_cst_step(
                model, opt, tfeats, torch.from_numpy(tb.video_ix),
                _noise(key, n_rows, v, tdtype), tc, tt, L, S,
                baseline=baseline, guard=True, decode_chunk=CHUNK)
            err = {}
            assert m["bad_step"].item() == float(jmet["bad_step"]) == 0.0
            for name in ("reward", "baseline", "advantage"):
                err[name] = _close(m[name].item(), float(jmet[name]),
                                   what=(k, name))
            if bf16:
                assert abs(m["loss"].item() - float(jmet["loss"])) <= \
                    LOSS_REL * abs(float(jmet["loss"])), (k, "loss")
            else:
                for name in ("loss", "grad_norm"):
                    err[name] = _close(m[name].item(), float(jmet[name]),
                                       what=(k, name))
            # The schedule and the step count.
            adam = _adam_state(new_state.opt_state)
            assert int(adam.count) == int(opt.count.item()) == k + 1
            assert opt.current_lr() == float(np.float32(sched(k))), k
            lrs.append(opt.current_lr())
            want_p = from_flax(jax.tree_util.tree_map(np.asarray,
                                                      new_state.params))
            mu = from_flax(jax.tree_util.tree_map(np.asarray, adam.mu))
            nu = from_flax(jax.tree_util.tree_map(np.asarray, adam.nu))
            if bf16:
                # mu is the gradients' running mean, sqrt(nu) their running
                # RMS (module docstring).
                for name, got, want in (
                        ("mu", [st["mu"] for st in opt.state],
                         [mu[n] for n, _ in model.named_parameters()]),
                        ("rms", [st["nu"].sqrt() for st in opt.state],
                         [nu[n].sqrt() for n, _ in
                          model.named_parameters()])):
                    largest = max(float(w.abs().max()) for w in want)
                    assert largest > 0
                    err[name] = max(float((g - w).abs().max())
                                    for g, w in zip(got, want)) / largest
                    assert err[name] <= UPDATE_REL, (k, name, err[name])
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        p.copy_(want_p[n])
            else:
                for (n, p), st in zip(model.named_parameters(), opt.state):
                    err[f"p:{n}"] = _close(p.detach().numpy(),
                                           want_p[n].numpy(), what=(k, n))
                    err[f"mu:{n}"] = _close(st["mu"].numpy(),
                                            mu[n].numpy(), what=(k, n, "mu"))
                    err[f"nu:{n}"] = _close(st["nu"].numpy(),
                                            nu[n].numpy(), what=(k, n, "nu"))
            errors.append(err)
            state = new_state
    # The schedule decayed twice inside the epoch, and the samples ended
    # at mixed lengths.
    assert len(set(lrs)) == 3, lrs
    assert len(lengths) > 1
    return errors


@pytest.mark.parametrize("baseline,k1", [("scb-sample", True),
                                         ("greedy", False)],
                         ids=["scb-sample-kernels", "greedy-reference-cell"])
def test_cst_epoch_matches_reference_float32(data, baseline, k1):
    errors = _run(data, baseline, k1, bf16=False)
    assert len(errors) == STEPS


def test_cst_steps_match_reference_bfloat16(data):
    errors = _run(data, "scb-sample", True, bf16=True, n_steps=3,
                  decay_every=1)
    assert len(errors) == 3


def test_trainer_decay_count_equals_the_reference(tmp_path):
    """``--learning_rate_decay_every`` epochs in updates, at the chain's
    settings (512 videos, batch 32): the port's ``Trainer`` against the
    count the reference's trainer builds (``decay_every * bpe`` of its
    loader)."""
    spec = dict(SPEC, num_videos=512, feat_dims=(4, 3), feat_times=(2, 1))
    paths = jsynthetic.generate(str(tmp_path), "train",
                                jsynthetic.SyntheticSpec(**spec))
    with CaptionDataset(jsynthetic.split_paths(paths)) as ds:
        bpe = JaxLoader(ds, batch_size=32, seq_per_img=5,
                        seed=SEED).batches_per_epoch
    opt = train.parse_args([
        "--device", "cpu", "--synthetic_videos", "512",
        "--synthetic_val_videos", "4", "--captions_per_video", "5",
        "--feat_shapes", "2x4,1x3", "--max_length", str(L),
        "--rnn_size", "8", "--input_encoding_size", "8", "--att_size", "8",
        "--batch_size", "32", "--seq_per_img", "5", "--use_rl", "1",
        "--rl_baseline", "scb-sample", "--learning_rate", "2e-5",
        "--learning_rate_decay_every", "3",
        "--checkpoint_path", str(tmp_path / "ck")])
    trainer = Trainer(opt)
    assert trainer.loader.batches_per_epoch == bpe == 16
    assert trainer.optimizer.decay_every_steps == 3 * bpe
    _, sched = make_optimizer("adam", 2e-5, 10.0, 0.8, 3 * bpe)
    for count in (0, 47, 48, 100, 191):
        assert trainer.optimizer.lr(torch.tensor(float(count))).item() == \
            float(np.float32(sched(count))), count
