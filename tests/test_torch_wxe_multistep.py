"""The port's XE and WXE over an epoch of Adam steps against the
reference's, on the CPU: what one step cannot show (Adam's moments and
step count, the staircase, the loaders' batch order and the consensus
weights they carry) held step by step.

Per step the reference runs ``make_xe_step`` (guard on, dropout 0) over
a ``TrainState`` with ``make_optimizer("adam", ...)`` and clip 10, on the
batches of its own ``CaptionLoader`` over the synthetic split written to
HDF5, with the weights ``normalize_weights`` makes of its consensus
pickle (WXE) or none (XE).  The port runs ``steps.xe_step`` with its
``Optimizer`` on the batches of its own loader over the split it builds
in memory, with its own consensus scores.  Both start from one
parameter tree (``weights.model_from_flax``; the port's K1 path and the
recomputed cell, as the train CLI runs by default).

After every step (float32): the batch's videos, labels and weights
identical; loss and gradient norm within 1e-5 of max(1, |x|); the
learning rate and the step count equal; both Adam moments within 1e-5 *
max(1, max|x|) of the reference's; every parameter within 1e-5 *
max(1, max|x|) where the reference's gradient RMS (Adam's bias-corrected
sqrt(nu)) has stayed at least ``SMALL_G`` = 100 x Adam's eps, and within
the sum of the learning rates so far (one Adam step each) where it has
been below.
Adam scales an update by g / (|g| + eps): at |g| near eps a gradient
that differs in its last float32 bits against max|g| (1e-10 against
0.14 in the test's first step) moves the update by a visible fraction
of the rate, as in any two summation orders (ROADMAP Queue 3 item 5).

As a script it runs the same comparison at the learning chain's shape
(512 videos, vocabulary 400, width 192, 32 x 20, ``max_length`` 30) on
the reference chain's data directory and, with ``--start_from``, from a
reference stage directory's best parameters, printing one JSON line per
step and a summary; exit 1 when a step leaves the tolerance:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_wxe_multistep.py \\
        --data_dir ref512/data --start_from ref512/checkpoints/xe \\
        --stage wxe --steps 16
"""

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.data import synthetic as jsynthetic
from cst_captioning_tpu.data.dataset import CaptionDataset
from cst_captioning_tpu.data.loader import CaptionLoader as JaxLoader
from cst_captioning_tpu.metrics.consensus import (
    load_consensus as jload_consensus)
from cst_captioning_tpu.metrics.consensus import (
    normalize_weights as jnormalize_weights)
from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.training.state import TrainState, make_optimizer
from cst_captioning_tpu.training.steps import make_xe_step
from cst_captioning_tpu_torch.data import synthetic
from cst_captioning_tpu_torch.data.loader import CaptionLoader
from cst_captioning_tpu_torch.metrics.consensus import normalize_weights
from cst_captioning_tpu_torch.training import steps
from cst_captioning_tpu_torch.training.state import Optimizer
from cst_captioning_tpu_torch.weights import from_flax, model_from_flax

SEED = 123
TOL = 1e-5
CLIP = 10.0
#: Adam's eps (optax's and the port's default) and the gradient RMS below
#: which a parameter is held to the rate, not to TOL.
EPS = 1e-8
SMALL_G = 100 * EPS
#: The test's size: one epoch of 12 steps, decays after steps 5 and 10.
SMALL = dict(spec=dict(num_videos=48, captions_per_video=5, max_len=8,
                       feat_dims=(8, 5), feat_times=(3, 1), seed=0,
                       rich_vocab=0),
             batch=4, seq_per_img=3, hidden=16, lr=5e-3, decay_rate=0.8,
             decay_every=5)
#: The learning chain's (``tools/stage_chain.py``, ``scripts/scale_chain.py``):
#: XE at 2e-4, WXE at 1e-4, halved every 30 epochs of 16 steps.
CHAIN = dict(spec=dict(num_videos=512, captions_per_video=20, max_len=30,
                       feat_dims=(2048, 4096), feat_times=(28, 1), seed=0,
                       rich_vocab=400),
             batch=32, seq_per_img=20, hidden=192, decay_rate=0.5,
             decay_every=30 * 16)
STAGE_LR = {"xe": 2e-4, "wxe": 1e-4}


def _close(got, want, tol=TOL):
    """-> (max error, bound): bound = tol * max(1, max|want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return (float(np.abs(got - want).max(initial=0.0)),
            tol * max(1.0, float(np.abs(want).max(initial=0.0))))


def _adam_state(opt_state):
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf
    raise AssertionError("no Adam state in the chain")


def make_splits(spec, root):
    """The reference's train split on HDF5 under ``root`` (written when
    ``root`` holds none) and the port's, built in memory."""
    info = os.path.join(root, "train_info.json")
    if os.path.exists(info):
        paths = {"feat_h5": json.dumps(
                     [os.path.join(root, f"train_feat{m}.h5")
                      for m in range(len(spec["feat_dims"]))]),
                 "label_h5": os.path.join(root, "train_label.h5"),
                 "info_json": info,
                 "cocofmt_json": os.path.join(root, "train_cocofmt.json"),
                 "consensus_pkl": os.path.join(root,
                                               "train_consensus.pkl")}
    else:
        paths = jsynthetic.generate(root, "train",
                                    jsynthetic.SyntheticSpec(**spec))
    ours = synthetic.generate("train", synthetic.SyntheticSpec(**spec),
                              consensus=True)
    return paths, ours


def run(cfg, paths, ours, stage, n_steps, lr, params=None, report=None):
    """Drive both sides ``n_steps`` updates of ``stage`` (xe or wxe) from
    one parameter tree; -> per-step errors as {name: (err, bound)}.
    ``report(step, errors)`` sees each step; without it a step outside
    the tolerance raises."""
    b, s, h = cfg["batch"], cfg["seq_per_img"], cfg["hidden"]
    spec = cfg["spec"]
    v = ours.vocab.size_with_pad
    jm = JaxCaptionModel(vocab_size=v, embed_size=h, hidden_size=h,
                         attn_size=h, dropout_rate=0.0)
    if params is None:
        feats0 = [np.zeros((b, t, d), np.float32)
                  for t, d in zip(spec["feat_times"], spec["feat_dims"])]
        params = jm.init(jax.random.PRNGKey(0),
                         [jnp.asarray(f) for f in feats0],
                         np.zeros((b * s, spec["max_len"]), np.int32),
                         s)["params"]
    params = jax.tree_util.tree_map(np.array, params)
    tx, sched = make_optimizer("adam", lr, CLIP, cfg["decay_rate"],
                               cfg["decay_every"])
    state = TrainState.create(apply_fn=jm.apply, params=params, tx=tx)
    step_fn = jax.jit(make_xe_step(jm, s, guard=True))
    model = model_from_flax(params, device="cpu", use_kernel_attention=True,
                            decode_kernel="fused", drop_prob=0.0,
                            remat_cell=True)
    model.train()
    opt = Optimizer(model.parameters(), optim="adam", learning_rate=lr,
                    grad_clip=CLIP, decay_rate=cfg["decay_rate"],
                    decay_every_steps=cfg["decay_every"])
    wxe = stage == "wxe"
    jweights = (jnormalize_weights(jload_consensus(paths["consensus_pkl"]))
                if wxe else None)
    weights = normalize_weights(ours.consensus) if wxe else None
    loader = CaptionLoader(ours, b, seq_per_img=s, seed=SEED,
                           consensus_weights=weights)
    gen = torch.Generator().manual_seed(SEED)
    errors, lr_sum, small = [], 0.0, {}
    with CaptionDataset(jsynthetic.split_paths(paths)) as ds:
        jloader = JaxLoader(ds, batch_size=b, seq_per_img=s, seed=SEED,
                            consensus_weights=jweights)
        for k in range(n_steps):
            jb, tb = jloader.next_batch(), loader.next_batch()
            np.testing.assert_array_equal(tb.video_ix, jb.video_ix)
            np.testing.assert_array_equal(tb.labels, jb.labels)
            np.testing.assert_array_equal(tb.weights, jb.weights)
            assert wxe == bool((jb.weights != 1.0).any()), k
            state, jmet = step_fn(state, [jnp.asarray(f) for f in jb.feats],
                                  jnp.asarray(jb.labels),
                                  jnp.asarray(jb.weights),
                                  jax.random.PRNGKey(k))
            m = steps.xe_step(model, opt,
                              [torch.from_numpy(f) for f in tb.feats],
                              torch.from_numpy(tb.labels).long(),
                              torch.from_numpy(tb.weights), s, gen,
                              guard=True)
            err = {name: _close(m[name].item(), float(jmet[name]))
                   for name in ("loss", "grad_norm")}
            adam = _adam_state(state.opt_state)
            assert int(adam.count) == int(opt.count.item()) == k + 1
            assert opt.current_lr() == float(np.float32(sched(k))), k
            want_p = from_flax(jax.tree_util.tree_map(np.asarray,
                                                      state.params))
            mu = from_flax(jax.tree_util.tree_map(np.asarray, adam.mu))
            nu = from_flax(jax.tree_util.tree_map(np.asarray, adam.nu))
            lr_sum += float(np.float32(sched(k)))
            for (n, p), st in zip(model.named_parameters(), opt.state):
                got, want = p.detach().numpy(), want_p[n].numpy()
                rms = np.sqrt(nu[n].numpy() / (1.0 - 0.999 ** (k + 1)))
                small[n] = small.get(n, False) | (rms < SMALL_G)
                big = ~small[n]
                err[f"p:{n}"] = (_close(got[big], want[big])[0],
                                 _close(got, want)[1])
                if not big.all():
                    err[f"p_small_g:{n}"] = (
                        _close(got[~big], want[~big])[0], lr_sum)
                err[f"mu:{n}"] = _close(st["mu"].numpy(), mu[n].numpy())
                err[f"nu:{n}"] = _close(st["nu"].numpy(), nu[n].numpy())
            errors.append(err)
            if report is not None:
                report(k, err)
            else:
                bad = {n: e for n, e in err.items() if e[0] > e[1]}
                assert not bad, (k, bad)
    return errors


@pytest.fixture(scope="module")
def small_splits(tmp_path_factory):
    return make_splits(SMALL["spec"], str(tmp_path_factory.mktemp("wxe")))


@pytest.mark.parametrize("stage", ["xe", "wxe"])
def test_epoch_matches_reference_float32(small_splits, stage):
    errors = run(SMALL, *small_splits, stage, n_steps=12, lr=SMALL["lr"])
    assert len(errors) == 12


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_dir", required=True,
                   help="the reference chain's data directory (its train "
                        "split is read; the port builds the same split)")
    p.add_argument("--start_from", default=None,
                   help="a reference stage directory: start from its best "
                        "parameters (default: the reference's init)")
    p.add_argument("--stage", choices=sorted(STAGE_LR), default="wxe")
    p.add_argument("--steps", type=int, default=16)
    args = p.parse_args(argv)
    paths, ours = make_splits(CHAIN["spec"], args.data_dir)
    params = None
    if args.start_from:
        from cst_captioning_tpu.training.checkpoint import CheckpointManager

        mgr = CheckpointManager(args.start_from, readonly=True)
        try:
            params = mgr.restore_params(None, best=True)
        finally:
            mgr.close()
    worst = {}
    t0 = time.perf_counter()

    def report(k, err):
        for name, (e, bound) in err.items():
            group = name.split(":")[0]
            ratio = e / bound
            if ratio > worst.get(group, (0.0,))[0]:
                worst[group] = (ratio, name, k)
        print(json.dumps({"step": k + 1, "s": round(time.perf_counter() - t0, 1),
                          "loss": err["loss"], "grad_norm": err["grad_norm"],
                          "worst": max((e / b, n) for n, (e, b)
                                       in err.items())}), flush=True)

    run(CHAIN, paths, ours, args.stage, args.steps, STAGE_LR[args.stage],
        params=params, report=report)
    ok = all(r <= 1.0 for r, _, _ in worst.values())
    print(json.dumps({"stage": args.stage, "steps": args.steps, "ok": ok,
                      "start_from": args.start_from,
                      "worst_error_over_bound": worst}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
