"""Data parallelism under Adam, 2 ranks against 1, on the CPU at phase 18
(b)'s shape of ``chip_smoke.py`` (8 videos x 20 captions, E = H = A =
512, vocabulary 8000, features 28 x 2048 + 1 x 4096, 2 XE updates, a
REINFORCE and a fused CST update): how many parameter elements fall
outside the reference test's elementwise bound (rtol 1e-4, atol 1e-6).

For each seed ``s`` of ``--seeds``, each side in its own configuration
(its own dropout, its initialisation from seed ``s``, the data of seed
0):

- the reference's ``run_dp_pipeline`` on its 2-device mesh against 1
  device (its ``create_train_state`` given ``PRNGKey(s)``);
- the port's ``run_dp_pipeline`` on 2 gloo ranks against 1 rank (its
  ``init_like_flax_`` from seed ``s``).

At the first seed, beside them: both sides on the reference's initial
weights without dropout; then, for the port, the first update's
gradients: the 2-rank reduced gradient against the float32 sum of the
two half batches' (each over the global mask total), the 1-rank one
against the whole batch's, and both against the whole batch's gradient
in float64 at the outlying elements.

    JAX_PLATFORMS=cpu python dp_adam_outliers.py [--seeds 0,1,2] [--small]

``--small`` runs the same at a width of 16 and a vocabulary of 50 (a
check of the script, seconds).  Prints one JSON object.  About six
minutes a seed on 8 CPU cores at the full shape.
"""

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RTOL, ATOL = 1e-4, 1e-6


def shape(small: bool) -> dict:
    if small:
        return {"B": 4, "vocab": 50, "hidden": 16, "seq_per_img": 5,
                "max_len": 8, "feat_shapes": [(4, 8), (1, 6)]}
    return {"B": 8, "vocab": 8000, "hidden": 512, "seq_per_img": 20,
            "max_len": 30, "feat_shapes": [(28, 2048), (1, 4096)]}


def outliers(one: dict, two: dict) -> int:
    return int(sum((~np.isclose(two[k], one[k], rtol=RTOL, atol=ATOL)).sum()
                   for k in one))


def reference(cfg: dict, seeds) -> tuple:
    """The reference's 2-vs-1 counts per seed (its own configuration),
    the count on seed ``seeds[0]``'s weights without dropout, and those
    initial weights in the port's layout."""
    import jax

    import cst_captioning_tpu.models as jax_models
    import cst_captioning_tpu.parallel.dryrun as d
    import cst_captioning_tpu.training.state as st
    from cst_captioning_tpu_torch.weights import from_flax

    def port_layout(params):
        return {k: v.numpy() for k, v in from_flax(
            jax.tree_util.tree_map(np.asarray, params)).items()}

    d.VOCAB, d.HIDDEN = cfg["vocab"], cfg["hidden"]
    d.SEQ_PER_IMG, d.MAX_LEN = cfg["seq_per_img"], cfg["max_len"]
    d.FEAT_SHAPES = cfg["feat_shapes"]
    real_state, real_model = st.create_train_state, jax_models.CaptionModel

    def pair(seed):
        st.create_train_state = lambda model, key, *a, **k: real_state(
            model, jax.random.PRNGKey(seed), *a, **k)
        try:
            got = {n: port_layout(d.run_dp_pipeline(
                n, batch_size=cfg["B"], xe_steps=2)["params"])
                for n in (1, 2)}
        finally:
            st.create_train_state = real_state
        return outliers(got[1], got[2]), got

    counts = {}
    for s in seeds:
        counts[s], got = pair(s)
        print(f"reference seed {s}: {counts[s]}", file=sys.stderr,
              flush=True)
    elements = int(sum(v.size for v in got[1].values()))
    jax_models.CaptionModel = lambda **kw: real_model(
        **{**kw, "dropout_rate": 0.0})
    try:
        no_dropout, _ = pair(seeds[0])
    finally:
        jax_models.CaptionModel = real_model
    model = real_model(vocab_size=cfg["vocab"], embed_size=cfg["hidden"],
                       hidden_size=cfg["hidden"], attn_size=cfg["hidden"],
                       num_layers=1, use_attention=True, dropout_rate=0.0)
    tx, _ = st.make_optimizer(learning_rate=1e-3, grad_clip=5.0)
    state = real_state(model, jax.random.PRNGKey(seeds[0]),
                       cfg["feat_shapes"], cfg["max_len"],
                       cfg["seq_per_img"], tx, batch_size=cfg["B"])
    return counts, no_dropout, elements, port_layout(state.params)


def port(cfg: dict, seeds, init: dict) -> tuple:
    """The port's 2-vs-1 counts per seed (its own configuration), and on
    the reference's weights without dropout with the first update's
    gradient readings."""
    import torch

    from cst_captioning_tpu_torch.ops.losses import (cross_entropy_loss,
                                                     sequence_mask)
    from cst_captioning_tpu_torch.parallel import dryrun
    from cst_captioning_tpu_torch.weights import init_like_flax_

    B, S, L, V = cfg["B"], cfg["seq_per_img"], cfg["max_len"], cfg["vocab"]
    widths = {k: cfg[k] for k in ("vocab", "hidden", "seq_per_img",
                                  "max_len", "feat_shapes")}
    kw = dict(batch_size=B, xe_steps=2, decode_kernel="fused",
              kernel_attention=True, config=widths, device="cpu",
              decode_chunk=8, optim="adam")
    counts = {}
    for s in seeds:
        model = dryrun.pipeline_model(widths, "cpu", "fused", True, 0.5,
                                      None)
        init_like_flax_(model, torch.Generator().manual_seed(s))
        own = {k: v.numpy() for k, v in model.state_dict().items()}
        one = dryrun.run_dp_pipeline(1, params=own, **kw)
        two = dryrun.run_dp_pipeline(2, backend="gloo", params=own, **kw)
        counts[s] = outliers(one["params"], two["params"])
        print(f"port seed {s}: {counts[s]}", file=sys.stderr, flush=True)

    kw.update(drop_prob=0.0, params=init, grads=True)
    one = dryrun.run_dp_pipeline(1, **kw)
    two = dryrun.run_dp_pipeline(2, backend="gloo", **kw)
    out = {"reference_weights_no_dropout": outliers(one["params"],
                                                    two["params"])}

    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((B,) + s).astype(np.float32)
             for s in cfg["feat_shapes"]]
    labels = torch.from_numpy(
        rng.integers(1, V, (B * S, L)).astype(np.int32)).long()
    total = sequence_mask(labels).sum().float()

    def grads(rows, denominator, dtype=torch.float32):
        # K1's plain version takes float32 storage only: float64 runs the
        # model's own attention, the same function.
        model = dryrun.pipeline_model(widths, "cpu", "fused",
                                      dtype == torch.float32, 0.0,
                                      init).to(dtype)
        for m in model.modules():               # the compute dtype too
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = dtype
        vids = slice(rows.start // S, rows.stop // S)
        logits = model([torch.from_numpy(f[vids]).to(dtype) for f in feats],
                       labels[rows], S, train=True,
                       generator=torch.Generator().manual_seed(1))
        cross_entropy_loss(logits, labels[rows],
                           torch.ones(rows.stop - rows.start, dtype=dtype),
                           total=denominator).backward()
        return {n: p.grad.numpy() for n, p in model.named_parameters()}

    whole = grads(slice(0, B * S), None)
    exact = grads(slice(0, B * S), None, torch.float64)
    half = B * S // 2
    halves = [grads(slice(r * half, (r + 1) * half),
                    lambda t: total.to(t.dtype)) for r in (0, 1)]
    summed = {k: halves[0][k] + halves[1][k] for k in whole}
    g1, g2 = one["grads"][0], two["grads"][0]
    bad = {k: ~np.isclose(two["params"][k], one["params"][k], rtol=RTOL,
                          atol=ATOL) for k in one["params"]}

    def at(d):
        return np.concatenate([d[k][bad[k]].ravel() for k in bad])

    def span(x):
        return [float(x.min()), float(x.max())] if x.size else None

    w, h, x = at(whole), at(summed), at(exact)
    out.update({
        "outliers": int(w.size),
        "one_rank_is_the_whole_batch": all(
            np.array_equal(g1[k], whole[k]) for k in whole),
        "two_ranks_are_the_sum_of_halves": all(
            np.array_equal(g2[k], summed[k]) for k in whole),
        "first_update_gradients_whole_vs_halves_differ": int(sum(
            (whole[k] != summed[k]).sum() for k in whole)),
        "outliers_first_update_abs_g_float64": span(np.abs(x)),
        "outliers_abs_error_vs_float64_one_rank": span(np.abs(w - x)),
        "outliers_abs_error_vs_float64_two_ranks": span(np.abs(h - x)),
        "outliers_sign_wrong_one_rank": int((np.sign(w) != np.sign(x)).sum()),
        "outliers_sign_wrong_two_ranks": int((np.sign(h) != np.sign(x)).sum()),
        "all_max_abs_error_vs_float64_one_rank": float(max(
            np.abs(whole[k] - exact[k]).max() for k in whole)),
        "all_max_abs_error_vs_float64_two_ranks": float(max(
            np.abs(summed[k] - exact[k]).max() for k in whole)),
        "nonzero_first_update_abs_g_below_3e-8": int(sum(
            ((np.abs(exact[k]) < 3e-8) & (exact[k] != 0)).sum()
            for k in whole)),
    })
    return counts, out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2",
                    help="comma-separated initialisation seeds")
    ap.add_argument("--small", action="store_true",
                    help="a width of 16, a vocabulary of 50")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    cfg = shape(args.small)
    sys.path.insert(0, REPO)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2")
    ref, ref_no_dropout, elements, init = reference(cfg, seeds)
    mine, diag = port(cfg, seeds, init)
    print(json.dumps({
        "shape": {k: v for k, v in cfg.items()}, "elements": elements,
        "bound": {"rtol": RTOL, "atol": ATOL},
        "own_configuration_2_vs_1": {
            str(s): {"reference_devices": ref[s], "port_gloo_ranks": mine[s]}
            for s in seeds},
        "reference_weights_no_dropout_2_vs_1": {
            "seed": seeds[0], "reference_devices": ref_no_dropout,
            "port_gloo_ranks": diag.pop("reference_weights_no_dropout")},
        "port_first_update_gradients": diag}), flush=True)


if __name__ == "__main__":
    main()
