"""The port's model variants against the reference's, on the CPU: the
manet (modality) encoder, the multi-layer and pooled LSTMs and the
Transformer, on weights converted from the Flax tree
(``weights.from_flax``).

- the manet encoder against ``FeatureEncoder(fusion="modality")``;
- ``config_from_flax``/``from_flax``/``to_flax`` on transformer, manet,
  2-layer and pooled trees;
- greedy and beam-3 tokens of all four variants against the reference's
  ``ops/sampling.py`` and ``ops/beam.py`` (the early exit too);
- K1's and K2's plain versions at T = 1, 2 and 3 (manet's memory is one
  token per modality) against the Pallas kernels in interpret mode;
- the serving engine's captions of manet (K2's plain version and the
  reference cell), the 2-layer and the pooled LSTM equal to the offline
  decoders';
- XE and CST (REINFORCE) gradients of the transformer and of manet
  against the reference's, dropout 0;
- ``--remat_cell`` 1 against 0, bit for bit, with dropout on.

Tolerance: 1e-5 * max(1, max|ref|) in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.models import FeatureEncoder as JaxEncoder
from cst_captioning_tpu.ops.beam import beam_search as jax_beam_search
from cst_captioning_tpu.ops.losses import (cross_entropy_loss, reward_loss,
                                           token_logprobs)
from cst_captioning_tpu.ops.pallas_attention import \
    fused_additive_attention as jax_k1
from cst_captioning_tpu.ops.pallas_decode_cell import \
    fused_decode_cell as jax_k2
from cst_captioning_tpu.ops.sampling import greedy_decode as jax_greedy
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.models.encoder import FeatureEncoder
from cst_captioning_tpu_torch.ops import attention_kernel as k1
from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2
from cst_captioning_tpu_torch.ops.beam import beam_search
from cst_captioning_tpu_torch.ops.sampling import greedy_decode
from cst_captioning_tpu_torch.serving.engine import serve_decode_batch
from cst_captioning_tpu_torch.training import steps
from cst_captioning_tpu_torch.training.state import Optimizer
from cst_captioning_tpu_torch.weights import (config_from_flax,
                                              exported_model_opts, from_flax,
                                              init_like_flax_,
                                              model_from_flax, to_flax)

B, S, H, E, A, V, L = 4, 3, 16, 12, 16, 30, 8
FEAT_SHAPES = ((4, 8), (1, 5))
TOL = 1e-5
EOS_BIAS = 0.4

#: name -> (the reference's CaptionModel options, the port's extras).
VARIANTS = {
    "transformer": dict(decoder_type="transformer", num_heads=2,
                        num_tx_layers=2, tx_max_len=L + 1),
    "manet": dict(fusion_type="modality"),
    "lstm2": dict(num_layers=2),
    "pooled": dict(use_attention=False),
}


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _feats(seed=0, b=B, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b,) + s) * scale).astype(np.float32)
            for s in FEAT_SHAPES]


def _jax(variant, seed=0, dropout=0.0, **kw):
    jm = JaxCaptionModel(vocab_size=V, embed_size=E, hidden_size=H,
                         attn_size=A, dropout_rate=dropout,
                         **VARIANTS[variant], **kw)
    variables = jm.init(jax.random.PRNGKey(seed),
                        [jnp.asarray(f) for f in _feats()],
                        np.zeros((B, L), np.int32))
    return jm, jax.tree_util.tree_map(np.asarray, variables["params"])


def _port(variant, params, **kw):
    if VARIANTS[variant].get("fusion_type"):
        kw["fusion_type"] = VARIANTS[variant]["fusion_type"]
    return model_from_flax(params, device="cpu", **kw)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_manet_encoder_matches_modality_fusion():
    feats = _feats(1)
    jfeats = [jnp.asarray(f) for f in feats]
    enc = JaxEncoder(H, dropout_rate=0.5, fusion="modality")
    variables = enc.init(jax.random.PRNGKey(0), jfeats)
    mem_j, pooled_j = enc.apply(variables, jfeats, train=False)
    port = FeatureEncoder([8, 5], H, drop_prob=0.5, fusion="modality")
    p = jax.tree_util.tree_map(np.asarray, variables["params"])
    with torch.no_grad():
        for m in range(2):
            port.embed[m].weight.copy_(torch.tensor(
                p[f"embed_{m}"]["kernel"].T))
            port.embed[m].bias.copy_(torch.tensor(p[f"embed_{m}"]["bias"]))
        port.fuse.weight.copy_(torch.tensor(p["fuse"]["kernel"].T))
        port.fuse.bias.copy_(torch.tensor(p["fuse"]["bias"]))
        mem_t, pooled_t = port(_t(feats))
    assert mem_t.shape == (B, 2, H)
    _close(mem_t.numpy(), mem_j)
    _close(pooled_t.numpy(), pooled_j)
    with pytest.raises(ValueError, match="fusion"):
        FeatureEncoder([8], H, fusion="frames")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_teacher_forced_logits_match(variant):
    jm, params = _jax(variant)
    model = _port(variant, params)
    feats = _feats(2)
    labels = np.random.default_rng(3).integers(
        1, V, size=(B * S, L)).astype(np.int32)
    want = jm.apply({"params": params}, [jnp.asarray(f) for f in feats],
                    labels, S, train=False)
    with torch.no_grad():
        got = model(_t(feats), torch.from_numpy(labels).long(), S)
    _close(got.numpy(), want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_config_and_conversion_round_trip(variant):
    """Every Flax leaf lands in one port parameter and back; the config
    names the variant's widths (a manet tree is a temporal one: the
    fusion comes from the saved options)."""
    _, params = _jax(variant)
    cfg = config_from_flax(params)
    if variant == "transformer":
        assert cfg == {"vocab_size": V, "feat_dims": [8, 5],
                       "embed_size": H, "hidden_size": H,
                       "decoder_type": "transformer", "num_heads": 2,
                       "num_tx_layers": 2, "tx_max_len": L + 1}
    else:
        assert cfg["num_layers"] == VARIANTS[variant].get("num_layers", 1)
        assert cfg["use_attention"] == VARIANTS[variant].get(
            "use_attention", True)
        assert "fusion_type" not in cfg
    sd = from_flax(params)
    model = _port(variant, params)
    assert set(sd) == set(model.state_dict())
    back = to_flax(model)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    bogus = {**params, "bogus": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="bogus"):
        from_flax(bogus)


def test_transformer_dense_general_layout():
    _, params = _jax("transformer")
    sd = from_flax(params)
    q = params["tx"]["block_1"]["cross_attn"]["query"]
    np.testing.assert_array_equal(
        sd["tx.blocks.1.cross_attn.query.weight"].numpy(),
        q["kernel"].reshape(H, -1).T)
    np.testing.assert_array_equal(
        sd["tx.blocks.1.cross_attn.query.bias"].numpy(),
        q["bias"].reshape(-1))
    out = params["tx"]["block_0"]["self_attn"]["out"]["kernel"]
    np.testing.assert_array_equal(
        sd["tx.blocks.0.self_attn.out.weight"].numpy(),
        out.reshape(-1, H).T)
    with pytest.raises(ValueError, match="pass the model"):
        to_flax(sd)


def test_exported_model_opts_take_every_variant():
    opts = {"model_type": "transformer", "fusion_type": "manet",
            "num_heads": 4, "num_tx_layers": 3, "rnn_size": 32,
            "learning_rate": 1.0}
    assert exported_model_opts(opts) == {
        k: v for k, v in opts.items() if k != "learning_rate"}
    for key, bad in (("model_type", "gru"), ("fusion_type", "frames")):
        with pytest.raises(ValueError, match=bad):
            exported_model_opts({key: bad})


@pytest.fixture(scope="module")
def decoders():
    """Each variant with an EOS bias, so captions end at mixed lengths."""
    out = {}
    for variant in VARIANTS:
        jm, params = _jax(variant, seed=1)
        head = params["tx"]["logit"] if "tx" in params else params["logit"]
        head["bias"] = head["bias"].copy()
        head["bias"][0] += EOS_BIAS
        out[variant] = (jm, params, _port(variant, params))
    return out


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_greedy_tokens_identical_to_reference(decoders, variant, chunk):
    jm, params, model = decoders[variant]
    feats = _feats(4, scale=2.0)
    want = np.asarray(jax_greedy(jm, {"params": params},
                                 [jnp.asarray(f) for f in feats], L))
    got = greedy_decode(model, _t(feats), L, decode_chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_beam3_tokens_identical_to_reference(decoders, variant, chunk):
    jm, params, model = decoders[variant]
    feats = _feats(5, scale=2.0)
    best_j, beams_j, scores_j = jax_beam_search(
        jm, {"params": params}, [jnp.asarray(f) for f in feats],
        beam_size=3, max_len=L, decode_chunk=chunk)
    best, beams, scores = beam_search(model, _t(feats), 3, L,
                                      decode_chunk=chunk)
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_j))
    np.testing.assert_array_equal(beams.numpy(), np.asarray(beams_j))
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_j),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("beam_size", [1, 3])
@pytest.mark.parametrize("variant,kernel", [
    ("manet", "fused"), ("manet", "reference"), ("lstm2", "reference"),
    ("pooled", "reference")])
def test_serving_engine_matches_offline_decode(decoders, variant, kernel,
                                               beam_size):
    """Every LSTM variant serves through the engine (manet's slot memory
    one token per modality; K2's plain version for ``fused``), caption
    for caption as the offline decoders."""
    _, _, model = decoders[variant]
    model = model.clone(decode_kernel=kernel)
    feats = _feats(9, scale=2.0)
    tfeats = _t(feats)
    offline = (greedy_decode(model, tfeats, L) if beam_size == 1
               else beam_search(model, tfeats, beam_size, L)[0])
    got = serve_decode_batch(model, [[f[i] for f in feats]
                                     for i in range(B)], L,
                             beam_size=beam_size, decode_chunk=3,
                             bucket_sizes=(2,))
    np.testing.assert_array_equal(np.stack(got), offline.numpy())


def test_fused_decode_refuses_the_other_variants():
    """At construction, and where a built model is cloned onto the
    fused cell (the serve CLI's path)."""
    for variant in ("transformer", "lstm2", "pooled"):
        with pytest.raises(ValueError, match="does not cover"):
            CaptionModel(V, [8, 5], embed_size=E, hidden_size=H,
                         attn_size=A, decode_kernel="fused",
                         **VARIANTS[variant])
        model = CaptionModel(V, [8, 5], embed_size=E, hidden_size=H,
                             attn_size=A, **VARIANTS[variant])
        with pytest.raises(ValueError, match="does not cover"):
            model.clone(decode_kernel="fused")
    CaptionModel(V, [8, 5], embed_size=E, hidden_size=H, attn_size=A,
                 decode_kernel="fused", fusion_type="modality")


def _k1_inputs(t, seed, b=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, A)).astype(np.float32),
            rng.normal(size=(b, t, A)).astype(np.float32),
            rng.normal(size=(b, t, H)).astype(np.float32),
            (rng.normal(size=(A,)) / A ** 0.5).astype(np.float32))


@pytest.mark.parametrize("t", [1, 2, 3])
def test_k1_plain_matches_pallas_at_few_time_steps(t):
    args = _k1_inputs(t, seed=10 + t)
    ctx_j, w_j = jax_k1(*(jnp.asarray(a) for a in args), block_b=4,
                        interpret=True)
    ctx_t, w_t = k1.additive_attention_plain(*_t(args))
    _close(ctx_t.numpy(), ctx_j)
    _close(w_t.numpy(), w_j)
    if t == 1:
        np.testing.assert_array_equal(w_t.numpy(), 1.0)


@pytest.mark.parametrize("t", [1, 2, 3])
def test_k2_plain_matches_pallas_at_few_time_steps(t):
    rng = np.random.default_rng(20 + t)
    b = 5

    def r(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    d = dict(x=r(b, E), c=r(b, H), h=np.tanh(r(b, H)), q=r(b, A),
             proj_mem=r(b, t, A), memory=r(b, t, H),
             score_v=r(A, scale=A ** -0.5),
             wi=r(E + H, 4 * H, scale=(E + H) ** -0.5),
             wh=r(H, 4 * H, scale=H ** -0.5), bias=r(4 * H, scale=0.1))
    names = ("x", "c", "h", "q", "proj_mem", "memory", "score_v", "wi",
             "wh", "bias")
    c_j, h_j = jax_k2(*(jnp.asarray(d[k]) for k in names), block_b=8,
                      interpret=True)
    tt = {k: torch.from_numpy(v) for k, v in d.items()}
    c_t, h_t = k2.decode_cell_plain(
        tt["x"], tt["c"], tt["h"], tt["q"], tt["proj_mem"], tt["memory"],
        tt["score_v"], torch.cat([tt["wi"], tt["wh"]], dim=0), tt["bias"])
    _close(c_t.numpy(), c_j)
    _close(h_t.numpy(), h_j)


def _assert_grads_close(model, jax_grads):
    want = from_flax(jax.tree_util.tree_map(np.asarray, jax_grads))
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= TOL * max(1.0, float(np.abs(ref).max())), (name, err)


@pytest.mark.parametrize("variant,k1_attention", [
    ("transformer", False), ("manet", False), ("manet", True)])
def test_xe_and_cst_gradients_match_reference(variant, k1_attention):
    jm, params = _jax(variant, seed=2,
                      use_pallas_attention=k1_attention)
    feats = _feats(6)
    jfeats = [jnp.asarray(f) for f in feats]
    rng = np.random.default_rng(7)
    labels = rng.integers(1, V, size=(B * S, L)).astype(np.int32)
    labels[0, 3:] = 0
    adv = rng.normal(size=B * S).astype(np.float32)
    ones = np.ones(B * S, np.float32)

    def xe_loss(p):
        logits = jm.apply({"params": p}, jfeats, labels, S, train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return cross_entropy_loss(logits, labels, jnp.asarray(ones))

    def rl_loss(p):
        logits = jm.apply({"params": p}, jfeats, labels, S, train=False)
        return reward_loss(token_logprobs(logits, labels), labels,
                           jnp.asarray(adv))

    for loss_fn, run in (
            (xe_loss, lambda m, o: steps.xe_step(
                m, o, _t(feats), torch.from_numpy(labels).long(),
                torch.from_numpy(ones), S, torch.Generator().manual_seed(0))),
            (rl_loss, lambda m, o: steps.rl_grad_step(
                m, o, _t(feats), torch.from_numpy(labels).long(),
                torch.from_numpy(adv), S))):
        loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
        model = _port(variant, params, drop_prob=0.0,
                      use_kernel_attention=k1_attention)
        out = run(model, Optimizer(model.parameters(), learning_rate=0.0))
        assert abs(out["loss"].item() - float(loss_j)) <= TOL
        _assert_grads_close(model, grads_j)


@pytest.mark.parametrize("kw", [
    dict(), dict(num_layers=2), dict(use_kernel_attention=True),
    dict(fusion_type="modality", use_kernel_attention=True),
    dict(use_attention=False), dict(dtype=torch.bfloat16)])
def test_remat_cell_gradients_bit_identical_with_dropout(kw):
    """The dropout mask of each step is drawn before the step and passed
    into the recomputed cell, so ``remat_cell`` changes no bit of the
    loss or of any gradient."""
    feats = _t(_feats(8))
    labels = torch.from_numpy(np.random.default_rng(9).integers(
        1, V, size=(B * S, L))).long()
    out = {}
    for remat in (False, True):
        model = CaptionModel(V, [8, 5], embed_size=E, hidden_size=H,
                             attn_size=A, drop_prob=0.5, remat_cell=remat,
                             **kw)
        init_like_flax_(model, torch.Generator().manual_seed(3))
        calls, cell = [], model.cell.forward
        model.cell.forward = lambda *a: calls.append(1) or cell(*a)
        opt = Optimizer(model.parameters(), learning_rate=0.0)
        m = steps.xe_step(model, opt, feats, labels, torch.ones(B * S), S,
                          torch.Generator().manual_seed(4))
        # Under remat the backward runs each step's cell once more.
        assert len(calls) == (2 * L if remat else L)
        # The pooled model's memory_proj takes no gradient (None).
        out[remat] = (m["loss"], {n: p.grad for n, p in
                                  model.named_parameters()
                                  if p.grad is not None})
    assert torch.equal(out[False][0], out[True][0])
    assert out[False][1].keys() == out[True][1].keys()
    for name, g in out[False][1].items():
        assert torch.equal(g, out[True][1][name]), name
