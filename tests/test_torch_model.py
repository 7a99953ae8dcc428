"""Port's CaptionModel against the reference's, on weights converted from
the Flax parameter tree (``weights.from_flax``).

``encode``, ``init_carry`` and teacher-forced logits must agree within
1e-5 at float32 with ``train=False`` on the JAX side (dropout RNGs cannot
match, and the port's inference model has none), for ``num_layers`` 1
and 2 and ``use_attention`` 0 and 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu_torch.data.vocab import Vocab
from cst_captioning_tpu_torch.models import CaptionModel, shift_right
from cst_captioning_tpu_torch.weights import (config_from_flax, from_flax,
                                              init_random_, load_params_npz,
                                              model_from_flax)

B, H, E, A, V, L = 6, 16, 12, 16, 30, 8
FEAT_SHAPES = ((4, 8), (1, 5))
TOL = 1e-5


def _data(seed=0):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(B,) + s).astype(np.float32)
             for s in FEAT_SHAPES]
    labels = rng.integers(1, V, size=(B, L)).astype(np.int32)
    labels[0, 5:] = 0                          # a 0-terminated caption
    return feats, labels


def _jax_model(num_layers=1, use_attention=True, seed=0):
    jm = JaxCaptionModel(vocab_size=V, embed_size=E, hidden_size=H,
                         attn_size=A, num_layers=num_layers,
                         use_attention=use_attention, dropout_rate=0.5)
    feats, labels = _data()
    variables = jm.init(jax.random.PRNGKey(seed),
                        [jnp.asarray(f) for f in feats], labels)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return jm, variables, params


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("use_attention", [True, False])
def test_encode_init_carry_and_logits_match(num_layers, use_attention):
    jm, variables, params = _jax_model(num_layers, use_attention)
    tm = model_from_flax(params, device="cpu")
    feats, labels = _data(1)
    jfeats = [jnp.asarray(f) for f in feats]
    mem_j, pm_j, pooled_j = jm.apply(variables, jfeats, method="encode")
    carry_j = jm.apply(variables, pooled_j, method="init_carry")
    logits_j = jm.apply(variables, jfeats, labels, train=False)
    with torch.no_grad():
        mem_t, pm_t, pooled_t = tm.encode(_t(feats))
        carry_t = tm.init_carry(pooled_t)
        logits_t = tm(_t(feats), torch.from_numpy(labels).long())
    for got, want in ((mem_t, mem_j), (pm_t, pm_j), (pooled_t, pooled_j),
                      (logits_t, logits_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)
    assert len(carry_t) == num_layers
    for (c_t, h_t), (c_j, h_j) in zip(carry_t, carry_j):
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=TOL)
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=TOL)


def test_seq_per_img_repeats_videos():
    jm, variables, params = _jax_model()
    tm = model_from_flax(params, device="cpu")
    feats, _ = _data(2)
    labels = np.random.default_rng(3).integers(
        1, V, size=(2 * B, L)).astype(np.int32)
    want = jm.apply(variables, [jnp.asarray(f) for f in feats], labels,
                    seq_per_img=2, train=False)
    with torch.no_grad():
        got = tm(_t(feats), torch.from_numpy(labels).long(), seq_per_img=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_from_flax_round_trip_and_config():
    """Every Flax leaf lands in exactly one port parameter: dense kernels
    transposed to (out, in), gate kernels stacked (in, out) as
    [W_i; W_h] with columns i|f|g|o, the h-side bias as the gate bias."""
    _, _, params = _jax_model()
    cfg = config_from_flax(params)
    assert cfg == {"vocab_size": V, "feat_dims": [8, 5], "embed_size": E,
                   "hidden_size": H, "num_layers": 1, "attn_size": A,
                   "use_attention": True}
    sd = from_flax(params)
    model = CaptionModel(**cfg)
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(
        sd["encoder.fuse.weight"].numpy(),
        params["encoder"]["fuse"]["kernel"].T)
    lstm = params["cell"]["lstm0"]
    n_in = E + H
    np.testing.assert_array_equal(sd["cell.lstm.0.w"][:n_in, H:2 * H],
                                  lstm["if"]["kernel"])
    np.testing.assert_array_equal(sd["cell.lstm.0.w"][n_in:, 3 * H:],
                                  lstm["ho"]["kernel"])
    np.testing.assert_array_equal(sd["cell.lstm.0.bias"][2 * H:3 * H],
                                  lstm["hg"]["bias"])


def test_from_flax_rejects_unknown_and_missing_keys():
    _, _, params = _jax_model()
    extra = {**params, "bogus": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="bogus"):
        from_flax(extra)
    cell = {k: v for k, v in params["cell"].items() if k != "attn"}
    cell["attn"] = {"score_v": params["cell"]["attn"]["score_v"]}
    with pytest.raises(KeyError, match="query_proj"):
        from_flax({**params, "cell": cell})


def test_load_params_npz_flat_keys(tmp_path):
    _, _, params = _jax_model()
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v

    walk({"params": params}, "")
    path = tmp_path / "params.npz"
    np.savez(path, **flat)
    loaded = load_params_npz(str(path))
    sd_a, sd_b = from_flax(params), from_flax(loaded)
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)


def test_shift_right_prepends_bos():
    labels = torch.tensor([[5, 6, 7], [8, 0, 0]])
    assert shift_right(labels).tolist() == [[0, 5, 6], [0, 8, 0]]


def test_init_random_is_seeded_and_biases_eos():
    a = CaptionModel(V, [8], embed_size=E, hidden_size=H, attn_size=A)
    b = CaptionModel(V, [8], embed_size=E, hidden_size=H, attn_size=A)
    init_random_(a, 7, eos_bias=0.5)
    init_random_(b, 7)
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        if name == "logit.bias":
            assert pa[0].item() == pytest.approx(0.5)
            assert torch.equal(pa[1:], pb[1:])
        else:
            assert torch.equal(pa, pb), name


def test_vocab_round_trip():
    vocab = Vocab({1: "a", 2: "dog", 3: "runs"})
    assert vocab.size_with_pad == 4
    assert vocab.decode([2, 3, 0, 1]) == "dog runs"
    assert vocab.decode_batch(np.array([[1, 2], [9, 0]])) == ["a dog",
                                                              "<unk>"]
    assert Vocab.from_json(vocab.to_json()).ix_to_word == vocab.ix_to_word
    with pytest.raises(ValueError):
        Vocab({0: "pad"})
