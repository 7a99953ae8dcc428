"""The port's multinomial sampler and CST rollout against the reference's.

Both sides draw with the same Gumbel noise: the reference's
``jax.random.categorical`` adds ``jax.random.gumbel(k_t, (N, V))`` at step
t, with ``k = jax.random.split(rng, L)``; the port's sampler takes the
same arrays through its noise hook.  Tokens must be identical, log-probs
within 1e-5, for the full-length rollout and the chunked early exit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.ops import sampling as jsampling
from cst_captioning_tpu_torch.ops import sampling
from cst_captioning_tpu_torch.weights import model_from_flax

B, S, H, E, A, V, L = 4, 3, 16, 12, 16, 30, 8
FEAT_SHAPES = ((4, 8), (1, 5))
EOS_BIAS = 1.0


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    feats = [(rng.normal(size=(B,) + s) * 2.0).astype(np.float32)
             for s in FEAT_SHAPES]
    jm = JaxCaptionModel(vocab_size=V, embed_size=E, hidden_size=H,
                         attn_size=A, dropout_rate=0.0)
    jfeats = [jnp.asarray(f) for f in feats]
    variables = jm.init(jax.random.PRNGKey(0), jfeats,
                        np.zeros((B, L), np.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["logit"]["bias"] = params["logit"]["bias"].copy()
    params["logit"]["bias"][0] += EOS_BIAS     # rows end at mixed lengths
    return jm, {"params": params}, params, feats, jfeats


def jax_noise(rng, n):
    """The port's noise hook fed the reference's Gumbel draws."""
    keys = jax.random.split(rng, L)

    def noise(t, shape):
        assert tuple(shape) == (n, V)
        return torch.from_numpy(np.array(
            jax.random.gumbel(keys[t], tuple(shape), jnp.float32)))

    return noise


@pytest.mark.parametrize("kernel", ["reference", "fused"])
@pytest.mark.parametrize("chunk", [0, 3])
def test_sample_with_baseline_matches_reference(setup, kernel, chunk):
    jm, variables, params, feats, jfeats = setup
    rng = jax.random.PRNGKey(7)
    want = jsampling.sample_with_baseline(
        jm, variables, jfeats, rng, L, seq_per_img=S, decode_chunk=chunk,
        return_steps=True)
    model = model_from_flax(params, device="cpu", decode_kernel=kernel)
    got = sampling.sample_with_baseline(
        model, [torch.from_numpy(f) for f in feats], L, S,
        noise=jax_noise(rng, B * S + B), decode_chunk=chunk,
        return_steps=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[3] == int(want[3])
    lengths = (np.asarray(want[0]) != 0).cumprod(axis=1).sum(axis=1)
    assert len(set(lengths.tolist())) > 1, "samples should end mixed"


@pytest.mark.parametrize("temperature,chunk", [(1.0, 0), (0.7, 3)])
def test_sample_captions_matches_reference(setup, temperature, chunk):
    jm, variables, params, feats, jfeats = setup
    rng = jax.random.PRNGKey(3)
    want = jsampling.sample_captions(
        jm, variables, jfeats, rng, L, seq_per_img=S, greedy=False,
        temperature=temperature, decode_chunk=chunk)
    model = model_from_flax(params, device="cpu")
    got = sampling.sample_captions(
        model, [torch.from_numpy(f) for f in feats], L, seq_per_img=S,
        temperature=temperature, noise=jax_noise(rng, B * S),
        decode_chunk=chunk)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=1e-5)


def test_per_row_greedy_rows_take_the_argmax(setup):
    """Greedy rows of a mixed rollout equal a greedy-only decode."""
    _, _, params, feats, _ = setup
    model = model_from_flax(params, device="cpu", decode_kernel="fused")
    tfeats = [torch.from_numpy(f) for f in feats]
    noise = sampling.gumbel_noise(torch.Generator().manual_seed(0))
    _, _, greedy = sampling.sample_with_baseline(model, tfeats, L, S,
                                                 noise=noise)
    assert torch.equal(greedy, sampling.greedy_decode(model, tfeats, L))


def test_gumbel_noise_is_seeded_and_finite():
    a = sampling.gumbel_noise(torch.Generator().manual_seed(1))(0, (64, 50))
    b = sampling.gumbel_noise(torch.Generator().manual_seed(1))(0, (64, 50))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    assert abs(a.mean().item() - 0.5772) < 0.05      # Euler's constant


def test_multinomial_needs_noise(setup):
    _, _, params, feats, _ = setup
    model = model_from_flax(params, device="cpu")
    with pytest.raises(ValueError, match="noise"):
        sampling.sample_captions(model, [torch.from_numpy(f) for f in feats],
                                 L)


def test_reference_bfloat16_gumbel_noise_is_capped():
    """Why the port's float32 CST samples differ from the reference
    chain's: ``jax.random.categorical`` draws its Gumbel noise in the
    logits' dtype, and in bfloat16 (the recorded chain's) the noise never
    exceeds 5 in 10^6 draws, where float32 noise (the port's) passes 10:
    a sampler sharper than the softmax."""
    key = jax.random.PRNGKey(0)
    bf16 = jax.random.gumbel(key, (1000, 1000), jnp.bfloat16)
    f32 = jax.random.gumbel(key, (1000, 1000), jnp.float32)
    assert float(bf16.astype(jnp.float32).max()) < 5.0
    assert float(f32.max()) > 10.0
    port = sampling.gumbel_noise(torch.Generator().manual_seed(0))(
        0, (1000, 1000))
    assert port.max().item() > 10.0


def test_bfloat16_gumbel_noise_takes_the_reference_values():
    """The noise of a bfloat16 model (``--use_bfloat16 1``): the port's
    draw takes exactly the 128 values ``jax.random.gumbel`` takes in
    bfloat16 (all of them appear in 10^6 draws on both sides), is seeded,
    and comes back in bfloat16, the logits' dtype."""
    want = np.unique(np.asarray(jax.random.gumbel(
        jax.random.PRNGKey(0), (1000, 1000), jnp.bfloat16)
        .astype(jnp.float32)))
    draw = sampling.gumbel_noise(torch.Generator().manual_seed(0),
                                 dtype=torch.bfloat16)
    port = draw(0, (1000, 1000))
    assert port.dtype == torch.bfloat16
    assert len(want) == 128
    np.testing.assert_array_equal(np.unique(port.float().numpy()), want)
    again = sampling.gumbel_noise(torch.Generator().manual_seed(0),
                                  dtype=torch.bfloat16)(0, (1000, 1000))
    assert torch.equal(port, again)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sampling.gumbel_noise(torch.Generator(), dtype=torch.float16)
