"""Port's greedy and beam decoders against the reference's, token for
token, with the reference on its Pallas decode cell (interpret mode) and
the port on its fused cell (the plain version on the CPU) or its
reference cell.  The chunked early exit must give the full-length loop's
tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.ops.beam import beam_search as jax_beam_search
from cst_captioning_tpu.ops.sampling import greedy_decode as jax_greedy
from cst_captioning_tpu_torch.ops.beam import beam_search
from cst_captioning_tpu_torch.ops.sampling import (all_finished,
                                                   finished_mask,
                                                   greedy_decode,
                                                   make_decode_step,
                                                   sample_tokens)
from cst_captioning_tpu_torch.weights import model_from_flax

B, H, E, A, V, L = 6, 16, 12, 16, 30, 8
FEAT_SHAPES = ((4, 8), (1, 5))
EOS_BIAS = 0.4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    feats = [(rng.normal(size=(B,) + s) * 2.0).astype(np.float32)
             for s in FEAT_SHAPES]
    jm = JaxCaptionModel(vocab_size=V, embed_size=E, hidden_size=H,
                         attn_size=A, dropout_rate=0.0,
                         decode_kernel="pallas")
    jfeats = [jnp.asarray(f) for f in feats]
    variables = jm.init(jax.random.PRNGKey(0), jfeats,
                        np.zeros((B, L), np.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["logit"]["bias"] = params["logit"]["bias"].copy()
    params["logit"]["bias"][0] += EOS_BIAS
    variables = {"params": params}
    return jm, variables, params, feats, jfeats


def _port(params, kernel):
    return model_from_flax(params, device="cpu", decode_kernel=kernel)


@pytest.mark.parametrize("kernel", ["fused", "reference"])
def test_greedy_tokens_identical_to_reference(setup, kernel):
    jm, variables, params, feats, jfeats = setup
    want = np.asarray(jax_greedy(jm, variables, jfeats, L))
    got = greedy_decode(_port(params, kernel),
                        [torch.from_numpy(f) for f in feats], L)
    np.testing.assert_array_equal(got.numpy(), want)
    lengths = (want != 0).cumprod(axis=1).sum(axis=1)
    assert len(set(lengths.tolist())) > 1, "captions should end mixed"


@pytest.mark.parametrize("kernel,length_norm", [("fused", 0.0),
                                                 ("fused", 0.7),
                                                 ("reference", 0.0)])
def test_beam3_tokens_identical_to_reference(setup, kernel, length_norm):
    jm, variables, params, feats, jfeats = setup
    best_j, beams_j, scores_j = jax_beam_search(
        jm, variables, jfeats, beam_size=3, max_len=L,
        length_norm=length_norm)
    best, beams, scores = beam_search(
        _port(params, kernel), [torch.from_numpy(f) for f in feats], 3, L,
        length_norm=length_norm)
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_j))
    np.testing.assert_array_equal(beams.numpy(), np.asarray(beams_j))
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_j),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [1, 3, 5])
def test_greedy_chunked_early_exit_matches_full_loop(setup, chunk):
    _, _, params, feats, _ = setup
    model = _port(params, "fused")
    tfeats = [torch.from_numpy(f) for f in feats]
    full = greedy_decode(model, tfeats, L)
    mem, pm, pooled = model.encode(tfeats)
    step = make_decode_step(model, mem, pm, pooled)
    toks, logps, steps = sample_tokens(step, model.init_carry(pooled), B,
                                       L, decode_chunk=chunk,
                                       return_steps=True)
    assert torch.equal(toks, full)
    assert steps <= L and (steps % chunk == 0 or steps == L)
    # The first EOS keeps its log-prob; everything after it is 0.
    eos = (toks == 0).long()
    past_eos = (torch.cumsum(eos, dim=1) - eos) > 0
    assert bool((logps[past_eos] == 0).all())
    assert bool((logps[~past_eos] < 0).all())


def test_greedy_early_exit_stops_once_every_row_finished(setup):
    _, _, params, feats, _ = setup
    params = {**params, "logit": {**params["logit"]}}
    params["logit"]["bias"] = params["logit"]["bias"].copy()
    params["logit"]["bias"][0] += 50.0              # EOS at step 0
    model = _port(params, "fused")
    tfeats = [torch.from_numpy(f) for f in feats]
    mem, pm, pooled = model.encode(tfeats)
    step = make_decode_step(model, mem, pm, pooled)
    toks, _, steps = sample_tokens(step, model.init_carry(pooled), B, L,
                                   decode_chunk=2, return_steps=True)
    assert steps == 2 and not toks.any()


@pytest.mark.parametrize("chunk", [2, 3])
def test_beam_chunked_early_exit_matches_full_loop(setup, chunk):
    _, _, params, feats, _ = setup
    model = _port(params, "fused")
    tfeats = [torch.from_numpy(f) for f in feats]
    full = beam_search(model, tfeats, 3, L, length_norm=0.7)
    fast = beam_search(model, tfeats, 3, L, length_norm=0.7,
                       decode_chunk=chunk)
    for a, b in zip(full, fast):
        assert torch.equal(a, b)


def test_finished_mask_shapes():
    rows = torch.tensor([True, False, True])
    assert finished_mask(rows).tolist() == [True, False, True]
    beams = torch.tensor([[True, True], [True, False]])
    assert finished_mask(beams).tolist() == [True, False]
    assert not bool(all_finished(beams))
    assert bool(all_finished(torch.tensor([[True], [True]])))
