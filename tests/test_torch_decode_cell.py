"""Port's decode cell (K2) against the reference's Pallas decode cell.

The JAX side runs ``fused_decode_cell`` in interpret mode; the port side
runs ``decode_cell_plain`` (the wrapper's CPU path) on the same numpy
inputs, with the gate weights in the reference's ``(in, out)`` layout
stacked as ``[W_i; W_h]``.  float32, c' and h' within 1e-5 abs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.ops.pallas_decode_cell import \
    fused_decode_cell as jax_fused_decode_cell
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2
from cst_captioning_tpu_torch.ops.sampling import make_decode_step

B, T, H, E, A, V = 6, 4, 16, 12, 16, 30
TOL = 1e-5


def _inputs(seed=0, b=B):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(x=r(b, E), c=r(b, H), h=np.tanh(r(b, H)), q=r(b, A),
                proj_mem=r(b, T, A), memory=r(b, T, H),
                score_v=r(A, scale=A ** -0.5),
                wi=r(E + H, 4 * H, scale=(E + H) ** -0.5),
                wh=r(H, 4 * H, scale=H ** -0.5), bias=r(4 * H, scale=0.1))


def _port_args(d):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    w = torch.cat([t["wi"], t["wh"]], dim=0)
    return (t["x"], t["c"], t["h"], t["q"], t["proj_mem"], t["memory"],
            t["score_v"], w, t["bias"])


@pytest.mark.parametrize("seed,block_b", [(0, 8), (1, 4), (2, 1)])
def test_plain_matches_pallas_interpret(seed, block_b):
    d = _inputs(seed)
    c_j, h_j = jax_fused_decode_cell(
        *(jnp.asarray(d[k]) for k in ("x", "c", "h", "q", "proj_mem",
                                      "memory", "score_v", "wi", "wh",
                                      "bias")),
        block_b=block_b, interpret=True)
    c_t, h_t = k2.decode_cell_plain(*_port_args(d))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0,
                               atol=TOL)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    args = _port_args(_inputs(3))
    k2.fused_decode_cell.launches = 0
    got = k2.fused_decode_cell(*args)
    want = k2.decode_cell_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert k2.fused_decode_cell.launches == 0


def test_wrapper_refuses_non_float32():
    args = [a.double() for a in _port_args(_inputs(4))]
    with pytest.raises(TypeError, match="float32"):
        k2.fused_decode_cell(*args)


@pytest.mark.parametrize("kw,reason", [
    (dict(num_layers=2), "num_layers"),
    (dict(use_attention=False), "use_attention"),
])
def test_ineligible_model_with_fused_cell_raises(kw, reason):
    """No silent fallback to the reference cell: an ineligible model
    asked for the fused cell is refused, at construction and at bind."""
    with pytest.raises(ValueError, match=reason):
        CaptionModel(V, [8], embed_size=E, hidden_size=H, attn_size=A,
                     decode_kernel="fused", **kw)
    model = CaptionModel(V, [8], embed_size=E, hidden_size=H, attn_size=A,
                         **kw)
    assert k2.fused_decode_supported(model)[0] is False
    model.decode_kernel = "fused"
    mem = torch.zeros(1, T, H)
    with pytest.raises(ValueError, match=reason):
        make_decode_step(model, mem, torch.zeros(1, T, A), torch.zeros(1, H))


def test_fused_step_matches_reference_step():
    """The bound fused step (embedding, W_q h and vocab head around the
    cell) gives the reference cell's logits and carry."""
    torch.manual_seed(0)
    ref = CaptionModel(V, [8], embed_size=E, hidden_size=H, attn_size=A)
    for p in ref.parameters():
        torch.nn.init.normal_(p, std=0.3)
    fused = CaptionModel(V, [8], embed_size=E, hidden_size=H, attn_size=A,
                         decode_kernel="fused")
    fused.load_state_dict(ref.state_dict())
    feats = [torch.randn(B, T, 8)]
    with torch.no_grad():
        mem, pm, pooled = ref.encode(feats)
        tok = torch.arange(B) % (V - 1) + 1
        outs = []
        for model in (ref, fused):
            step = make_decode_step(model, mem, pm, pooled)
            carry = model.init_carry(pooled)
            for _ in range(3):
                carry, logits = step(carry, tok)
            outs.append((carry[0][0], carry[0][1], logits))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL)
