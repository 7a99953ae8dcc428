"""Port's additive attention (K1) against the reference's Pallas kernel.

The JAX side runs ``fused_additive_attention`` in interpret mode; the
port side runs its plain version, which is what the wrapper takes for
CPU tensors.  Same numpy inputs, float32, within 1e-5 abs.  The kernel
itself is held against the plain version on the card in
``test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.ops.attention import AdditiveAttention as JaxAttention
from cst_captioning_tpu.ops.pallas_attention import \
    fused_additive_attention as jax_fused_attention
from cst_captioning_tpu_torch.ops import attention_kernel as k1
from cst_captioning_tpu_torch.ops.attention import AdditiveAttention

B, T, A, H = 6, 4, 16, 16
TOL = 1e-5


def _inputs(seed=0, b=B):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, A)).astype(np.float32),
            rng.normal(size=(b, T, A)).astype(np.float32),
            rng.normal(size=(b, T, H)).astype(np.float32),
            (rng.normal(size=(A,)) / A ** 0.5).astype(np.float32))


@pytest.mark.parametrize("seed,block_b", [(0, 8), (1, 4), (2, 1)])
def test_plain_matches_pallas_interpret(seed, block_b):
    args = _inputs(seed)
    ctx_j, w_j = jax_fused_attention(*(jnp.asarray(a) for a in args),
                                     block_b=block_b, interpret=True)
    ctx_t, w_t = k1.additive_attention_plain(
        *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=TOL)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    args = [torch.from_numpy(a) for a in _inputs(3)]
    k1.fused_additive_attention.launches = 0
    ctx, w = k1.fused_additive_attention(*args)
    ref_ctx, ref_w = k1.additive_attention_plain(*args)
    assert torch.equal(ctx, ref_ctx) and torch.equal(w, ref_w)
    assert k1.fused_additive_attention.launches == 0
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_wrapper_refuses_non_float32():
    args = [torch.from_numpy(a).double() for a in _inputs(4)]
    with pytest.raises(TypeError, match="float32"):
        k1.fused_additive_attention(*args)


def test_attention_module_matches_flax_module():
    """Module level: query projection + attention, weights converted from
    the flax ``AdditiveAttention`` (kernel transposed, bare score_v)."""
    q, pm, mem, _ = _inputs(5)
    jmod = JaxAttention(A)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(mem[:, 0]),
                          jnp.asarray(mem), jnp.asarray(pm))
    p = jax.tree_util.tree_map(np.asarray, variables["params"])
    ctx_j, w_j = jmod.apply(variables, jnp.asarray(q[:, :H]),
                            jnp.asarray(mem), jnp.asarray(pm))
    for use_kernel in (False, True):
        tmod = AdditiveAttention(H, A, use_kernel=use_kernel)
        tmod.load_state_dict({
            "query_proj.weight": torch.from_numpy(
                p["query_proj"]["kernel"].T.copy()),
            "score_v": torch.from_numpy(p["score_v"].copy())})
        with torch.no_grad():
            ctx_t, w_t = tmod(torch.from_numpy(q[:, :H]),
                              torch.from_numpy(mem), torch.from_numpy(pm))
        np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                                   atol=TOL)
