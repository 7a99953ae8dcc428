"""The port's training ops against the reference's: K1's gradients, the
losses, the optimizer, dropout and K2's refusal of grad mode.

Tolerances: gradients within 1e-5 * max(1, max|g_ref|) per tensor
(float32, sums in another order); losses within 1e-6; the optimizer's
parameters within 1e-6 of the optax chain's on identical gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cst_captioning_tpu.ops import losses as jlosses
from cst_captioning_tpu.ops.pallas_attention import \
    fused_additive_attention as jax_fused_attention
from cst_captioning_tpu.training.state import make_optimizer
from cst_captioning_tpu_torch.models.encoder import dropout
from cst_captioning_tpu_torch.ops import attention_kernel as k1
from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2
from cst_captioning_tpu_torch.ops import losses
from cst_captioning_tpu_torch.training.state import Optimizer

B, T, A, H = 6, 5, 16, 16
GRAD_TOL = 1e-5


def assert_grad_close(got, want, name=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= GRAD_TOL * scale, f"{name}: {err} > {GRAD_TOL * scale}"


def _attention_inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, A)).astype(np.float32),
            rng.normal(size=(B, T, A)).astype(np.float32),
            rng.normal(size=(B, T, H)).astype(np.float32),
            (rng.normal(size=(A,)) / A ** 0.5).astype(np.float32)]


@pytest.mark.parametrize("seed", [0, 1])
def test_attention_gradients_match_jax_custom_vjp(seed):
    """The K1 Function's backward against ``jax.grad`` through the
    reference's custom VJP (Pallas forward in interpret mode) and against
    autograd through the plain forward, for a loss that uses both ctx and
    w."""
    args = _attention_inputs(seed)
    rng = np.random.default_rng(100 + seed)
    r_ctx = rng.normal(size=(B, H)).astype(np.float32)
    r_w = rng.normal(size=(B, T)).astype(np.float32)

    def jax_loss(*a):
        ctx, w = jax_fused_attention(*a, interpret=True)
        return jnp.sum(ctx * r_ctx) + jnp.sum(jnp.sin(w) * r_w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in args))

    def torch_grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_() for a in args]
        ctx, w = fn(*leaves)
        (torch.sum(ctx * torch.from_numpy(r_ctx))
         + torch.sum(torch.sin(w) * torch.from_numpy(r_w))).backward()
        return [t.grad.numpy() for t in leaves]

    k1.fused_additive_attention.launches = 0
    got = torch_grads(k1.fused_additive_attention)
    assert k1.fused_additive_attention.launches == 0     # CPU: plain
    plain = torch_grads(k1.additive_attention_plain)
    for name, g, w, p in zip(("q", "proj_mem", "memory", "score_v"), got,
                             want, plain):
        assert_grad_close(g, w, name)
        assert_grad_close(g, p, name)


def test_attention_backward_recomputes_from_inputs():
    """The Function's gradients are exactly ``additive_attention_backward``
    of the inputs and upstream gradients."""
    args = [torch.from_numpy(a) for a in _attention_inputs(3)]
    g = torch.Generator().manual_seed(0)
    g_ctx, g_w = torch.randn(B, H, generator=g), torch.randn(B, T,
                                                              generator=g)
    leaves = [a.clone().requires_grad_() for a in args]
    torch.autograd.backward(list(k1.fused_additive_attention(*leaves)),
                            [g_ctx, g_w])
    for leaf, want in zip(leaves, k1.additive_attention_backward(
            *args, g_ctx, g_w)):
        assert torch.equal(leaf.grad, want)


def test_decode_cell_refuses_grad_mode():
    rng = np.random.default_rng(0)
    e = 8

    def r(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))

    args = [r(B, e), r(B, H), r(B, H), r(B, A), r(B, T, A), r(B, T, H),
            r(A), r(e + 2 * H, 4 * H).requires_grad_(), r(4 * H)]
    with pytest.raises(RuntimeError, match="forward only"):
        k2.fused_decode_cell(*args)
    with torch.no_grad():
        c, h = k2.fused_decode_cell(*args)
    want = k2.decode_cell_plain(*(a.detach() for a in args))
    assert torch.equal(c, want[0]) and torch.equal(h, want[1])


def _loss_inputs(seed=0, n=7, length=6, v=11):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, length, v)).astype(np.float32)
    targets = rng.integers(1, v, size=(n, length)).astype(np.int32)
    targets[0, 2:] = 0
    targets[1, 0] = 0
    targets[2, 4] = 0
    weights = rng.uniform(0.2, 2.0, size=n).astype(np.float32)
    adv = rng.normal(size=n).astype(np.float32)
    return logits, targets, weights, adv


def test_losses_match_reference():
    logits, targets, weights, adv = _loss_inputs()
    tl, tt = torch.from_numpy(logits), torch.from_numpy(targets).long()
    np.testing.assert_array_equal(
        losses.sequence_mask(tt).numpy(),
        np.asarray(jlosses.sequence_mask(jnp.asarray(targets))))
    np.testing.assert_allclose(
        losses.token_logprobs(tl, tt).numpy(),
        np.asarray(jlosses.token_logprobs(jnp.asarray(logits),
                                          jnp.asarray(targets))), atol=1e-6)
    for w in (None, weights):
        got = losses.cross_entropy_loss(
            tl, tt, None if w is None else torch.from_numpy(w))
        want = jlosses.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(targets),
            None if w is None else jnp.asarray(w))
        assert abs(got.item() - float(want)) <= 1e-6
    logp = losses.token_logprobs(tl, tt)
    got = losses.reward_loss(logp, tt, torch.from_numpy(adv))
    want = jlosses.reward_loss(
        jlosses.token_logprobs(jnp.asarray(logits), jnp.asarray(targets)),
        jnp.asarray(targets), jnp.asarray(adv))
    assert abs(got.item() - float(want)) <= 1e-6


def test_reward_loss_gradient_skips_the_advantage():
    logits, targets, _, adv = _loss_inputs(1)
    tl = torch.from_numpy(logits).requires_grad_()
    ta = torch.from_numpy(adv).requires_grad_()
    tt = torch.from_numpy(targets).long()
    losses.reward_loss(losses.token_logprobs(tl, tt), tt, ta).backward()
    assert ta.grad is None

    def jl(lg):
        return jlosses.reward_loss(jlosses.token_logprobs(
            lg, jnp.asarray(targets)), jnp.asarray(targets),
            jnp.asarray(adv))

    assert_grad_close(tl.grad.numpy(), jax.grad(jl)(jnp.asarray(logits)))


@pytest.mark.parametrize("optim,clip,rate,every", [
    ("adam", 0.5, 0.5, 2), ("adam", 0.0, 1.0, 0), ("sgd", 0.3, 0.8, 3),
    ("adamax", 0.5, 0.5, 2), ("adamw", 0.5, 0.5, 2), ("rmsprop", 0.5, 0.5, 2),
    ("adagrad", 0.5, 0.5, 2)])
def test_optimizer_matches_optax_chain(optim, clip, rate, every):
    """Identical gradient sequences through the port's optimizer and the
    reference's optax chain (clip by global norm, staircase decay): the
    parameters agree within 1e-6 after every step, and the port reports
    the pre-clip global norm."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = Optimizer(params, optim=optim, learning_rate=2e-4,
                    grad_clip=clip, decay_rate=rate, decay_every_steps=every)
    tx, _ = make_optimizer(optim, 2e-4, clip, rate, every)
    jparams = [jnp.asarray(p) for p in init]
    state = tx.init(jparams)
    for step in range(6):
        grads = [(rng.normal(size=s) * (0.05 if step % 2 else 1.0))
                 .astype(np.float32) for s in shapes]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = opt.step()
        assert abs(norm.item() - float(optax.global_norm(
            [jnp.asarray(g) for g in grads]))) <= 1e-6
        updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, jp in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                       rtol=0, atol=1e-6)
    assert opt.count == 6


def test_optimizer_refuses_unported_optimizers():
    """Every optimizer of the reference's ``--optim`` is ported; a name
    outside that set raises, listing the six."""
    with pytest.raises(ValueError, match="adamax"):
        Optimizer([torch.nn.Parameter(torch.zeros(2))], optim="lamb")


def test_dropout_keeps_and_scales_like_flax():
    x = torch.ones(4000)
    out = dropout(x, 0.5, torch.Generator().manual_seed(0))
    kept = out != 0
    assert torch.equal(out[kept], torch.full_like(out[kept], 2.0))
    assert 0.45 < kept.float().mean().item() < 0.55
    again = dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, None)
