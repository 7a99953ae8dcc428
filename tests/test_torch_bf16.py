"""The port's bfloat16 compute (``--use_bfloat16``) against the
reference's flax ``dtype=bfloat16`` over float32 parameters, on the CPU.

Inputs are made from a seed with numpy; the port's weights come from the
reference's parameter tree through ``weights.from_flax``.  Everything is
compared in float32.  Two ways of running the reference, two tolerances:

- **Op by op** (``jax.disable_jit()``): every XLA op rounds its result to
  bfloat16 and the transcendental functions are the host library's.  Run
  so, the reference and the port are the SAME function: the encoder, the
  attention, the decode step and the teacher-forced logits agree bit for
  bit, which is what "rounds where flax rounds" means.
- **Compiled**, as the reference runs: XLA's own float32 tanh and exp in
  the attention differ from the host library's in the last float32 bits,
  and a bfloat16 rounding of such a value moves by one ulp now and then.
  Tensors within ``2 * ulp`` of their magnitude (``ulp = 2 **
  (floor(log2 max|x|) - 7)``, bfloat16's 8-bit significand); losses
  within 1e-2 relative; gradients within ``2e-2 * max|g|`` per tensor;
  greedy tokens identical wherever the reference's top-2 logit margin
  exceeds twice the logit tolerance.

Where the reference reaches a Pallas kernel it runs in interpret mode, as
its own tests run it on the CPU.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.models.decoder_lstm import DecoderCell as JaxCell
from cst_captioning_tpu.models.encoder import FeatureEncoder as JaxEncoder
from cst_captioning_tpu.ops import bf16_decode as jbf16
from cst_captioning_tpu.ops import jax_ciderd
from cst_captioning_tpu.ops import sampling as jsampling
from cst_captioning_tpu.ops.attention import AdditiveAttention as JaxAttn
from cst_captioning_tpu.ops.losses import cross_entropy_loss as jax_xe
from cst_captioning_tpu.ops.pallas_attention import \
    fused_additive_attention as jax_k1
from cst_captioning_tpu.ops.pallas_decode_cell import \
    fused_decode_cell as jax_k2
from cst_captioning_tpu.training import device_rewards as jax_builder
from cst_captioning_tpu.training.state import TrainState, make_optimizer
from cst_captioning_tpu.training.steps import make_fused_cst_step
from cst_captioning_tpu_torch.ops import attention_kernel as k1
from cst_captioning_tpu_torch.ops import bf16_decode
from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2
from cst_captioning_tpu_torch.ops.losses import cross_entropy_loss
from cst_captioning_tpu_torch.ops.sampling import (greedy_decode,
                                                   make_decode_step)
from cst_captioning_tpu_torch.training import device_rewards, steps
from cst_captioning_tpu_torch.training.state import Optimizer
from cst_captioning_tpu_torch.weights import from_flax, model_from_flax

B, S, H, E, A, V, L = 4, 3, 16, 16, 16, 15, 8
FEAT_SHAPES = ((4, 8), (1, 5))
BF16 = torch.bfloat16
ULPS = 2             # tensors: this many bfloat16 ulps of their magnitude
LOSS_REL = 1e-2      # losses: relative
GRAD_REL = 2e-2      # gradients: of each tensor's largest |g|
WORDS = [f"w{i}" for i in range(V - 1)]
W2I = {w: i + 1 for i, w in enumerate(WORDS)}


def ulp(x) -> float:
    """One bfloat16 ulp at the magnitude of ``x`` (its largest |value|)."""
    m = float(np.abs(np.asarray(x, np.float32)).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_ulps(got, want, ulps=ULPS):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= ulps * ulp(want), (err, ulps * ulp(want))


def assert_same(got, want):
    np.testing.assert_array_equal(f32(got), f32(want))


def _data(seed=0, b=B):
    rng = np.random.default_rng(seed)
    feats = [(rng.normal(size=(b,) + s) * 1.5).astype(np.float32)
             for s in FEAT_SHAPES]
    labels = rng.integers(1, V, size=(b * S, L)).astype(np.int32)
    labels[0, 3:] = 0
    labels[4, 6:] = 0
    weights = rng.uniform(0.3, 1.8, size=b * S).astype(np.float32)
    return feats, labels, weights


def _models(use_kernel=False, eos_bias=0.0, seed=0):
    """(reference model, its params as numpy, the port's model) over the
    same float32 parameters, both computing in bfloat16."""
    feats, labels, _ = _data()
    jm = JaxCaptionModel(vocab_size=V, embed_size=E, hidden_size=H,
                         attn_size=A, dropout_rate=0.0,
                         dtype=jnp.bfloat16,
                         use_pallas_attention=use_kernel)
    params = jm.init(jax.random.PRNGKey(seed),
                     [jnp.asarray(f) for f in feats], labels, S)["params"]
    params = jax.tree_util.tree_map(np.array, params)
    params["logit"]["bias"][0] += eos_bias
    tm = model_from_flax(params, device="cpu", dtype=BF16, drop_prob=0.0,
                         use_kernel_attention=use_kernel,
                         decode_kernel="fused" if use_kernel
                         else "reference")
    return jm, params, tm


def _t(arrays, dtype=None):
    out = [torch.from_numpy(np.asarray(a)) for a in arrays]
    return [o.to(dtype) for o in out] if dtype is not None else out


# -- the encoder, the attention and the decode cell ------------------------

def _module_outputs(which, jit):
    """(reference outputs, port outputs) of one module in bfloat16."""
    jm, params, tm = _models()
    feats, _, _ = _data(1)
    jfeats = [jnp.asarray(f) for f in feats]

    def run(f, *args):
        if jit:
            return jax.jit(f)(*args)
        with jax.disable_jit():
            return f(*args)

    with torch.no_grad():
        mem_t, pm_t, pooled_t = tm.encode(_t(feats))
        carry_t = tm.init_carry(pooled_t)
    variables = {"params": params}
    if which == "encoder":
        enc = JaxEncoder(H, dtype=jnp.bfloat16)
        want = run(lambda v, f: enc.apply(v, f),
                   {"params": params["encoder"]}, jfeats)
        return want, (mem_t, pooled_t)
    with jax.disable_jit():
        mem_j, pm_j, pooled_j = jm.apply(variables, jfeats, method="encode")
        carry_j = jm.apply(variables, pooled_j, method="init_carry")
    if which == "attention":
        attn = JaxAttn(A, dtype=jnp.bfloat16)
        want = run(lambda v, q, m, p: attn.apply(v, q, m, p),
                   {"params": params["cell"]["attn"]}, carry_j[0][1],
                   mem_j, pm_j)
        with torch.no_grad():
            got = tm.cell.attn(carry_t[0][1], mem_t, pm_t)
        return want, got
    cell = JaxCell(vocab_size=V, embed_size=E, hidden_size=H, attn_size=A,
                   dtype=jnp.bfloat16)
    tok = np.asarray([0, 3, 7, 1], np.int32)
    (c_j, h_j), = run(lambda v, c, t, m, p, po: cell.apply(
        v, c, t, m, p, po)[0], {"params": params["cell"]}, carry_j,
        jnp.asarray(tok), mem_j, pm_j, pooled_j)
    with torch.no_grad():
        (c_t, h_t), = tm.cell(carry_t, torch.from_numpy(tok).long(), mem_t,
                              pm_t, pooled_t)[0]
    return (c_j, h_j), (c_t, h_t)


@pytest.mark.parametrize("which", ["encoder", "attention", "cell"])
def test_module_bit_identical_to_reference_op_by_op(which):
    want, got = _module_outputs(which, jit=False)
    for g, w in zip(got, want):
        assert g.dtype == BF16
        assert_same(g, w)


@pytest.mark.parametrize("which", ["encoder", "attention", "cell"])
def test_module_within_two_ulps_of_compiled_reference(which):
    want, got = _module_outputs(which, jit=True)
    for g, w in zip(got, want):
        assert_ulps(g, w)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "k1-k2"])
def test_teacher_forced_logits_and_decode_step(use_kernel):
    """Teacher-forced logits and one decode step (carry and logits) of the
    whole model: bit-identical to the reference op by op, within two ulps
    compiled (the reference's attention in interpret-mode Pallas for the
    kernel route; the port's K1 and K2 through their wrappers' CPU
    route)."""
    jm, params, tm = _models(use_kernel)
    feats, labels, _ = _data(2)
    variables = {"params": params}
    jfeats = [jnp.asarray(f) for f in feats]
    with torch.no_grad():
        logits_t = tm(_t(feats), torch.from_numpy(labels).long(), S)
        mem, pm, pooled = tm.encode(_t(feats))
        step = make_decode_step(tm, mem, pm, pooled)
        carry_t, step_t = step(tm.init_carry(pooled),
                               torch.tensor([0, 5, 9, 2]))
    assert logits_t.dtype == step_t.dtype == BF16

    def reference():
        logits = jm.apply(variables, jfeats, labels, S, train=False)
        m, p, po = jm.apply(variables, jfeats, method="encode")
        jstep = jsampling.make_decode_step(jm, variables, m, p, po)
        carry, out = jstep(jm.apply(variables, po, method="init_carry"),
                           jnp.asarray([0, 5, 9, 2], jnp.int32))
        return logits, carry, out

    logits_j, carry_j, step_j = reference()
    for g, w in ((logits_t, logits_j), (step_t, step_j),
                 (carry_t[0][0], carry_j[0][0]),
                 (carry_t[0][1], carry_j[0][1])):
        assert_ulps(g, w)
    if not use_kernel:
        with jax.disable_jit():
            logits_e, carry_e, step_e = reference()
        assert_same(logits_t, logits_e)
        assert_same(step_t, step_e)
        assert_same(carry_t[0][0], carry_e[0][0])


# -- the kernels' plain versions against the interpret-mode kernels -------

def _attention_inputs(seed, b=6, t=5):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return (r(b, A), r(b, t, A), r(b, t, H), r(A, scale=A ** -0.5),
            r(b, H), r(b, t))


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_plain_matches_pallas_interpret_in_bf16(seed):
    """K1 in bfloat16 storage (q, proj_mem, memory bfloat16; score_v
    float32): the port's CPU route (plain forward, the autograd Function's
    plain backward) against ``fused_additive_attention(interpret=True)``
    and its custom VJP, upstream gradients in bfloat16."""
    q, pm, mem, v, g_ctx, g_w = _attention_inputs(seed)
    bf = jnp.bfloat16
    jargs = (jnp.asarray(q, bf), jnp.asarray(pm, bf), jnp.asarray(mem, bf),
             jnp.asarray(v))
    (ctx_j, w_j), vjp = jax.vjp(
        lambda *a: jax_k1(*a, 8, True), *jargs)
    grads_j = vjp((jnp.asarray(g_ctx, bf), jnp.asarray(g_w, bf)))
    leaves = [x.requires_grad_() for x in
              _t((q, pm, mem), BF16) + _t((v,))]
    ctx_t, w_t = k1.fused_additive_attention(*leaves)
    assert ctx_t.dtype == w_t.dtype == BF16 and ctx_j.dtype == bf
    assert_ulps(ctx_t, ctx_j)
    assert_ulps(w_t, w_j)
    torch.autograd.backward([ctx_t, w_t], _t((g_ctx, g_w), BF16))
    for leaf, want in zip(leaves, grads_j):
        assert leaf.grad.dtype == leaf.dtype
        want = f32(want)
        err = float(np.abs(f32(leaf.grad) - want).max())
        assert err <= GRAD_REL * float(np.abs(want).max()), err


@pytest.mark.parametrize("seed,block_b", [(0, 8), (1, 4)])
def test_k2_plain_matches_pallas_interpret_in_bf16(seed, block_b):
    """K2 with bfloat16 weights and state (the reference prepares its
    weights in the model dtype): the port's plain version against
    ``fused_decode_cell(interpret=True)``, c' and h' within two ulps."""
    rng = np.random.default_rng(seed)
    b, t = 6, 5

    def r(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    d = dict(x=r(b, E), c=r(b, H), h=np.tanh(r(b, H)), q=r(b, A),
             proj_mem=r(b, t, A), memory=r(b, t, H),
             wi=r(E + H, 4 * H, scale=(E + H) ** -0.5),
             wh=r(H, 4 * H, scale=H ** -0.5), bias=r(4 * H, scale=0.1))
    v = r(A, scale=A ** -0.5)
    bf = jnp.bfloat16
    c_j, h_j = jax_k2(*(jnp.asarray(d[k], bf) for k in
                        ("x", "c", "h", "q", "proj_mem", "memory")),
                      jnp.asarray(v),
                      *(jnp.asarray(d[k], bf) for k in ("wi", "wh", "bias")),
                      block_b=block_b, interpret=True)
    t_ = {k: torch.from_numpy(a).to(BF16) for k, a in d.items()}
    c_t, h_t = k2.decode_cell_plain(
        t_["x"], t_["c"], t_["h"], t_["q"], t_["proj_mem"], t_["memory"],
        torch.from_numpy(v), torch.cat([t_["wi"], t_["wh"]]), t_["bias"])
    assert c_t.dtype == h_t.dtype == BF16
    assert_ulps(c_t, c_j)
    assert_ulps(h_t, h_j)


# -- training: the teacher-forced losses and the fused CST step -------------

@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "k1"])
@pytest.mark.parametrize("weighted", [False, True], ids=["xe", "wxe"])
def test_xe_wxe_loss_and_gradients(weighted, use_kernel):
    """One teacher-forced XE (WXE: consensus weights) loss and its float32
    parameter gradients against ``jax.value_and_grad`` of the compiled
    reference: loss within 1e-2 relative, every gradient within 2e-2 of
    its tensor's largest |g|."""
    jm, params, tm = _models(use_kernel)
    feats, labels, weights = _data(3)
    w = weights if weighted else None
    jfeats = [jnp.asarray(f) for f in feats]

    def loss_fn(p):
        logits = jm.apply({"params": p}, jfeats, labels, S, train=False)
        return jax_xe(logits, labels, None if w is None else jnp.asarray(w))

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
    logits = tm(_t(feats), torch.from_numpy(labels).long(), S)
    loss = cross_entropy_loss(logits, torch.from_numpy(labels).long(),
                              None if w is None else torch.from_numpy(w))
    assert loss.dtype == torch.float32
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= LOSS_REL * abs(float(loss_j))
    want = from_flax(jax.tree_util.tree_map(np.asarray, grads_j))
    for name, p in tm.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        ref = want[name].numpy()
        err = float(np.abs(p.grad.numpy() - ref).max())
        assert err <= GRAD_REL * float(np.abs(ref).max()), (name, err)


def _refs():
    rng = np.random.default_rng(2)
    return {f"v{v}": [" ".join(rng.choice(WORDS, int(rng.integers(2, 8))))
                      for _ in range(int(rng.integers(2, 6)))]
            for v in range(B + 2)}


def jax_noise(rng, n):
    """The port's noise hook fed the reference's bfloat16 Gumbel draws
    (``jax.random.categorical`` on bfloat16 logits)."""
    keys = jax.random.split(rng, L)

    def noise(t, shape):
        assert tuple(shape) == (n, V)
        return torch.from_numpy(np.array(jax.random.gumbel(
            keys[t], tuple(shape), jnp.bfloat16).astype(jnp.float32))
        ).to(BF16)

    return noise


@pytest.mark.parametrize("baseline", ["greedy"])
def test_fused_cst_step_under_the_same_gumbel_draws(baseline):
    """One fused CST step (K1 and K2 routes, SGD) against the reference's
    ``make_fused_cst_step`` run op by op, both drawing the reference's
    bfloat16 Gumbel noise: the same sampled tokens, the reward, baseline
    and advantage within 1e-5 (float32 CIDEr-D of the same tokens), the
    loss within 1e-2 relative, and every parameter's update (the rate
    times the clipped gradient) within 2e-2 of the largest update of the
    step.  Per tensor the updates agree within 2.4e-2 of their own largest
    (``state_init``, where the backward of every step of the recurrence
    ends): the two backwards round their bfloat16 cotangents at other
    places (the reference rounds each op of a VJP, autograd's fused
    backward kernels once), and the REINFORCE gradient is a sum of terms
    of both signs."""
    refs = _refs()
    jm, params, tm = _models(use_kernel=True, eos_bias=1.0)
    jm = jm.clone(use_pallas_attention=False)
    rng = np.random.default_rng(4)
    feats = [(rng.normal(size=(B,) + s) * 2.0).astype(np.float32)
             for s in FEAT_SHAPES]
    vix = np.asarray([5, 0, 3, 1], np.int64)
    jc, jt, _ = jax_builder.build_device_tables(refs, W2I)
    tc, tt, _ = device_rewards.build_device_tables(refs, W2I)
    key = jax.random.PRNGKey(9)
    lr = 0.05
    tx, _ = make_optimizer("sgd", lr, 5.0)
    state = TrainState.create(apply_fn=jm.apply, params=params, tx=tx)
    fused = make_fused_cst_step(jm, L, S, jc, jt, baseline=baseline,
                                guard=True, decode_chunk=3)
    jfeats = [jnp.asarray(f) for f in feats]
    with jax.disable_jit():
        new_state, jmet = fused(state, jfeats, vix.astype(np.int32), key)
        if baseline == "greedy":
            jsampled, _, jgreedy = jsampling.sample_with_baseline(
                jm, {"params": params}, jfeats, key, L, seq_per_img=S,
                decode_chunk=3)
        else:
            jsampled, _ = jsampling.sample_captions(
                jm, {"params": params}, jfeats, key, L, seq_per_img=S,
                greedy=False, decode_chunk=3)
        jr = np.asarray(jax_ciderd.ciderd_scores(
            jsampled, np.repeat(vix, S).astype(np.int32), jc, jt))
    n_rows = B * S + (B if baseline == "greedy" else 0)
    tfeats = _t(feats)
    sampled, _, _ = steps.rollout(tm, tfeats, L, S, jax_noise(key, n_rows),
                                  greedy_baseline=baseline == "greedy",
                                  decode_chunk=3)
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(jsampled))
    lengths = (np.asarray(jsampled) != 0).cumprod(axis=1).sum(axis=1)
    assert len(set(lengths.tolist())) > 1, "samples should end mixed"
    opt = Optimizer(tm.parameters(), optim="sgd", learning_rate=lr,
                    grad_clip=5.0)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    m = steps.fused_cst_step(tm, opt, tfeats, torch.from_numpy(vix),
                             jax_noise(key, n_rows), tc, tt, L, S,
                             baseline=baseline, guard=True, decode_chunk=3)
    assert float(jr.max()) > 0
    for name in ("reward", "baseline", "advantage"):
        assert abs(m[name].item() - float(jmet[name])) <= 1e-5 * max(
            1.0, abs(float(jmet[name]))), name
    assert m["bad_step"].item() == float(jmet["bad_step"]) == 0.0
    assert abs(m["loss"].item() - float(jmet["loss"])) <= LOSS_REL * abs(
        float(jmet["loss"]))
    want = from_flax(jax.tree_util.tree_map(np.asarray, new_state.params))
    step_t = {n: p.detach().numpy() - before[n].numpy()
              for n, p in tm.named_parameters()}
    step_j = {n: want[n].numpy() - before[n].numpy() for n in step_t}
    largest = max(float(np.abs(s).max()) for s in step_j.values())
    assert largest > 0
    for name in step_t:
        err = float(np.abs(step_t[name] - step_j[name]).max())
        assert err <= GRAD_REL * largest, (name, err / largest)


# -- decoding ---------------------------------------------------------------

def test_greedy_tokens_equal_where_the_margin_allows():
    """Greedy decode of a bfloat16 model through K2's route against the
    compiled reference's: tokens identical at every step up to the first
    where the reference's top-2 logit margin is within twice the logit
    tolerance (there a one-ulp difference may flip the argmax), and the
    margin test leaves most of the steps to check."""
    jm, params, tm = _models(use_kernel=True, eos_bias=-1.0, seed=3)
    jm = jm.clone(use_pallas_attention=False)
    feats, _, _ = _data(5, b=8)
    variables = {"params": params}
    jfeats = [jnp.asarray(f) for f in feats]
    toks_j = np.asarray(jsampling.greedy_decode(jm, variables, jfeats, L))
    # The reference's logits along its own greedy path: teacher forcing on
    # its tokens computes the same steps.
    logits_j = f32(jm.apply(variables, jfeats, toks_j, 1, train=False))
    top2 = np.sort(logits_j, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    safe = margin > 2 * ULPS * ulp(logits_j)
    with torch.no_grad():
        toks_t = greedy_decode(tm, _t(feats), L).numpy()
    checked = 0
    for row in range(toks_j.shape[0]):
        for t in range(L):
            if not safe[row, t]:
                break
            assert toks_t[row, t] == toks_j[row, t], (row, t)
            checked += 1
            if toks_j[row, t] == 0:
                break
    assert checked >= toks_j.shape[0] * 2


def test_bf16_decode_step_matches_the_reference_variant(caplog):
    """``--decode_kernel bf16`` on a float32 model: the port's
    ``make_bf16_decode_step`` against the reference's over the same
    parameters (float32 carry and logits at the boundary, bfloat16
    inside), three steps, within two ulps compiled and bit for bit op by
    op.  On a bfloat16 model the variant is the reference cell, said once
    in the log."""
    feats, _, _ = _data(6)
    jm = JaxCaptionModel(vocab_size=V, embed_size=E, hidden_size=H,
                         attn_size=A, dropout_rate=0.0)
    jfeats = [jnp.asarray(f) for f in feats]
    params = jax.tree_util.tree_map(np.array, jm.init(
        jax.random.PRNGKey(7), jfeats, np.zeros((B, L), np.int32))["params"])
    variables = {"params": params}
    tm = model_from_flax(params, device="cpu", decode_kernel="bf16",
                         drop_prob=0.0)
    toks = [np.asarray(x, np.int32) for x in ([0, 0, 0, 0], [3, 1, 4, 1],
                                              [5, 9, 2, 6])]

    def reference():
        m, p, po = jm.apply(variables, jfeats, method="encode")
        step = jbf16.make_bf16_decode_step(jm, variables, m, p, po)
        carry = jm.apply(variables, po, method="init_carry")
        outs = []
        for tok in toks:
            carry, logits = step(carry, jnp.asarray(tok))
            outs.append((carry[0][0], carry[0][1], logits))
        return outs

    with torch.no_grad():
        mem, pm, pooled = tm.encode(_t(feats))
        step = make_decode_step(tm, mem, pm, pooled)
        carry = tm.init_carry(pooled)
        got = []
        for tok in toks:
            carry, logits = step(carry, torch.from_numpy(tok).long())
            got.append((carry[0][0], carry[0][1], logits))
    for outs in got:
        assert all(x.dtype == torch.float32 for x in outs)
    for g, w in zip(got, reference()):
        for a, b in zip(g, w):
            assert_ulps(a, b)
    with jax.disable_jit():
        eager = reference()
    for g, w in zip(got, eager):
        for a, b in zip(g, w):
            assert_same(a, b)
    bf_model = tm.clone(dtype=BF16)
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            make_decode_step(bf_model, mem.to(BF16), pm.to(BF16),
                             pooled.to(BF16))
    assert sum("already bfloat16" in r.message
               for r in caplog.records) <= 1


@pytest.mark.parametrize("fp32, bf16, bound", [
    (2.5, 2.5, None), (2.5, 2.51, None), (2.5, 2.48, None),
    (2.5, 2.53, None), (2.5, 2.47, None), (3.1, 3.0, None),
    (1.0, 1.02, None), (1.0, 1.0201, None), (1.0, 1.05, 0.1),
    (1.0, 0.89, 0.1), (0.0, 0.0, 0.0)])
def test_parity_gate_equals_the_reference(fp32, bf16, bound):
    kw = {} if bound is None else {"bound": bound}
    assert bf16_decode.parity_gate(fp32, bf16, **kw) == \
        jbf16.parity_gate(fp32, bf16, **kw)
    assert bf16_decode.DEFAULT_CIDER_DELTA_BOUND == \
        jbf16.DEFAULT_CIDER_DELTA_BOUND


def test_float32_path_is_unchanged():
    """The float32 model computes what the port computed before bfloat16
    compute existed, bit for bit: its teacher-forced logits, its
    log-probabilities and a K2 decode step equal the same computation
    written with the torch ops the float32 port ran (``nn.Linear`` and
    ``nn.Embedding`` forwards, ``torch.sigmoid``, ``torch.log_softmax``,
    ``F.linear`` around the kernel)."""
    import torch.nn.functional as F

    from cst_captioning_tpu_torch.models.captioner import (
        repeat_for_captions, shift_right)
    from cst_captioning_tpu_torch.ops.losses import token_logprobs

    _, params, _ = _models()
    tm = model_from_flax(params, device="cpu", drop_prob=0.0,
                         decode_kernel="fused")
    feats, labels, _ = _data(8)
    tf, tl = _t(feats), torch.from_numpy(labels).long()

    def before(feats, labels):
        enc, cell, lstm = tm.encoder, tm.cell, tm.cell.lstm[0]
        hs = [torch.relu(emb(x.float())) for x, emb in zip(feats, enc.embed)]
        memory = torch.cat(hs, dim=1)
        pooled = torch.tanh(enc.fuse(torch.cat([h.mean(1) for h in hs], -1)))
        proj = tm.memory_proj(memory)
        memory, proj, pooled = (repeat_for_captions(x, S)
                                for x in (memory, proj, pooled))
        c, h = torch.tanh(tm.state_init[0](pooled)).chunk(2, dim=-1)
        outs = []
        for tok in shift_right(labels).unbind(1):
            ctx, _ = k1.additive_attention_plain(
                cell.attn.query_proj(h), proj, memory, cell.attn.score_v)
            inp = torch.cat([cell.embed(tok), ctx], dim=-1)
            n = lstm.input_size
            i, f, g, o = (h @ lstm.w[n:] + lstm.bias
                          + inp @ lstm.w[:n]).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return tm.logit(torch.stack(outs, dim=1))

    with torch.no_grad():
        logits = tm(tf, tl, S)
        assert torch.equal(logits, before(tf, tl))
        assert torch.equal(
            token_logprobs(logits, tl),
            torch.log_softmax(logits, -1).gather(-1, tl[..., None])[..., 0])
        mem, pm, pooled = tm.encode(tf)
        carry = tm.init_carry(pooled)
        tok = torch.tensor([0, 4, 2, 9])
        (c1, h1), = make_decode_step(tm, mem, pm, pooled)(carry, tok)[0]
        cell = tm.cell
        (c0, h0), = carry
        c2, h2 = k2.fused_decode_cell(
            F.embedding(tok, cell.embed.weight), c0, h0,
            F.linear(h0, cell.attn.query_proj.weight), pm, mem,
            cell.attn.score_v, cell.lstm[0].w, cell.lstm[0].bias)
        assert torch.equal(c1, c2) and torch.equal(h1, h2)


def test_beam_search_bit_identical_op_by_op():
    """Beam search on a bfloat16 model: its bfloat16 log-probabilities
    meet the float32 beam scores as float32, and ties (frequent in
    bfloat16) break as ``jax.lax.top_k`` breaks them: the beams, their
    scores and the best captions equal the reference's run op by op."""
    from cst_captioning_tpu.ops.beam import beam_search as jax_beam
    from cst_captioning_tpu_torch.ops.beam import beam_search

    jm, params, tm = _models(eos_bias=-0.5, seed=4)
    feats, _, _ = _data(9)
    with jax.disable_jit():
        best_j, beams_j, scores_j = jax_beam(
            jm, {"params": params}, [jnp.asarray(f) for f in feats], 3, L)
    with torch.no_grad():
        best_t, beams_t, scores_t = beam_search(tm, _t(feats), 3, L)
    assert scores_t.dtype == torch.float32
    np.testing.assert_array_equal(beams_t.numpy(), np.asarray(beams_j))
    np.testing.assert_array_equal(best_t.numpy(), np.asarray(best_j))
    assert_same(scores_t, scores_j)


@pytest.mark.parametrize("flags", [
    ("--use_bfloat16", "1", "--decode_kernel", "fused"),
    ("--decode_kernel", "bf16", "--pallas_attention", "1")],
    ids=["bf16-model-k2", "bf16-variant-k1"])
def test_serve_cli_in_bf16(flags):
    """``python -m cst_captioning_tpu_torch.serve`` with ``--use_bfloat16
    1`` (K2's route in bfloat16) and with ``--decode_kernel bf16`` (the
    variant, K1's route): every request answered, exit 0, and the served
    captions equal the offline greedy decode of the same model."""
    import json
    import os
    import subprocess
    import sys

    from cst_captioning_tpu_torch import serve
    from cst_captioning_tpu_torch.serving.engine import serve_decode_batch

    argv = ["--serve_demo", "1", "--device", "cpu", "--rnn_size", "16",
            "--input_encoding_size", "16", "--att_size", "16",
            "--vocab_size", "20", "--feat_shapes", "4x16,1x8",
            "--beam_size", "1", "--serve_buckets", "1,4", *flags]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lines = "".join(json.dumps({"id": i, "video_id": f"v{i}"}) + "\n"
                    for i in range(6))
    proc = subprocess.run(
        [sys.executable, "-m", "cst_captioning_tpu_torch.serve", *argv],
        input=lines, capture_output=True, text=True, timeout=120, cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0, proc.stderr
    replies = {r["id"]: r for r in map(json.loads, proc.stdout.splitlines())}
    assert sorted(replies) == list(range(6))
    model, vocab, _, feats_for = serve.build_backend(serve.parse_args(argv))
    assert model.dtype == (BF16 if "--use_bfloat16" in flags
                           else torch.float32)
    feats = [feats_for(f"v{i}") for i in range(6)]
    served = serve_decode_batch(model, feats, 30, decode_chunk=8,
                                bucket_sizes=(1, 4))
    offline = greedy_decode(model, [torch.from_numpy(np.stack(f)) for f in
                                    zip(*feats)], 30, decode_chunk=8)
    np.testing.assert_array_equal(np.stack(served), offline.numpy())
    assert [replies[i]["caption"] for i in range(6)] == \
        vocab.decode_batch(offline.numpy())
