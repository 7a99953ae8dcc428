"""Greedy and multinomial caption sampling (counterpart of the
reference's ``ops/sampling.py``).

Sequences are 0-terminated in the label convention: the first EOS (id 0)
is kept and everything after it is 0 with logprob 0.  The rollout is a
Python loop of eager decode steps; ``decode_chunk`` > 0 runs it in chunks
of that many steps and stops once every row has emitted EOS, producing
exactly the tokens of the full-length loop (skipped steps would only
emit the zeros a finished row emits).  Multinomial sampling and the
SCST baseline rollout belong to the training slice.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..models.captioner import repeat_for_captions
from ..precision import log_softmax
from .bf16_decode import (bf16_decode_supported, make_bf16_decode_step,
                          note_reference_once)
from .decode_cell_kernel import make_fused_decode_step

#: ``noise(t, shape) -> tensor``: the Gumbel noise of decode step t.
Noise = Callable[[int, tuple], torch.Tensor]


def finished_mask(finished: torch.Tensor) -> torch.Tensor:
    """Per-ITEM finished predicate: a per-row ``(N,)`` buffer as is; a
    per-beam ``(B, k)`` buffer is finished once every beam is."""
    return finished if finished.ndim <= 1 else finished.all(dim=-1)


def all_finished(finished: torch.Tensor) -> torch.Tensor:
    """Scalar: every item finished — the chunked early-exit predicate."""
    return finished_mask(finished).all()


def make_decode_step(model, memory: torch.Tensor, proj_mem: torch.Tensor,
                     pooled: torch.Tensor) -> Callable:
    """``step(carry, token (N,)) -> (carry, logits (N, V))`` over the
    model's decode cell: the K2 kernel for ``decode_kernel == "fused"``
    (which raises for a model it does not cover), the bfloat16 variant of
    the reference cell for ``"bf16"`` (``ops/bf16_decode.py``; on a model
    that already computes in bfloat16 that is the reference cell itself,
    said once in the log), else the reference cell."""
    if model.decode_kernel == "fused":
        return make_fused_decode_step(model, memory, proj_mem)
    if model.decode_kernel == "bf16":
        ok, reason = bf16_decode_supported(model)
        if ok:
            return make_bf16_decode_step(model, memory, proj_mem, pooled)
        note_reference_once(reason)

    def step(carry, token):
        carry, logits = model.decode(carry, token[:, None], memory, proj_mem,
                                     pooled)
        return carry, logits[:, 0, :]

    return step


def gumbel_noise(generator: torch.Generator,
                 dtype: torch.dtype = torch.float32) -> Noise:
    """The multinomial sampler's noise, drawn on ``generator``'s device:
    ``-log(-log(U))`` with ``U`` uniform on ``[tiny, 1)``, as
    ``jax.random.gumbel`` (the clamp keeps ``U = 0`` from giving inf).

    With ``dtype=torch.bfloat16`` it is the draw ``jax.random.gumbel``
    makes in bfloat16 (``jax.random.categorical`` on bfloat16 logits):
    ``U`` on the grid ``k / 128`` (bfloat16's 7 mantissa bits) clamped to
    bfloat16's ``tiny``, and each log rounded to bfloat16, so the noise
    takes 128 values, all below 5.  The noise is returned in ``dtype``;
    the sampler adds it in the logits' dtype."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"Gumbel noise in {dtype}: float32 or bfloat16 only")
    tiny = torch.finfo(dtype).tiny

    def noise(t: int, shape) -> torch.Tensor:
        if dtype == torch.bfloat16:
            k = torch.randint(0, 128, shape, generator=generator,
                              device=generator.device)
            u = (k.float() / 128).clamp_(min=tiny).to(dtype)
            return -torch.log(-torch.log(u))
        u = torch.rand(shape, generator=generator,
                       device=generator.device).clamp_(min=tiny)
        return -torch.log(-torch.log(u))

    return noise


@torch.no_grad()
def sample_tokens(step: Callable, init_carry, batch: int, max_len: int,
                  greedy: Union[bool, torch.Tensor] = True,
                  temperature: float = 1.0, noise: Optional[Noise] = None,
                  decode_chunk: int = 0, return_steps: bool = False):
    """Roll out ``max_len`` steps from BOS (=0).

    ``greedy`` is a bool (the whole batch) or a per-row (N,) bool tensor,
    which lets one rollout carry multinomial rows and greedy baseline rows
    together (``sample_with_baseline``).  Multinomial rows take
    ``argmax(logits / max(temperature, 1e-6) + noise(t, (N, V)))`` in the
    logits' dtype (the noise cast to it), the Gumbel-max draw
    ``jax.random.categorical`` makes; ``noise`` is
    ``gumbel_noise(generator, dtype)`` with the model's compute dtype, or
    a test's hook that feeds the reference's own Gumbel draws.  Every step
    draws noise for all rows, greedy ones included, as the reference
    does.

    Returns (tokens (N, L) int64 0-terminated, logprobs (N, L) float32 of
    the emitted tokens, 0 past the first EOS); with ``return_steps`` also
    the number of decode steps executed (``max_len`` without early exit,
    else a multiple of ``decode_chunk`` capped at ``max_len``)."""
    per_row = not isinstance(greedy, bool)
    if greedy is not True and noise is None:
        raise ValueError("multinomial sampling needs a noise source")
    device = init_carry[0][0].device
    carry = init_carry
    prev = torch.zeros(batch, dtype=torch.long, device=device)   # BOS
    finished = torch.zeros(batch, dtype=torch.bool, device=device)
    tokens = torch.zeros(batch, max_len, dtype=torch.long, device=device)
    logprobs = torch.zeros(batch, max_len, dtype=torch.float32,
                           device=device)
    scale = max(temperature, 1e-6)
    chunk = (decode_chunk if 0 < decode_chunk < max_len else max_len)
    t = 0
    while t < max_len:
        for _ in range(min(chunk, max_len - t)):
            carry, logits = step(carry, prev)
            logp = log_softmax(logits, dim=-1)
            if greedy is True:
                nxt = logits.argmax(dim=-1)
            else:
                nxt = (logits / scale + noise(t, logits.shape).to(
                    logits.dtype)).argmax(-1)
                if per_row:
                    nxt = torch.where(greedy, logits.argmax(dim=-1), nxt)
            tok_logp = logp.gather(1, nxt[:, None])[:, 0]
            emit = torch.where(finished, 0, nxt)
            tokens[:, t] = emit
            logprobs[:, t] = torch.where(finished, 0.0, tok_logp)
            finished = finished | (emit == 0)
            prev = emit
            t += 1
        if chunk < max_len and bool(all_finished(finished)):
            break
    return (tokens, logprobs, t) if return_steps else (tokens, logprobs)


@torch.no_grad()
def sample_captions(model, feats, max_len: int, seq_per_img: int = 1,
                    greedy: bool = False, temperature: float = 1.0,
                    noise: Optional[Noise] = None, decode_chunk: int = 0,
                    return_steps: bool = False):
    """Encode once, roll out ``seq_per_img`` captions per video ->
    (tokens (B*S, L), logprobs (B*S, L)) [, steps]."""
    memory, proj_mem, pooled = model.encode(feats)
    memory = repeat_for_captions(memory, seq_per_img)
    proj_mem = repeat_for_captions(proj_mem, seq_per_img)
    pooled = repeat_for_captions(pooled, seq_per_img)
    step = make_decode_step(model, memory, proj_mem, pooled)
    return sample_tokens(step, model.init_carry(pooled, max_len),
                         pooled.shape[0],
                         max_len, greedy=greedy, temperature=temperature,
                         noise=noise, decode_chunk=decode_chunk,
                         return_steps=return_steps)


@torch.no_grad()
def sample_with_baseline(model, feats, max_len: int, seq_per_img: int,
                         temperature: float = 1.0,
                         noise: Optional[Noise] = None,
                         decode_chunk: int = 0, return_steps: bool = False):
    """Multinomial rollout and greedy SCST baseline in ONE rollout: the B
    greedy rows ride after the B*S sampled rows, so the decode cell runs
    once a step over B*S + B rows.  -> (sampled (B*S, L), sampled logprobs
    (B*S, L), greedy (B, L)) [, steps]; the early exit waits for sampled
    and greedy rows alike."""
    memory, proj_mem, pooled = model.encode(feats)
    b = pooled.shape[0]
    ns = b * seq_per_img

    def both(x):
        return torch.cat([repeat_for_captions(x, seq_per_img), x], dim=0)

    memory, proj_mem, pooled = both(memory), both(proj_mem), both(pooled)
    step = make_decode_step(model, memory, proj_mem, pooled)
    greedy_rows = torch.arange(ns + b, device=pooled.device) >= ns
    out = sample_tokens(step, model.init_carry(pooled, max_len), ns + b,
                        max_len,
                        greedy=greedy_rows, temperature=temperature,
                        noise=noise, decode_chunk=decode_chunk,
                        return_steps=return_steps)
    tokens, logprobs = out[:2]
    res = (tokens[:ns], logprobs[:ns], tokens[ns:])
    return res + (out[2],) if return_steps else res


@torch.no_grad()
def greedy_decode(model, feats, max_len: int, decode_chunk: int = 0,
                  return_steps: bool = False):
    """Encode + deterministic argmax decode -> (B, L) tokens, and with
    ``return_steps`` the decode steps executed."""
    memory, proj_mem, pooled = model.encode(feats)
    carry = model.init_carry(pooled, max_len)
    step = make_decode_step(model, memory, proj_mem, pooled)
    out = sample_tokens(step, carry, pooled.shape[0], max_len,
                        decode_chunk=decode_chunk, return_steps=return_steps)
    return (out[0], out[2]) if return_steps else out[0]
