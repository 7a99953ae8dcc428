"""Greedy caption decoding (counterpart of the greedy path of the
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

from typing import Callable

import torch

from .decode_cell_kernel import make_fused_decode_step


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
    (which raises for a model it does not cover), else the reference
    cell."""
    if model.decode_kernel == "fused":
        return make_fused_decode_step(model, memory, proj_mem)

    def step(carry, token):
        carry, logits = model.decode(carry, token[:, None], memory, proj_mem,
                                     pooled)
        return carry, logits[:, 0, :]

    return step


@torch.no_grad()
def sample_tokens(step: Callable, init_carry, batch: int, max_len: int,
                  decode_chunk: int = 0, return_steps: bool = False):
    """Greedy roll-out of ``max_len`` steps from BOS (=0).

    Returns (tokens (N, L) int64 0-terminated, logprobs (N, L) float32 of
    the emitted tokens, 0 past the first EOS); with ``return_steps`` also
    the number of decode steps executed (``max_len`` without early exit,
    else a multiple of ``decode_chunk`` capped at ``max_len``)."""
    device = init_carry[0][0].device
    carry = init_carry
    prev = torch.zeros(batch, dtype=torch.long, device=device)   # BOS
    finished = torch.zeros(batch, dtype=torch.bool, device=device)
    tokens = torch.zeros(batch, max_len, dtype=torch.long, device=device)
    logprobs = torch.zeros(batch, max_len, dtype=torch.float32,
                           device=device)
    chunk = (decode_chunk if 0 < decode_chunk < max_len else max_len)
    t = 0
    while t < max_len:
        for _ in range(min(chunk, max_len - t)):
            carry, logits = step(carry, prev)
            logp = torch.log_softmax(logits, dim=-1)
            nxt = logits.argmax(dim=-1)
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
def greedy_decode(model, feats, max_len: int,
                  decode_chunk: int = 0) -> torch.Tensor:
    """Encode + deterministic argmax decode -> (B, L) tokens."""
    memory, proj_mem, pooled = model.encode(feats)
    carry = model.init_carry(pooled)
    step = make_decode_step(model, memory, proj_mem, pooled)
    tokens, _ = sample_tokens(step, carry, pooled.shape[0], max_len,
                              decode_chunk=decode_chunk)
    return tokens
