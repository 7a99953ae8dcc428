"""Batched beam search (counterpart of the reference's ``ops/beam.py``).

The whole batch of beams advances together: decoder state has leading
dim ``B*k`` and beam reordering is a batched gather; finished beams
extend with EOS (id 0) at zero cost; step 0 masks beams 1..k-1 so the k
initial hypotheses are distinct; ranking optionally divides by
``len**length_norm``.

Ties break as in the reference: ``jax.lax.top_k`` puts the lower flat
index first among equal scores and ``jnp.argsort`` is stable.
``torch.topk`` promises no order among ties, so ``_top_k`` takes the
first k of a STABLE descending sort (equal scores keep their index
order), and the final ranking uses a stable ``argsort``.  The tie order
matters more on a bfloat16 model, whose log-probabilities tie often:
they meet the float32 beam scores as float32 (``torch.where`` against
the float32 finished row promotes them, as ``jnp.where`` does).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..precision import log_softmax
from .sampling import all_finished, make_decode_step

NEG_INF = -1e9


def _map_tree(fn, tree):
    """``fn`` over the tensor leaves of nested tuples and lists; other
    leaves (the transformer carry's int position) pass through."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, x) for x in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _expand_to_beams(tree, beam_size: int, batch: int):
    """Tile each (B, ...) leaf to (B*k, ...); leave other leaves (the
    transformer carry's 0-d position) alone."""

    def tile(x):
        if x.ndim >= 1 and x.shape[0] == batch:
            return x.repeat_interleave(beam_size, dim=0)
        return x

    return _map_tree(tile, tree)


def _reorder_beams(tree, parent: torch.Tensor, batch: int, beam_size: int):
    """Gather (B*k, ...) leaves by per-batch parent beam index (B, k)."""
    flat_ix = (torch.arange(batch, device=parent.device)[:, None] * beam_size
               + parent).reshape(-1)

    def gather(x):
        if x.ndim >= 1 and x.shape[0] == batch * beam_size:
            return x.index_select(0, flat_ix)
        return x

    return _map_tree(gather, tree)


def _top_k(total: torch.Tensor, k: int):
    """``jax.lax.top_k`` with its tie order (lower index first): the first
    k entries of a stable descending sort."""
    values, index = torch.sort(total, dim=-1, descending=True, stable=True)
    return values[:, :k], index[:, :k]


def eos_only_logp(vocab: int, device) -> torch.Tensor:
    """The log-prob row of a finished beam: EOS at 0, the rest NEG_INF."""
    row = torch.full((vocab,), NEG_INF, dtype=torch.float32, device=device)
    row[0] = 0.0
    return row


def beam_step(step: Callable, carry, prev, scores, finished, lengths,
              batch: int, k: int, init_mask=None):
    """One beam step shared by the offline search and the serving engine:
    -> (carry, token, new_scores, finished, lengths, parent)."""
    carry, logits = step(carry, prev.reshape(-1))             # (B*k, V)
    vocab = logits.shape[-1]
    logp = log_softmax(logits, dim=-1).reshape(batch, k, vocab)
    logp = torch.where(finished[:, :, None],
                       eos_only_logp(vocab, logp.device)[None, None, :], logp)
    total = scores[:, :, None] + logp
    if init_mask is not None:
        total = total + init_mask[None, :, None]
    new_scores, flat = _top_k(total.reshape(batch, k * vocab), k)
    parent = flat // vocab
    token = flat % vocab
    carry = _reorder_beams(carry, parent, batch, k)
    was_finished = finished.gather(1, parent)
    lengths = lengths.gather(1, parent) + (~was_finished).long()
    finished = was_finished | (token == 0)
    return carry, token, new_scores, finished, lengths, parent


def rank_beams(scores: torch.Tensor, lengths: torch.Tensor,
               length_norm: float) -> torch.Tensor:
    """Ranking scores: raw totals, or ``score / max(len, 1)**alpha``."""
    if length_norm > 0:
        return scores / lengths.clamp(min=1) ** length_norm
    return scores


@torch.no_grad()
def beam_search_tokens(step: Callable, init_carry, batch: int,
                       beam_size: int, max_len: int, length_norm: float = 0.0,
                       decode_chunk: int = 0, return_steps: bool = False):
    """Beam search over a bound decode ``step``; ``init_carry`` already
    expanded to ``B*k`` rows.  Returns (best (B, L), all beams (B, k, L),
    ranked scores (B, k)) with beams sorted best-first; with
    ``return_steps`` also the number of decode steps executed.

    ``decode_chunk`` > 0 stops after the first chunk at whose end every
    beam is finished.  A step with every beam finished is a no-op that
    extends each beam with EOS at parent identity, so the skipped steps'
    token 0 / identity parents give the backtrack of the full loop."""
    k = beam_size
    carry = init_carry
    device = init_carry[0][0].device
    prev = torch.zeros(batch, k, dtype=torch.long, device=device)   # BOS
    scores = torch.zeros(batch, k, dtype=torch.float32, device=device)
    finished = torch.zeros(batch, k, dtype=torch.bool, device=device)
    lengths = torch.zeros(batch, k, dtype=torch.long, device=device)
    ident = torch.arange(k, device=device)
    tokens = torch.zeros(max_len, batch, k, dtype=torch.long, device=device)
    parents = ident.expand(max_len, batch, k).clone()
    # Step 0: all beams share one state; only beam 0 stays live.
    init_mask = torch.where(ident > 0, NEG_INF, 0.0).float()
    chunk = (decode_chunk if 0 < decode_chunk < max_len else max_len)
    t = 0
    while t < max_len:
        for _ in range(min(chunk, max_len - t)):
            carry, prev, scores, finished, lengths, parent = beam_step(
                step, carry, prev, scores, finished, lengths, batch, k,
                init_mask=(init_mask if t == 0 else None))
            tokens[t] = prev
            parents[t] = parent
            t += 1
        if chunk < max_len and bool(all_finished(finished)):
            break
    # Backtrack the (L, B, k) token/parent chains into (B, k, L) sequences.
    beam_ix = ident.expand(batch, k)
    seqs = torch.zeros(batch, k, max_len, dtype=torch.long, device=device)
    for s in range(max_len - 1, -1, -1):
        seqs[:, :, s] = tokens[s].gather(1, beam_ix)
        beam_ix = parents[s].gather(1, beam_ix)
    ranked = rank_beams(scores, lengths, length_norm)
    order = torch.argsort(-ranked, dim=1, stable=True)
    seqs = seqs.gather(1, order[:, :, None].expand(-1, -1, max_len))
    ranked = ranked.gather(1, order)
    out = (seqs[:, 0, :], seqs, ranked)
    return out + (t,) if return_steps else out


@torch.no_grad()
def beam_search(model, feats, beam_size: int, max_len: int,
                length_norm: float = 0.0, decode_chunk: int = 0,
                return_steps: bool = False):
    """Encode + beam-decode a batch of videos -> (best (B, L), all beams
    (B, k, L), scores (B, k)), and with ``return_steps`` the decode steps
    executed."""
    memory, proj_mem, pooled = model.encode(feats)
    batch = pooled.shape[0]
    memory, proj_mem, pooled = _expand_to_beams(
        (memory, proj_mem, pooled), beam_size, batch)
    carry = model.init_carry(pooled, max_len)
    step = make_decode_step(model, memory, proj_mem, pooled)
    return beam_search_tokens(step, carry, batch, beam_size, max_len,
                              length_norm=length_norm,
                              decode_chunk=decode_chunk,
                              return_steps=return_steps)
