"""CIDEr-D on the device: the CST reward computed from token ids, with no
host round trip (counterpart of the reference's ``ops/jax_ciderd.py``).

The same design and the same math as the reference, in PyTorch tensor
ops (the reference is plain XLA, not a Pallas kernel):

- **Corpus df as a device hash table** (built on the host once by
  ``training/device_rewards.py``): open addressing with double hashing,
  keys are two 32-bit mixes of the id-encoded n-gram (order included),
  the probe length bounded at build time, so a lookup is ``PROBES``
  gathers and compares.  A slot's position is the n-gram's dense id:
  hypothesis/reference matching is integer equality on slot ids.
- **Reference vectors as dense per-video tables**: per (video, ref) the
  distinct n-grams as (slot, count, idf, order), per-order norms and the
  ref length, gathered per batch by dataset video index.
- **Hypothesis side**: n-grams by static slicing; per-occurrence
  self-counts give tf without dedup; the clipped TF-IDF cosine per order,
  the Gaussian length penalty (sigma 6), the mean over real references
  and the x10 scale follow ``metrics/ciderd.py`` in corpus-df mode.

**The hash in int64.**  The reference mixes in wrapping uint32
arithmetic, which ``torch.uint32`` supports poorly (on CUDA above all).
``hash_ngrams_torch`` holds every value in an int64 in ``[0, 2**32)`` and
masks with ``& 0xFFFFFFFF`` after each xor and multiply.  The 32 x 32-bit
product would pass 2**63, so the multiplier is split into 16-bit halves:
``a * m = a * m_lo + ((a * m_hi) << 16)`` modulo 2**32, where both
partial products stay below 2**48 and the high half is masked to its low
16 bits before the shift; no intermediate overflows.  Shifts are of
non-negative values, so ``>>`` is logical.  ``hash_ngrams_np`` is the
reference's uint32 numpy twin, bit for bit.  Table positions and probe
steps (``h % size``, ``1 + h % (size - 1)``) are of non-negative int64
values and stay non-negative.

**Memory.**  Eager PyTorch materialises each broadcast comparison that XLA
would fuse, and ``sum`` of a bool tensor into a wider dtype first copies
it into that dtype.  So the hyp-ref match is ONE bool tensor of
``(N, R, G, P)`` bytes: the hypothesis-side validity is folded into the
slot ids first (an invalid or unseen hypothesis n-gram gets id -2, which
no reference entry holds; reference pads are -1), so a single ``==``
gives the match, and ``_count_last`` reduces it over P as uint8 (slices
of at most 255 positions, so no count wraps), with no wider copy.
``match_tensor_bytes`` counts that tensor, and ``auto_ref_chunk`` bounds
it by slicing the R axis.  The tf self-match takes three ``(N, P, P)``
bool tensors at its peak (18 MB each at N = 1344, L = 30).

Scores are float32 (the host scorers are float64): they agree with them
to about 1e-5 relative.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

MAX_N = 4
PROBES = 8          # max open-addressing probe length, enforced at build
_MIX1 = np.uint32(0x85EBCA6B)
_MIX2 = np.uint32(0xC2B2AE35)
_SEED2 = np.uint32(0x9E3779B9)
_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def _mix32(h, x, mult):
    """One multiply-xor-shift round in wrapping uint32 (numpy)."""
    h = (h ^ x) * mult
    return h ^ (h >> 13)


def hash_ngrams_np(ids: np.ndarray, order: int):
    """(..., order) int arrays -> (h1, h2) uint32 pairs: the reference's
    numpy hash, bit for bit (the table builder's side)."""
    ids = ids.astype(np.uint32)
    h1 = np.full(ids.shape[:-1], np.uint32(order), dtype=np.uint32)
    h2 = np.full(ids.shape[:-1], np.uint32(order) ^ _SEED2, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for k in range(order):
            h1 = _mix32(h1, ids[..., k], _MIX1)
            h2 = _mix32(h2, ids[..., k], _MIX2)
    return h1, h2


def _mul32(a: torch.Tensor, mult: int) -> torch.Tensor:
    """``a * mult`` modulo 2**32 for int64 ``a`` in [0, 2**32), by 16-bit
    halves of ``mult`` (every partial product below 2**48)."""
    lo = a * (mult & _MASK16)
    hi = ((a * (mult >> 16)) & _MASK16) << 16
    return (lo + hi) & _MASK32


def _mix32_torch(h: torch.Tensor, x: torch.Tensor, mult: int) -> torch.Tensor:
    h = _mul32(h ^ x, mult)
    return h ^ (h >> 13)


def hash_ngrams_torch(ids: torch.Tensor, order: int):
    """(..., order) integer tensor -> (h1, h2) int64 tensors holding the
    uint32 values of ``hash_ngrams_np`` (ids taken modulo 2**32, as the
    reference's cast to uint32 takes them)."""
    ids = ids.long() & _MASK32
    shape = ids.shape[:-1]
    h1 = torch.full(shape, order, dtype=torch.int64, device=ids.device)
    h2 = torch.full(shape, order ^ int(_SEED2), dtype=torch.int64,
                    device=ids.device)
    for k in range(order):
        h1 = _mix32_torch(h1, ids[..., k], int(_MIX1))
        h2 = _mix32_torch(h2, ids[..., k], int(_MIX2))
    return h1, h2


class CorpusTable(NamedTuple):
    """Open-addressed corpus df table (tensors on one device)."""

    key1: torch.Tensor        # (S,) int64 holding uint32; 0 in EMPTY slots
    key2: torch.Tensor        # (S,) int64   is allowed: see ``occupied``
    occupied: torch.Tensor    # (S,) bool
    df: torch.Tensor          # (S,) float32 document frequency
    log_ref_len: torch.Tensor  # () float32


class RefTables(NamedTuple):
    """Dense per-video reference TF-IDF tables (tensors on one device)."""

    slot: torch.Tensor        # (V, R, G) int32 corpus slot id, -1 = pad
    count: torch.Tensor       # (V, R, G) float32 n-gram count in this ref
    idf: torch.Tensor         # (V, R, G) float32
    order: torch.Tensor       # (V, R, G) int32 1..4, 0 = pad
    norm: torch.Tensor        # (V, R, MAX_N) float32 per-order norms
    length: torch.Tensor      # (V, R) float32 ref token length
    ref_mask: torch.Tensor    # (V, R) float32 1 for real refs, 0 for pads


def _count_last(mask: torch.Tensor) -> torch.Tensor:
    """float32 count of True along the last axis of a bool tensor, summed
    as uint8 in slices of at most 255 (a count per slice cannot wrap), so
    the mask is never copied into a wider dtype."""
    u8 = mask.view(torch.uint8)
    out = None
    for s in range(0, mask.shape[-1], 255):
        part = u8[..., s:s + 255].sum(dim=-1, dtype=torch.uint8).float()
        out = part if out is None else out + part
    return out


def table_bytes(corpus: CorpusTable, refs: RefTables) -> int:
    """Device bytes the two tables hold."""
    return sum(t.numel() * t.element_size()
               for t in (*corpus, *refs))


def table_lookup(table: CorpusTable, h1: torch.Tensor, h2: torch.Tensor):
    """Vectorised double-hash probe -> (df (...,) float32, slot (...,)
    int64).  Missing keys get df 0 (idf = log_ref_len, pyciderevalcap's
    value for unseen n-grams) and slot -1 (matches nothing)."""
    size = table.key1.shape[0]
    pos = h1 % size
    step = 1 + h2 % (size - 1)
    df = torch.zeros(h1.shape, dtype=torch.float32, device=h1.device)
    slot = torch.full(h1.shape, -1, dtype=torch.int64, device=h1.device)
    found = torch.zeros(h1.shape, dtype=torch.bool, device=h1.device)
    dead = torch.zeros(h1.shape, dtype=torch.bool, device=h1.device)
    for _ in range(PROBES):
        occ = table.occupied[pos]
        hit = (occ & (table.key1[pos] == h1) & (table.key2[pos] == h2)
               & ~found & ~dead)
        df = torch.where(hit, table.df[pos], df)
        slot = torch.where(hit, pos, slot)
        found = found | hit
        dead = dead | (~occ & ~found)
        pos = (pos + step) % size
    return df, slot


def _hyp_ngrams(tokens: torch.Tensor, table: CorpusTable):
    """(N, L) 0-terminated rows -> per-occurrence n-gram features:
    (valid (N, P) float32, tf (N, P) float32, idf (N, P) float32,
    slot (N, P) int64, order_tags (P,) int64, hyp_len (N,) float32), with
    P = sum over orders of (L - k + 1) positions, padded entries valid 0.
    """
    n, length = tokens.shape
    dev = tokens.device
    lengths = torch.cumprod((tokens != 0).long(), dim=1).sum(dim=1)  # (N,)
    valids, h1s, h2s, tags = [], [], [], []
    for order in range(1, MAX_N + 1):
        p = length - order + 1
        if p <= 0:
            continue
        grams = torch.stack([tokens[:, i:i + p] for i in range(order)],
                            dim=-1)                       # (N, p, order)
        ok = (torch.arange(p, device=dev)[None, :] + order) \
            <= lengths[:, None]
        h1, h2 = hash_ngrams_torch(grams, order)
        valids.append(ok)
        h1s.append(h1)
        h2s.append(h2)
        tags.append(torch.full((p,), order, dtype=torch.int64, device=dev))
    valid = torch.cat(valids, dim=1)
    h1 = torch.cat(h1s, dim=1)
    h2 = torch.cat(h2s, dim=1)
    # Per-occurrence term frequency: how many valid occurrences share my
    # n-gram.  Both keys are folded into one comparison of (h1, h2, valid)
    # by marking invalid columns with a key no hash takes (-1).
    k1 = torch.where(valid, h1, -1)
    same = (h1[:, :, None] == k1[:, None, :]) \
        & (h2[:, :, None] == h2[:, None, :])
    tf = _count_last(same)
    del same
    df, slot = table_lookup(table, h1, h2)
    idf = table.log_ref_len - torch.log(torch.clamp(df, min=1.0))
    return (valid.float(), tf, idf, slot, torch.cat(tags),
            lengths.float())


def match_tensor_bytes(n_hyps: int, max_len: int, refs: RefTables) -> int:
    """Device bytes of the transient (N, R, G, P) hyp-ref match tensor:
    the one bool tensor (1 byte an element) ``ciderd_scores`` allocates
    at that size, and the dominant term of its memory (everything else is
    linear in N*P or N*R*G, or the (N, P, P) tf match)."""
    p = sum(max(max_len - k + 1, 0) for k in range(1, MAX_N + 1))
    _, r, g = refs.slot.shape
    return n_hyps * r * g * p


def auto_ref_chunk(n_hyps: int, max_len: int, refs: RefTables,
                   budget_bytes: int = 256 << 20) -> Optional[int]:
    """The ``ref_chunk`` that keeps the match tensor under
    ``budget_bytes``: None when it fits in one shot, else the largest
    chunk within budget (>= 1)."""
    total = match_tensor_bytes(n_hyps, max_len, refs)
    if total <= budget_bytes:
        return None
    r = refs.slot.shape[1]
    per_ref = max(total // r, 1)
    return max(1, min(int(budget_bytes // per_ref), r))


def ciderd_scores(tokens: torch.Tensor, video_ix: torch.Tensor,
                  corpus: CorpusTable, refs: RefTables, sigma: float = 6.0,
                  ref_chunk: Optional[int] = None) -> torch.Tensor:
    """-> (N,) float32 CIDEr-D x10 of each 0-terminated row of ``tokens``
    (N, L) against the references of dataset video ``video_ix`` (N,),
    matching ``metrics/ciderd.py`` in corpus-df mode.

    ``ref_chunk``: the hyp-ref match in slices of at most this many
    references, bounding its transient to N * ref_chunk * G * P bytes.
    The math is element for element the one-shot path's (the R axis
    carries no reduction until the final masked mean).  None = one shot.
    Nothing here reads a value back to the host."""
    valid, tf, idf, slot, order_tags, hyp_len = _hyp_ngrams(tokens, corpus)
    # Per-order hyp norms: sum_i valid * tf_i * idf_i^2 over occurrences
    # of order k == sum over distinct n-grams of (tf * idf)^2.
    contrib = valid * tf * idf * idf                             # (N, P)
    orders = torch.arange(1, MAX_N + 1, device=tokens.device)
    order_onehot = (order_tags[:, None] == orders[None, :]).float()  # (P, 4)
    hnorm = torch.sqrt(torch.clamp(
        (contrib[:, :, None] * order_onehot[None]).sum(dim=1), min=0.0))
    # Hypothesis slot ids with validity folded in: -2 for an invalid
    # position or an n-gram the corpus lacks (slot -1), which no
    # reference entry holds (pads are -1, real entries >= 0).
    hslot = torch.where((valid > 0) & (slot >= 0), slot, -2)

    vix = video_ix.long()
    r_slot = refs.slot[vix].long()        # (N, R, G)
    r_count = refs.count[vix]
    r_idf = refs.idf[vix]
    r_order = refs.order[vix].long()
    r_norm = refs.norm[vix]               # (N, R, 4)
    r_len = refs.length[vix]              # (N, R)
    r_mask = refs.ref_mask[vix]           # (N, R)

    def num_for_refs(lo: int, hi: int) -> torch.Tensor:
        """Per-order clipped TF-IDF dot for references [lo, hi): h_count
        per ref entry is the occurrences of the entry's n-gram in the
        hyp; num_k = sum over entries of order k of
        idf^2 * min(h_count, r_count) * r_count."""
        rs = r_slot[:, lo:hi]
        rc = r_count[:, lo:hi]
        ri = r_idf[:, lo:hi]
        match = rs[:, :, :, None] == hslot[:, None, None, :]  # (N,Rc,G,P)
        h_count = _count_last(match)                          # (N, Rc, G)
        del match
        clipped = torch.minimum(h_count, rc) * rc * ri * ri
        ord_onehot = (r_order[:, lo:hi, :, None]
                      == orders[None, None, None, :]).float()
        return (clipped[:, :, :, None] * ord_onehot).sum(dim=2)

    r = r_slot.shape[1]
    if ref_chunk is None or ref_chunk >= r:
        num = num_for_refs(0, r)                                # (N, R, 4)
    else:
        num = torch.cat([num_for_refs(s, min(s + ref_chunk, r))
                         for s in range(0, r, ref_chunk)], dim=1)

    denom = hnorm[:, None, :] * r_norm                         # (N, R, 4)
    sims = torch.where(denom > 0, num / torch.clamp(denom, min=1e-12),
                       torch.zeros_like(num))
    delta = hyp_len[:, None] - r_len                           # (N, R)
    penalty = torch.exp(-(delta * delta) / (2.0 * sigma * sigma))
    per_ref = sims.mean(dim=2) * penalty * r_mask              # (N, R)
    n_refs = torch.clamp(r_mask.sum(dim=1), min=1.0)
    return per_ref.sum(dim=1) / n_refs * 10.0
