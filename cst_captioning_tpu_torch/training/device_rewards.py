"""Host-side builder of the on-device CIDEr-D tables (counterpart of the
reference's ``training/device_rewards.py``).

Runs once at trainer setup: encodes the tokenized training references to
ids, builds the corpus document-frequency hash table and the dense
per-video reference TF-IDF tables, and puts them on the device.  After
that the CST reward needs no host: ``ops.device_ciderd.ciderd_scores``
runs inside the fused step.

The df is the refs-derived corpus df (the reference's default mode): the
number of videos whose reference set contains the n-gram, as
``metrics.ciderd.build_corpus_df``.  The reference's external-df mode
(``--train_cached_tokens``) is not ported: the port's CLI has no cached
token files to read.

The tables equal the reference builder's array for array: n-grams are
inserted in the same order (the same dict and set operations), so every
slot lands where the reference puts it.  The hashing is vectorised per
n-gram order with the reference's own numpy hash, and the insertion loop
runs on plain Python ints, which takes ~1 s rather than minutes at
MSR-VTT's 343k distinct n-grams.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..metrics.ngrams import precook_tokens
from ..ops.device_ciderd import (MAX_N, PROBES, CorpusTable, RefTables,
                                 hash_ngrams_np)


class _Encoder:
    """word -> id, extending for OOV reference words (they can never match
    a model-vocabulary hypothesis id but still weigh norms and df)."""

    def __init__(self, word_to_ix: Optional[Mapping[str, int]] = None):
        self.w2i: Dict[str, int] = dict(word_to_ix or {})
        self._next = max(self.w2i.values(), default=0) + 1

    def __call__(self, w: str) -> int:
        ix = self.w2i.get(w)
        if ix is None:
            ix = self._next
            self.w2i[w] = ix
            self._next += 1
        return ix


def _cook(ids: Sequence[int]) -> Dict[Tuple[int, ...], int]:
    """Distinct n-grams (1..MAX_N) of an id sequence -> counts."""
    return precook_tokens(ids, MAX_N)


def _hash_keys(keys: List[Tuple[int, ...]]) -> Tuple[List[int], List[int]]:
    """``hash_ngrams_np`` of every key, one numpy call per n-gram order."""
    h1 = [0] * len(keys)
    h2 = [0] * len(keys)
    by_order: Dict[int, List[int]] = defaultdict(list)
    for i, g in enumerate(keys):
        by_order[len(g)].append(i)
    for order, idx in by_order.items():
        a1, a2 = hash_ngrams_np(
            np.asarray([keys[i] for i in idx], dtype=np.int64), order)
        for i, x, y in zip(idx, a1.tolist(), a2.tolist()):
            h1[i] = x
            h2[i] = y
    return h1, h2


def _build_hash_table(keys_df: Dict[Tuple[int, ...], float],
                      num_docs: float):
    """Open-addressed (key1, key2) -> df table with probe length <=
    ``PROBES``, grown (doubled and rebuilt) until every key fits.

    Returns numpy arrays (key1 uint32, key2 uint32, occupied bool, df
    float32), ``slot_of`` (each n-gram's table position, its dense id)
    and the number of documents."""
    keys = list(keys_df)
    dfs = list(keys_df.values())
    h1s, h2s = _hash_keys(keys)
    n = max(len(keys), 1)
    size = 1 << max(8, math.ceil(math.log2(n * 2 + 1)))
    while True:
        key1 = [0] * size
        key2 = [0] * size
        occupied = [False] * size
        df = [0.0] * size
        slot_of: Dict[Tuple[int, ...], int] = {}
        ok = True
        for g, d, a, b in zip(keys, dfs, h1s, h2s):
            pos = a % size
            step = 1 + b % (size - 1)
            for _ in range(PROBES):
                if not occupied[pos]:
                    key1[pos], key2[pos] = a, b
                    occupied[pos] = True
                    df[pos] = d
                    slot_of[g] = pos
                    break
                if key1[pos] == a and key2[pos] == b:
                    # a genuine duplicate key (or a 64-bit collision):
                    # merge df, reuse the slot
                    df[pos] = max(df[pos], d)
                    slot_of[g] = pos
                    break
                pos = (pos + step) % size
            else:
                ok = False
                break
        if ok:
            return (np.asarray(key1, np.uint32), np.asarray(key2, np.uint32),
                    np.asarray(occupied, bool), np.asarray(df, np.float32),
                    slot_of, float(num_docs))
        size *= 2   # probe bound exceeded: grow and rebuild


def build_device_tables(
    tokenized_refs: Mapping[str, Sequence[str]],
    word_to_ix: Optional[Mapping[str, int]] = None,
    device=None,
) -> Tuple[CorpusTable, RefTables, Dict[str, int]]:
    """-> (CorpusTable, RefTables, {video_id: row}) with the tables on
    ``device`` (the CPU when None).

    Rows follow ``tokenized_refs``' iteration order: pass a mapping in
    dataset order so ``Batch.video_ix`` indexes rows directly."""
    enc = _Encoder(word_to_ix)
    cooked = []                       # per video: [(ngram counts, length)]
    for caps in tokenized_refs.values():
        refs = []
        for c in caps:
            ids = [enc(w) for w in c.split()]
            refs.append((_cook(ids), len(ids)))
        cooked.append(refs)

    keys_df: Dict[Tuple[int, ...], float] = {}
    for refs in cooked:
        seen = set()
        for counts, _ in refs:
            seen.update(counts.keys())
        for g in seen:
            keys_df[g] = keys_df.get(g, 0.0) + 1.0
    key1, key2, occupied, df, slot_of, num_docs = _build_hash_table(
        keys_df, float(len(cooked)))
    log_ref_len = math.log(max(num_docs, 1.0))

    n_videos = len(cooked)
    n_refs = max((len(r) for r in cooked), default=1)
    n_grams = max((len(c) for refs in cooked for c, _ in refs), default=1)
    slot = np.full((n_videos, n_refs, n_grams), -1, np.int32)
    count = np.zeros((n_videos, n_refs, n_grams), np.float32)
    idf = np.zeros((n_videos, n_refs, n_grams), np.float32)
    order = np.zeros((n_videos, n_refs, n_grams), np.int32)
    norm = np.zeros((n_videos, n_refs, MAX_N), np.float32)
    length = np.zeros((n_videos, n_refs), np.float32)
    ref_mask = np.zeros((n_videos, n_refs), np.float32)
    idf_of: Dict[int, float] = {}     # slot -> idf, in float64
    for v, refs in enumerate(cooked):
        for r, (counts, rlen) in enumerate(refs):
            ref_mask[v, r] = 1.0
            length[v, r] = rlen
            norm2 = [0.0] * MAX_N
            slots, cs, idfs, orders = [], [], [], []
            for g, c in counts.items():
                s = slot_of[g]
                w_idf = idf_of.get(s)
                if w_idf is None:
                    w_idf = log_ref_len - math.log(max(float(df[s]), 1.0))
                    idf_of[s] = w_idf
                slots.append(s)
                cs.append(c)
                idfs.append(w_idf)
                orders.append(len(g))
                norm2[len(g) - 1] += (c * w_idf) ** 2
            k = len(slots)
            slot[v, r, :k] = slots
            count[v, r, :k] = cs
            idf[v, r, :k] = idfs
            order[v, r, :k] = orders
            norm[v, r] = [math.sqrt(x) for x in norm2]

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device or "cpu")

    corpus = CorpusTable(
        key1=dev(key1.astype(np.int64)), key2=dev(key2.astype(np.int64)),
        occupied=dev(occupied), df=dev(df),
        log_ref_len=torch.tensor(log_ref_len, dtype=torch.float32,
                                 device=device or "cpu"))
    tables = RefTables(slot=dev(slot), count=dev(count), idf=dev(idf),
                       order=dev(order), norm=dev(norm), length=dev(length),
                       ref_mask=dev(ref_mask))
    video_row = {vid: i for i, vid in enumerate(tokenized_refs.keys())}
    return corpus, tables, video_row
