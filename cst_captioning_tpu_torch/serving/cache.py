"""Exact-result cache: one decode per distinct video and configuration
(own copy of the reference's ``serving/cache.py``).

Serving traffic repeats videos, and a decode is deterministic, so a
repeated request can be answered from a table keyed by

    (configuration identity, parameter fingerprint, feature fingerprint)

The engine builds the identity with ``buckets.config_key`` (beam,
max_len, decode_chunk, length_norm, decode kernel, feature geometry,
compute dtype), so two configurations that could decode differently
never share an entry; the parameter fingerprint does the same for the
weights.

Bounded LRU of ``capacity`` entries, least recently used evicted first.
The counters live with the engine; the cache is storage.  One lock
guards the entries, and no other lock is taken while it is held, so one
cache may be shared by several engines.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..utils.locksan import named_lock
from ..weights import to_flax


def _hash_arrays(arrays) -> str:
    """SHA-256 over each array's shape, dtype and bytes."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def feature_fingerprint(feats: Sequence[np.ndarray]) -> str:
    """Hash of one request's per-modality features as float32: exact,
    since only bit-identical inputs may share a caption."""
    return _hash_arrays(np.asarray(f, np.float32) for f in feats)


def _leaves(tree: Dict[str, Any]):
    """Leaves of a nested dict in sorted-key order (the order
    ``jax.tree_util.tree_leaves`` walks a dict in)."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _leaves(val)
        else:
            yield val


def params_fingerprint(model) -> str:
    """Hash of the model's weights as the reference's Flax tree
    (``weights.to_flax``): on the same weights it equals the reference's
    ``params_fingerprint({"params": params})``.  Paid once per engine
    that has a result cache."""
    return _hash_arrays(_leaves({"params": to_flax(model)}))


class ResultCache:
    """Bounded LRU of finished caption rows.

    ``get`` returns a copy; ``put`` returns how many entries it evicted.
    ``capacity`` <= 0 stores nothing (every lookup misses)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lock = named_lock("serving.result_cache")
        self._entries: "OrderedDict[Tuple, np.ndarray]" = OrderedDict()  # cstlint-torch: guarded_by=self._lock

    def get(self, key: Tuple) -> Optional[np.ndarray]:
        with self._lock:
            row = self._entries.get(key)
            if row is None:
                return None
            self._entries.move_to_end(key)
            return row.copy()

    def put(self, key: Tuple, tokens: np.ndarray) -> int:
        if self.capacity <= 0:
            return 0
        row = np.asarray(tokens).copy()
        evicted = 0
        with self._lock:
            self._entries[key] = row
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                evicted += 1
        return evicted

    def invalidate(self, key: Tuple) -> bool:
        """Drop one entry (a suspect caption must not be replayed)."""
        with self._lock:
            return self._entries.pop(key, None) is not None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._entries), "capacity": self.capacity}
