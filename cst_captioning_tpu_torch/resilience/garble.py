"""Garble signatures of a decode chunk and the serving health word (own
copy of the reference's ``resilience/garble.py``).

A device fault can come back as buffers zeroed wholesale.  The serving
engine cannot see that from a raise, only from what it fetched, so it
checks each chunk's fetch against a shape no clean chunk can have:

- :func:`all_zero`: a non-empty batch of values that are all exactly 0;
- :func:`garbled_decode_slots`: a live slot whose finished flag reads
  False while every token of the chunk is 0.  Both chunk bodies (greedy
  and beam, ``serving/engine.py``) set ``finished`` in the step that
  emits token 0, so a row that emitted only zeros must read finished.

The checks are host numpy on buffers the scheduler fetched anyway.  The
recovery policy is the caller's (the engine re-runs the chunk and
escalates to a rebuild).
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np


class GarbledChunk(RuntimeError):
    """A decode chunk's fetched outputs carry the garble signature;
    ``slots`` names the offending slots."""

    def __init__(self, slots: List[int]):
        super().__init__(
            f"decode chunk garbled (impossible all-zero signature) at "
            f"slot(s) {slots}")
        self.slots = list(slots)


def all_zero(values) -> bool:
    """True when ``values`` is non-empty and every element is exactly 0."""
    arr = np.asarray(values)
    return arr.size > 0 and bool(np.all(arr == 0))


def garbled_decode_slots(toks: np.ndarray, fin: np.ndarray,
                         live_slots: Iterable[int]) -> List[int]:
    """Slots whose fetched chunk outputs are impossible for a live row.

    ``toks``: the chunk's tokens, ``(slots, chunk)`` greedy or ``(slots,
    chunk, k)`` beam; ``fin``: the per-slot finished mask; ``live_slots``:
    the slots that held a resident when the chunk started (empty slots
    emit zeros for ever and are not checked)."""
    return [int(slot) for slot in live_slots
            if not bool(fin[slot]) and all_zero(toks[slot])]


def health_status(*, draining: bool, recovering: bool) -> str:
    """``draining`` (a preemption signal was honored) over ``degraded``
    (a recovery event inside the engine's window) over ``ok``: the one
    word of the engine's ``health()`` and the ``{"op": "health"}``
    reply."""
    if draining:
        return "draining"
    return "degraded" if recovering else "ok"
