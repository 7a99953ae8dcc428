"""Batch-shape buckets for the serving engine (copy of the reference's
``serving/buckets.py`` ladder helpers).

The engine runs at one of a small fixed set of slot counts and grows to
the next bucket under load.  There is no program cache: eager PyTorch
compiles nothing per shape.
"""

from __future__ import annotations

from typing import Tuple

#: The shipped bucket ladder: smallest-sufficient bucket per load level,
#: grow-only under pressure.
DEFAULT_BUCKETS = (1, 4, 8)


def parse_buckets(spec) -> Tuple[int, ...]:
    """``"1,4,8"`` (or an int sequence) -> sorted unique positive tuple.

    Raises ``ValueError`` with a one-line message naming the bad token.
    """
    if isinstance(spec, str):
        tokens = [t for t in spec.replace(" ", "").split(",") if t]
    else:
        tokens = list(spec)
    if not tokens:
        raise ValueError("bucket spec is empty; expected e.g. '1,4,8'")
    sizes = []
    for tok in tokens:
        try:
            n = int(tok)
        except (TypeError, ValueError):
            raise ValueError(
                f"bad bucket size {tok!r}; expected positive integers "
                "like '1,4,8'") from None
        if n < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {n}")
        sizes.append(n)
    return tuple(sorted(set(sizes)))


def pick_bucket(buckets: Tuple[int, ...], needed: int) -> int:
    """Smallest bucket that fits ``needed`` slots; the largest bucket when
    demand exceeds every bucket (excess waits in the queue)."""
    for b in buckets:
        if b >= needed:
            return b
    return buckets[-1]
