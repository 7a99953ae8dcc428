"""n-gram cooking for CIDEr-D and the consensus scores (copy of the
reference's ``metrics/ngrams.py``).  Captions are pre-tokenized strings
("a man is cooking"), n-grams are tuples of tokens, counts are plain
dicts.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

NGram = Tuple[str, ...]
NGramCounts = Dict[NGram, int]


def precook_tokens(tokens: Sequence, n: int = 4) -> Dict[tuple, int]:
    """Count all k-grams for k in 1..n of an already-tokenized sequence
    (words or ids — the one cooking loop every consumer shares)."""
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(tokens) - k + 1):
            counts[tuple(tokens[i : i + k])] += 1
    return dict(counts)


def precook(caption: str, n: int = 4) -> NGramCounts:
    """Count all k-grams for k in 1..n of a whitespace-tokenized caption."""
    return precook_tokens(caption.split(), n)


def cook_refs(refs: Sequence[str], n: int = 4) -> List[NGramCounts]:
    """Cook each reference caption of one video independently."""
    return [precook(r, n) for r in refs]


def cook_test(test: str, n: int = 4) -> NGramCounts:
    return precook(test, n)
