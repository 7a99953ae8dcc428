"""ROUGE-L with coco-caption's Rouge scorer semantics (copy of the
reference's ``metrics/rouge.py``).

LCS-based F-measure with beta = 1.2; per segment, precision and recall
are each maximised over the reference set before they are combined.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple

import numpy as np

BETA = 1.2


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Classic O(len(a)*len(b)) LCS with a rolling row (captions are short)."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[-1]


def rouge_l_segment(hyp: str, refs: Sequence[str]) -> float:
    h = hyp.split()
    prec_max = 0.0
    rec_max = 0.0
    for ref in refs:
        r = ref.split()
        lcs = _lcs_len(h, r)
        if h:
            prec_max = max(prec_max, lcs / len(h))
        if r:
            rec_max = max(rec_max, lcs / len(r))
    if prec_max == 0.0 or rec_max == 0.0:
        return 0.0
    return ((1 + BETA ** 2) * prec_max * rec_max) / (rec_max + BETA ** 2 * prec_max)


def compute_rouge(
    gts: Mapping[str, Sequence[str]],
    res: Mapping[str, Sequence[str]],
) -> Tuple[float, np.ndarray]:
    keys = sorted(res.keys())
    scores = np.array([rouge_l_segment(res[k][0], gts[k]) for k in keys])
    return float(scores.mean()) if len(scores) else 0.0, scores
