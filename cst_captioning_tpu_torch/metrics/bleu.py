"""Corpus BLEU-1..4 with coco-caption's Bleu scorer semantics (copy of
the reference's ``metrics/bleu.py``).

Modified n-gram precision with per-segment clipped counts accumulated
over the corpus, the "closest" effective reference length for the brevity
penalty, and the epsilon-smoothed ratio coco-caption uses, so zero-count
high-order n-grams do not zero the corpus score.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from .ngrams import precook

_TINY = 1e-15
_SMALL = 1e-9


def compute_bleu(
    gts: Mapping[str, Sequence[str]],
    res: Mapping[str, Sequence[str]],
    n: int = 4,
) -> Tuple[List[float], List[np.ndarray]]:
    """Corpus-level BLEU-1..n plus per-segment scores.

    gts/res: {key: [tokenized caption string, ...]}; res has one hypothesis
    per key.  Returns ([bleu_1..bleu_n], [per-segment arrays 1..n]).
    """
    keys = sorted(res.keys())
    clipped = np.zeros(n)        # corpus clipped n-gram matches per order
    totals = np.zeros(n)         # corpus hypothesis n-gram counts per order
    hyp_len_sum = 0
    ref_len_sum = 0
    per_segment: List[List[float]] = [[] for _ in range(n)]

    for key in keys:
        hyp = res[key][0]
        refs = gts[key]
        hyp_counts = precook(hyp, n)
        max_ref_counts: Dict[tuple, int] = defaultdict(int)
        ref_lens = []
        for ref in refs:
            ref_lens.append(len(ref.split()))
            for ng, c in precook(ref, n).items():
                if c > max_ref_counts[ng]:
                    max_ref_counts[ng] = c
        hyp_len = len(hyp.split())
        # "closest" effective reference length, ties -> shorter.
        closest = min(ref_lens, key=lambda rl: (abs(rl - hyp_len), rl)) if ref_lens else 0
        hyp_len_sum += hyp_len
        ref_len_sum += closest

        seg_clipped = np.zeros(n)
        seg_total = np.zeros(n)
        for ng, c in hyp_counts.items():
            k = len(ng) - 1
            seg_total[k] += c
            seg_clipped[k] += min(c, max_ref_counts.get(ng, 0))
        clipped += seg_clipped
        totals += seg_total

        # Per-segment smoothed score (coco-caption reports these too).
        seg_bp = 1.0 if hyp_len >= closest else math.exp(1 - closest / max(hyp_len, _TINY))
        prec_prod = 1.0
        for k in range(n):
            p = (seg_clipped[k] + _TINY) / (seg_total[k] + _SMALL)
            prec_prod *= p
            per_segment[k].append(prec_prod ** (1.0 / (k + 1)) * seg_bp)

    bp = 1.0 if hyp_len_sum >= ref_len_sum else math.exp(1 - ref_len_sum / max(hyp_len_sum, _TINY))
    bleus: List[float] = []
    prec_prod = 1.0
    for k in range(n):
        p = (clipped[k] + _TINY) / (totals[k] + _SMALL)
        prec_prod *= p
        bleus.append(prec_prod ** (1.0 / (k + 1)) * bp)
    return bleus, [np.asarray(s) for s in per_segment]
