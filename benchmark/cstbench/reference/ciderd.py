"""Plain CIDEr-D (Vedantam et al., the "D" variant that coco-caption
computes), in Python over token ids: n-grams of orders 1 to 4, TF-IDF
vectors with the document frequency of the training references (a
document is one video's reference set; idf = log(videos) - log(max(df,
1))), the hypothesis weight clipped to the reference's, the cosine per
order, a Gaussian length penalty of sigma 6, the mean over orders and
references, times 10.  A caption is its ids up to the first 0."""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

N = 4
SIGMA = 6.0

Vec = Tuple[List[Dict[tuple, float]], List[float], int]


def words(ids: Sequence[int]) -> List[int]:
    out = []
    for i in ids:
        if i == 0:
            break
        out.append(int(i))
    return out


def ngrams(ws: Sequence[int]) -> Counter:
    return Counter(tuple(ws[i:i + k]) for k in range(1, N + 1)
                   for i in range(len(ws) - k + 1))


class CiderD:
    """``refs``: per video, its reference captions as id lists."""

    def __init__(self, refs: Sequence[Sequence[Sequence[int]]]):
        self.log_docs = math.log(max(len(refs), 1))
        self.df: Counter = Counter()
        for caps in refs:
            seen: set = set()
            for cap in {tuple(words(r)) for r in caps}:
                seen.update(ngrams(cap))
            self.df.update(seen)
        self._refs = refs
        self._ref_vecs: Dict[int, List[Vec]] = {}

    def _vec(self, counts: Counter) -> Vec:
        vec: List[Dict[tuple, float]] = [{} for _ in range(N)]
        norm = [0.0] * N
        length = 0
        for g, tf in counts.items():
            k = len(g) - 1
            w = tf * (self.log_docs - math.log(max(self.df.get(g, 0), 1)))
            vec[k][g] = w
            norm[k] += w * w
            if k == 0:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def score(self, hyp: Sequence[int], video: int) -> float:
        """CIDEr-D x10 of ``hyp`` (ids, 0-terminated) against ``video``'s
        references."""
        if video not in self._ref_vecs:
            self._ref_vecs[video] = [self._vec(ngrams(words(r)))
                                     for r in self._refs[video]]
        hv, hn, hl = self._vec(ngrams(words(hyp)))
        total = 0.0
        refs = self._ref_vecs[video]
        for rv, rn, rl in refs:
            pen = math.exp(-((hl - rl) ** 2) / (2 * SIGMA ** 2))
            for k in range(N):
                if hn[k] == 0 or rn[k] == 0:
                    continue
                acc = sum(min(w, rv[k][g]) * rv[k][g]
                          for g, w in hv[k].items() if g in rv[k])
                total += acc / (hn[k] * rn[k]) * pen / N
        return total / max(len(refs), 1) * 10.0
