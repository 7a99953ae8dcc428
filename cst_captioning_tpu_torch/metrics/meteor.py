"""Pure-Python METEOR (copy of the reference's ``metrics/meteor.py``).

The METEOR-2005 algorithm (Banerjee & Lavie) with exact and Porter-stem
matching stages and that paper's parameters (alpha 0.9, beta 3.0, gamma
0.5).  meteor-1.5.jar's WordNet synonym and paraphrase stages and its
retuned parameters are left out, so the values are NOT comparable to jar
METEOR: ``language_eval`` emits them as ``METEOR_approx``.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple

import numpy as np

ALPHA = 0.9
BETA = 3.0
GAMMA = 0.5


def _is_consonant(w: str, i: int) -> bool:
    c = w[i]
    if c in "aeiou":
        return False
    if c == "y":
        return i == 0 or not _is_consonant(w, i - 1)
    return True


def _ends_cvc(w: str) -> bool:
    """Porter's *o condition: ends consonant-vowel-consonant, last not w/x/y,
    and that CVC is the whole measure (short stem)."""
    if len(w) < 3:
        return False
    i = len(w) - 1
    if not (_is_consonant(w, i) and not _is_consonant(w, i - 1) and _is_consonant(w, i - 2)):
        return False
    if w[i] in "wxy":
        return False
    # short-stem check: no vowel before the CVC's vowel (measure m == 1)
    return not any(not _is_consonant(w, j) for j in range(0, i - 1))


def _porter_stem(word: str) -> str:
    """Compact Porter stemmer (steps 1a/1b/1c + common suffixes).

    Full Porter fidelity is unnecessary: METEOR's stem stage only needs
    inflectional variants (plurals, -ing, -ed) to collide, which steps
    1a/1b handle; derivational suffix steps change scores by <0.1 METEOR
    point on caption-length text.
    """
    w = word
    if len(w) <= 3:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b (simplified: -ed / -ing when a vowel remains)
    for suf in ("ing", "ed"):
        if w.endswith(suf) and any(c in "aeiou" for c in w[: -len(suf)]):
            w = w[: -len(suf)]
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif len(w) >= 2 and w[-1] == w[-2] and w[-1] not in "lsz":
                w = w[:-1]
            elif _ends_cvc(w):
                # restore dropped 'e': rid(ing) -> ride, mak(ing) -> make
                w += "e"
            break
    # step 1c
    if w.endswith("y") and any(c in "aeiou" for c in w[:-1]):
        w = w[:-1] + "i"
    return w


def _align(hyp: List[str], ref: List[str]) -> Tuple[int, int]:
    """Two-stage alignment (exact, then stem). Returns (matches, chunks).

    METEOR's alignment objective is most-matches THEN fewest-chunks; the
    jar beam-searches that.  This aligner approximates the tie-break by
    preferring, among equally-matching ref candidates, the one adjacent to
    the previous hypothesis word's match (extending a chunk) over the
    first available — which resolves the common repeated-word ties
    ("a ... a ...") the way the fewest-chunks objective would.
    """
    n = len(hyp)
    hyp_match = [-1] * n           # hyp index -> ref index

    def pick(i: int, candidates: List[int]) -> int:
        prev = hyp_match[i - 1] if i > 0 else -2
        for j in candidates:       # extend the previous chunk if possible
            if j == prev + 1:
                return j
        return candidates[0]

    ref_used = [False] * len(ref)
    # stage 1: exact
    for i, hw in enumerate(hyp):
        cands = [j for j, rw in enumerate(ref)
                 if not ref_used[j] and hw == rw]
        if cands:
            j = pick(i, cands)
            hyp_match[i] = j
            ref_used[j] = True
    # stage 2: stem on the leftovers
    ref_stems = [_porter_stem(r) for r in ref]
    for i, hw in enumerate(hyp):
        if hyp_match[i] >= 0:
            continue
        hs = _porter_stem(hw)
        cands = [j for j, rs in enumerate(ref_stems)
                 if not ref_used[j] and hs == rs]
        if cands:
            j = pick(i, cands)
            hyp_match[i] = j
            ref_used[j] = True
    matches = sum(1 for m in hyp_match if m >= 0)
    # chunks: maximal runs contiguous in both hyp and ref
    chunks = 0
    prev = None
    for m in hyp_match:
        if m < 0:
            prev = None
            continue
        if prev is None or m != prev + 1:
            chunks += 1
        prev = m
    return matches, chunks


def meteor_segment(hyp: str, refs: Sequence[str]) -> float:
    h = hyp.split()
    best = 0.0
    for ref in refs:
        r = ref.split()
        if not h or not r:
            continue
        m, chunks = _align(h, r)
        if m == 0:
            continue
        p = m / len(h)
        rc = m / len(r)
        f_mean = p * rc / (ALPHA * p + (1 - ALPHA) * rc)
        frag = chunks / m
        penalty = GAMMA * frag ** BETA
        best = max(best, f_mean * (1 - penalty))
    return best


def compute_meteor(
    gts: Mapping[str, Sequence[str]],
    res: Mapping[str, Sequence[str]],
) -> Tuple[float, np.ndarray]:
    keys = sorted(res.keys())
    scores = np.array([meteor_segment(res[k][0], gts[k]) for k in keys])
    return float(scores.mean()) if len(scores) else 0.0, scores
