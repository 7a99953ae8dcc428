"""Consensus CIDEr-D scores of the reference captions (counterpart of the
reference's ``metrics/consensus.py``, Python path).

Caption j of video v is scored with CIDEr-D against the other captions of
v (leave-one-out), with document frequencies from the whole training
corpus.  ``normalize_weights`` turns the scores into the WXE weights; the
raw scores are the ``scb-gt`` baseline.  ``save_consensus`` and
``load_consensus`` write and read the reference's pickle of them (its
``--train_bcmrscores_pkl`` file): ``{video_id: float array}``.
"""

from __future__ import annotations

import pickle
from collections import Counter
from typing import Dict, Mapping, Sequence

import numpy as np

from .ciderd import CiderD, build_corpus_df
from .ngrams import cook_test


def compute_consensus_scores(tokenized_refs: Mapping[str, Sequence[str]],
                             n: int = 4, sigma: float = 6.0
                             ) -> Dict[str, np.ndarray]:
    """``{video_id: (num_captions,) float array}`` in the input's caption
    order.  The reference scores every (caption, sibling) pair; here each
    video's DISTINCT captions are vectorised and compared once and the
    pairs weighted by how often each caption occurs, which gives the same
    sums in another order (a video of the synthetic grammar repeats its
    consensus form 12 times in 20)."""
    df, ndocs = build_corpus_df(tokenized_refs, n)
    scorer = CiderD(n=n, sigma=sigma, df_mode="corpus", df=df,
                    ref_len=float(ndocs))
    out: Dict[str, np.ndarray] = {}
    for vid, caps in tokenized_refs.items():
        caps = list(caps)
        if len(caps) == 1:
            out[vid] = np.zeros(1)
            continue
        count = Counter(caps)
        vecs = {c: scorer._counts_to_vec(cook_test(c, n), scorer.df,
                                         scorer.ref_len) for c in count}
        score_of = {}
        for c in count:
            total = np.zeros(n, dtype=np.float64)
            for r, k in count.items():
                k -= r == c             # leave this caption out once
                if k:
                    total += k * scorer._sim(*vecs[c], *vecs[r])
            score_of[c] = total.mean() / (len(caps) - 1) * 10.0
        out[vid] = np.asarray([score_of[c] for c in caps])
    return out


def normalize_weights(scores: Mapping[str, np.ndarray],
                      temperature: float = 1.0) -> Dict[str, np.ndarray]:
    """Per-video softmax (with temperature) of the consensus scores, times
    the caption count: the WXE weights, mean 1 per video."""
    out = {}
    for vid, s in scores.items():
        z = np.asarray(s, dtype=np.float64) / max(temperature, 1e-8)
        z = z - z.max()
        e = np.exp(z)
        out[vid] = (e / e.sum()) * len(s)
    return out


def save_consensus(path: str, scores: Mapping[str, np.ndarray]) -> None:
    with open(path, "wb") as f:
        pickle.dump({k: np.asarray(v) for k, v in scores.items()}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)


def load_consensus(path: str) -> Dict[str, np.ndarray]:
    """-> ``{video_id: float64 array}``; a file that is not such a
    pickle raises."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if not isinstance(blob, dict):
        raise ValueError(f"{path}: not a consensus pickle (want a dict of "
                         f"video id -> scores, got {type(blob).__name__})")
    return {str(k): np.asarray(v, dtype=np.float64) for k, v in blob.items()}
