"""CIDEr-D, the CST reward and validation metric (copy of the
reference's ``metrics/ciderd.py``, pure Python and NumPy).

n in 1..4, sigma = 6.0 gaussian length penalty, count clipping against
the reference (the "D"), TF-IDF with log document frequency, per-n
averaging, x10 final scale.  ``df_mode="corpus"`` takes document
frequencies built once over the training references (the reward path);
any other mode derives them from the references of each
``compute_score`` call (validation).  ``save_corpus_df`` and
``load_corpus_df`` write and read the reference's df pickle (its
``--train_cached_tokens`` file): ``{"df": {n-gram word tuple: count},
"ref_len": documents}``.
"""

from __future__ import annotations

import math
import pickle
from collections import defaultdict
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .ngrams import NGram, NGramCounts, cook_refs, cook_test


def build_corpus_df(
    tokenized_refs: Mapping[str, Sequence[str]], n: int = 4
) -> Tuple[Dict[NGram, float], int]:
    """Build corpus document frequencies from ``{video_id: [captions]}``.

    An n-gram's df is the number of *videos* (documents) in whose reference
    set it appears at least once.  Returns (df, num_documents).
    """
    df: Dict[NGram, float] = defaultdict(float)
    for refs in tokenized_refs.values():
        seen = set()
        for ref in refs:
            seen.update(cook_test(ref, n).keys())
        for ng in seen:
            df[ng] += 1.0
    return dict(df), len(tokenized_refs)


def save_corpus_df(path: str, df: Dict[NGram, float], num_docs: int) -> None:
    with open(path, "wb") as f:
        pickle.dump({"df": df, "ref_len": float(num_docs)}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)


def load_corpus_df(path: str) -> Tuple[Dict[NGram, float], float]:
    """-> (df, number of documents).  A file that is not such a pickle
    raises: a run must never train on another df than the one named."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    try:
        return blob["df"], float(blob["ref_len"])
    except (KeyError, TypeError):
        raise ValueError(f"{path}: not a corpus-df pickle (want a dict "
                         "with 'df' and 'ref_len')") from None


class CiderD:
    """CIDEr-D scorer.

    Args:
      df_mode: "corpus" to use a precomputed df (pass ``df`` and
        ``ref_len``), anything else to derive df from the refs given to
        each ``compute_score`` call.
      n: max n-gram order (4).
      sigma: gaussian length-penalty width (6.0).
    """

    def __init__(
        self,
        n: int = 4,
        sigma: float = 6.0,
        df_mode: str = "corpus",
        df: Optional[Dict[NGram, float]] = None,
        ref_len: Optional[float] = None,
        variant: str = "cider-d",
    ):
        if variant not in ("cider-d", "cider"):
            raise ValueError(f"unknown variant {variant!r}")
        self.n = n
        self.sigma = sigma
        self.df_mode = df_mode
        # "cider-d": clipped counts + gaussian length penalty — the reward
        # metric AND what coco-caption's eval suite computes under the name
        # "CIDEr" (its Cider scorer includes both terms).
        # "cider": the original unclipped/no-penalty formulation
        # (pyciderevalcap's plain Cider class).
        self.variant = variant
        if df_mode == "corpus":
            if df is None or ref_len is None:
                raise ValueError("corpus df_mode requires df and ref_len")
            self.df = df
            self.ref_len = math.log(max(ref_len, 1.0))
        else:
            self.df = None
            self.ref_len = None

    # -- internals ---------------------------------------------------------

    def _counts_to_vec(
        self, counts: NGramCounts, df: Mapping[NGram, float], log_ref_len: float
    ) -> Tuple[List[Dict[NGram, float]], np.ndarray, int]:
        """Sparse TF-IDF vector per n-gram order, its norms, and the length."""
        vec: List[Dict[NGram, float]] = [defaultdict(float) for _ in range(self.n)]
        norm = np.zeros(self.n, dtype=np.float64)
        length = 0
        for ngram, term_freq in counts.items():
            dfv = math.log(max(df.get(ngram, 0.0), 1.0))
            k = len(ngram) - 1
            w = term_freq * (log_ref_len - dfv)
            vec[k][ngram] = w
            norm[k] += w * w
            if k == 0:
                length += term_freq
        return vec, np.sqrt(norm), length

    def _sim(
        self,
        vec_hyp, norm_hyp, len_hyp,
        vec_ref, norm_ref, len_ref,
    ) -> np.ndarray:
        """Clipped cosine similarity per n-gram order with length penalty."""
        delta = float(len_hyp - len_ref)
        clip = self.variant == "cider-d"
        val = np.zeros(self.n, dtype=np.float64)
        for k in range(self.n):
            hv, rv = vec_hyp[k], vec_ref[k]
            acc = 0.0
            for ngram, hw in hv.items():
                rw = rv.get(ngram)
                if rw is None:
                    continue
                # CIDEr-D clips the hypothesis TF-IDF weight to the
                # reference's, penalizing degenerate repetition; plain
                # CIDEr is the raw cosine numerator.
                acc += (min(hw, rw) if clip else hw) * rw
            if norm_hyp[k] != 0 and norm_ref[k] != 0:
                val[k] = acc / (norm_hyp[k] * norm_ref[k])
        if clip:
            val *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
        return val

    # -- public API --------------------------------------------------------

    def compute_score(
        self,
        gts: Mapping[str, Sequence[str]],
        res: Sequence[Mapping[str, object]],
    ) -> Tuple[float, np.ndarray]:
        """Score hypotheses against reference sets.

        Interface mirrors the reference reward call site (SURVEY §3.2):
          gts: {key: [tokenized ref caption, ...]}
          res: [{"image_id": key, "caption": [tokenized hyp]}, ...]
        Returns (mean_score, per-hypothesis scores ×10).
        """
        # Cook each reference caption exactly once; df (in refs mode) and the
        # TF-IDF vectors both derive from the same cooked counts.
        cooked_refs: Dict[str, List[NGramCounts]] = {
            key: cook_refs(refs, self.n) for key, refs in gts.items()
        }
        if self.df_mode == "corpus":
            df, log_ref_len = self.df, self.ref_len
        else:
            df = defaultdict(float)
            for cooked in cooked_refs.values():
                seen = set()
                for counts in cooked:
                    seen.update(counts.keys())
                for ng in seen:
                    df[ng] += 1.0
            log_ref_len = math.log(max(float(len(cooked_refs)), 1.0))

        ref_cache: Dict[str, list] = {
            key: [self._counts_to_vec(c, df, log_ref_len) for c in cooked]
            for key, cooked in cooked_refs.items()
        }

        scores = np.zeros(len(res), dtype=np.float64)
        for i, item in enumerate(res):
            key = item["image_id"]
            hyp_list = item["caption"]
            hyp = hyp_list[0] if isinstance(hyp_list, (list, tuple)) else hyp_list
            vec, norm, length = self._counts_to_vec(cook_test(hyp, self.n), df, log_ref_len)
            refs = ref_cache[key]
            score = np.zeros(self.n, dtype=np.float64)
            for rvec, rnorm, rlen in refs:
                score += self._sim(vec, norm, length, rvec, rnorm, rlen)
            score_avg = score.mean() / max(len(refs), 1) * 10.0
            scores[i] = score_avg
        return float(scores.mean()) if len(res) else 0.0, scores
