"""Host-side RL rewards: CIDEr-D advantage with the greedy / SCB baselines
(copy of the reference's ``training/rewards.py``).

Sampled token ids come off the device, are scored with corpus-df CIDEr-D
against their video's references, and go back as a per-caption
advantage.  A scorer with ``score_ids`` (``native.NativeCiderD``) reads
the id rows directly; the Python ``CiderD`` gets them decoded to
strings.  Baselines:

- ``greedy``: reward of the sample minus the reward of the greedy decode
  of the same video (SCST);
- ``scb-sample``: minus the leave-one-out mean reward of the video's
  other samples;
- ``scb-gt``: minus the mean of the video's top-``scb_captions``
  consensus scores of the reference captions.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from ..data.vocab import Vocab
from ..metrics.ciderd import CiderD, build_corpus_df
from ..native import NativeCiderD

log = logging.getLogger(__name__)

BASELINES = ("greedy", "scb-sample", "scb-gt")


def scb_gt_value(scores, scb_captions: int) -> float:
    """Top-k mean of a video's consensus scores (k = all when
    ``scb_captions`` <= 0): the scb-gt baseline value."""
    s = np.sort(np.asarray(scores, dtype=np.float64))[::-1]
    k = len(s) if scb_captions <= 0 else min(scb_captions, len(s))
    return float(s[:k].mean()) if k else 0.0


def host_scorer(tokenized_refs: Mapping[str, Sequence[str]],
                word_to_ix: Mapping[str, int], native: bool = True
                ) -> Tuple[Union[CiderD, NativeCiderD], str]:
    """The host path's corpus-df CIDEr-D over ``tokenized_refs`` -> (the
    scorer, "native" or "python"): the C++ one when ``native`` (the
    reference's ``--native_cider 1``), the Python one when not or when
    the library cannot be built (a warning, as the reference's
    trainer)."""
    if native:
        try:
            return NativeCiderD(tokenized_refs, word_to_ix), "native"
        except RuntimeError as e:       # NativeUnavailable is one
            log.warning("native CIDEr-D unavailable (%s); using Python", e)
    df, ndocs = build_corpus_df(tokenized_refs)
    return CiderD(df_mode="corpus", df=df, ref_len=float(ndocs)), "python"


class RewardComputer:
    """Per-batch CIDEr-D rewards and advantage for the CST stage."""

    def __init__(self, vocab: Vocab, scorer: Union[CiderD, NativeCiderD],
                 tokenized_refs: Mapping[str, Sequence[str]],
                 seq_per_img: int, baseline: str = "greedy",
                 consensus_scores: Optional[Mapping[str, np.ndarray]] = None,
                 scb_captions: int = 0):
        if baseline not in BASELINES:
            raise ValueError(f"baseline {baseline!r} not in {BASELINES}")
        if baseline == "scb-sample" and seq_per_img < 2:
            raise ValueError("scb-sample baseline needs seq_per_img >= 2")
        if baseline == "scb-gt" and consensus_scores is None:
            raise ValueError("scb-gt baseline needs consensus scores")
        self.vocab = vocab
        self.scorer = scorer
        self._native = hasattr(scorer, "score_ids")
        self.refs = tokenized_refs
        self.seq_per_img = seq_per_img
        self.baseline = baseline
        self._warned_missing = False
        self._scb_gt: Dict[str, float] = {}
        if consensus_scores is not None:
            for vid, s in consensus_scores.items():
                self._scb_gt[vid] = scb_gt_value(s, scb_captions)

    def _reward(self, video_ids: Sequence[str],
                token_rows: np.ndarray) -> np.ndarray:
        """(N, L) 0-terminated id rows -> per-row CIDEr-D against the
        references of row i's video (``video_ids[i // (N / B)]``)."""
        if self._native:
            return self.scorer.score_ids(video_ids, np.asarray(token_rows))
        return self._score(video_ids, self.vocab.decode_batch(token_rows))

    def _score(self, video_ids: Sequence[str],
               captions: List[str]) -> np.ndarray:
        """Score each caption string against its video's references."""
        per_vid = len(captions) // len(video_ids)
        gts = {}
        res = []
        for i, cap in enumerate(captions):
            key = f"{i}"
            gts[key] = list(self.refs[video_ids[i // per_vid]])
            res.append({"image_id": key, "caption": [cap]})
        _, scores = self.scorer.compute_score(gts, res)
        return scores

    def __call__(self, video_ids: Sequence[str], sampled: np.ndarray,
                 greedy: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, Dict[str, float]]:
        """-> (advantage (B*S,) float32, {reward, baseline, advantage}
        means)."""
        s = self.seq_per_img
        r_sample = self._reward(video_ids, sampled)
        if self.baseline == "greedy":
            if greedy is None:
                raise ValueError("greedy baseline requires greedy rollouts")
            baseline = np.repeat(self._reward(video_ids, greedy), s)
        elif self.baseline == "scb-sample":
            per_vid = r_sample.reshape(-1, s)
            baseline = ((per_vid.sum(axis=1, keepdims=True) - per_vid)
                        / (s - 1)).reshape(-1)
        else:  # scb-gt
            missing = [v for v in video_ids if v not in self._scb_gt]
            if missing and not self._warned_missing:
                log.warning("scb-gt baseline: %d video(s) have no consensus "
                            "scores (e.g. %s); their baseline is 0.0",
                            len(missing), missing[:3])
                self._warned_missing = True
            baseline = np.repeat([self._scb_gt.get(v, 0.0)
                                  for v in video_ids], s)
        advantage = (r_sample - baseline).astype(np.float32)
        return advantage, {"reward": float(r_sample.mean()),
                           "baseline": float(np.mean(baseline)),
                           "advantage": float(advantage.mean())}
