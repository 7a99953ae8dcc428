"""Batch assembly over an in-memory split (counterpart of the reference's
``data/loader.py`` ``CaptionLoader``, single process).

The same stream as the reference's for the same seed: the epoch order is
shuffled by ``np.random.default_rng(seed)``, a partial final batch is
filled from the next epoch, each video's ``seq_per_img`` caption rows
are drawn from the same generator (without replacement when the video
has enough captions), and the WXE weights of the drawn rows ride along.
``iter_eval`` is one ordered pass whose last batch wraps around to the
first videos (callers dedupe by video id).  ``skip_batches(n)`` replays
the draws of ``n`` batches without assembling them, the data half of a
bit-identical resume.  No prefetch threads, sharding or fault hooks.

``host_feats`` is the cast on the host before the copy
(``--bf16_feats``): a batch's features as host tensors in the dtype they
travel and reside in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .synthetic import Split


@dataclass
class Batch:
    """Features (B, T_m, D_m) per modality; labels and weights flattened
    over (video, caption) -> (B*S, ...)."""

    feats: List[np.ndarray]
    labels: np.ndarray                 # (B*S, L) int32, 0-padded
    weights: np.ndarray                # (B*S,) float32; 1.0 = XE
    video_ids: List[str]               # B
    video_ix: np.ndarray               # (B,) split indices


def feat_dtype(use_bfloat16, bf16_feats) -> torch.dtype:
    """The dtype features travel and reside in: bfloat16 when
    ``bf16_feats`` is true, or is None and ``use_bfloat16`` is true;
    float32 otherwise.  One resolution for the streamed batches and the
    device-resident table."""
    bf16 = use_bfloat16 if bf16_feats is None else bf16_feats
    return torch.bfloat16 if bf16 else torch.float32


def host_feats(feats: Sequence[np.ndarray],
               dtype: torch.dtype) -> List[torch.Tensor]:
    """Features as host tensors in ``dtype``, cast on the host (before
    the copy to the device: bfloat16 halves the bytes copied).  Labels
    and weights are not features and keep their dtypes."""
    return [torch.from_numpy(np.asarray(f)).to(dtype) for f in feats]


class CaptionLoader:
    """Infinite shuffled batch stream over a ``Split``."""

    def __init__(self, split: Split, batch_size: int,
                 seq_per_img: int = 20, shuffle: bool = True, seed: int = 0,
                 consensus_weights: Optional[Dict[str, np.ndarray]] = None):
        self.ds = split
        self.batch_size = batch_size
        self.seq_per_img = seq_per_img
        self.shuffle = shuffle
        self.consensus_weights = consensus_weights
        self._rng = np.random.default_rng(seed)
        self._videos = np.arange(split.num_videos)
        self._order = self._videos.copy()
        self._pos = len(self._order)        # shuffle on the first batch
        self.epoch = 0

    @property
    def batches_per_epoch(self) -> int:
        return max(1, len(self._videos) // self.batch_size)

    def _next_indices(self, n: int) -> np.ndarray:
        out = []
        while n > 0:
            if self._pos >= len(self._order):
                if self.shuffle:
                    self._rng.shuffle(self._order)
                self._pos = 0
                self.epoch += 1
            take = min(n, len(self._order) - self._pos)
            out.append(self._order[self._pos:self._pos + take])
            self._pos += take
            n -= take
        return np.concatenate(out)

    def _select_caption_rows(self, n: int) -> np.ndarray:
        if n >= self.seq_per_img:
            sel = (self._rng.choice(n, self.seq_per_img, replace=False)
                   if self.shuffle else np.arange(self.seq_per_img))
        else:
            sel = self._rng.choice(n, self.seq_per_img, replace=True)
        return np.sort(sel)

    def skip_batches(self, n: int) -> None:
        """Fast-forward the stream by ``n`` batches without assembling
        them: the epoch shuffles and caption-row selections ``next_batch``
        would have drawn, and nothing else.  A run resumed at step ``n``
        then reads the batches an uninterrupted run of the same seed reads
        from step ``n`` on."""
        for _ in range(max(0, int(n))):
            for v in self._next_indices(self.batch_size):
                self._select_caption_rows(
                    int(self.ds.label_end[v] - self.ds.label_start[v]))

    def next_batch(self) -> Batch:
        ix = self._next_indices(self.batch_size)
        s = self.seq_per_img
        labels = np.zeros((self.batch_size * s, self.ds.seq_length),
                          dtype=np.int32)
        weights = np.ones(self.batch_size * s, dtype=np.float32)
        vids = []
        for b, v in enumerate(ix):
            caps = self.ds.captions_for(int(v))
            sel = self._select_caption_rows(caps.shape[0])
            labels[b * s:(b + 1) * s] = caps[sel]
            vid = self.ds.video_ids[int(v)]
            vids.append(vid)
            if (self.consensus_weights is not None
                    and vid in self.consensus_weights):
                w = np.asarray(self.consensus_weights[vid], dtype=np.float32)
                weights[b * s:(b + 1) * s] = w[sel]
        return Batch(feats=self.ds.features(ix), labels=labels,
                     weights=weights, video_ids=vids, video_ix=ix)

    def __iter__(self) -> Iterator[Batch]:
        while True:
            yield self.next_batch()

    def iter_eval(self) -> Iterator[Batch]:
        """One ordered pass in batches of ``batch_size``; the last batch is
        padded by cycling from the first video."""
        n = len(self._videos)
        for start in range(0, n, self.batch_size):
            ix = self._videos[start:start + self.batch_size]
            if len(ix) < self.batch_size:
                ix = np.concatenate(
                    [ix, np.resize(self._videos, self.batch_size - len(ix))])
            yield Batch(
                feats=self.ds.features(ix),
                labels=np.zeros((self.batch_size * self.seq_per_img,
                                 self.ds.seq_length), dtype=np.int32),
                weights=np.ones(self.batch_size * self.seq_per_img,
                                dtype=np.float32),
                video_ids=[self.ds.video_ids[int(v)] for v in ix],
                video_ix=ix)
