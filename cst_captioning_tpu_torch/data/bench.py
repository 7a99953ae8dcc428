"""Loader-only feed-rate probe, ``python -m cst_captioning_tpu_torch.bench
--stage data`` (counterpart of the reference's ``data/bench.py``).

Measures what the input path sustains with the compute path removed:
batches/s and captions/s out of ``prefetch_to_device`` (the prefetcher
the trainer drives), the prefetch queue's occupancy, and, at a simulated
consumer step time, the share of it a step would spend waiting for data.

The source is an in-memory synthetic split with a stated per-read
latency (``read_ms``: a blocking read that releases the GIL, as an
HDF5 or network read does), so worker-count scaling against it is the
overlap of that latency, scoped to this source and these shapes.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..telemetry.registry import MetricsRegistry
from .loader import CaptionLoader, prefetch_to_device


class SyntheticFeedDataset:
    """The split surface ``CaptionLoader`` reads (``video_ids``,
    ``num_videos``, ``seq_length``, ``label_start``/``label_end``,
    ``captions_for``, ``features``) over numpy arrays, with ``read_ms``
    of sleep in every ``features`` call."""

    def __init__(self, num_videos: int, seq_len: int = 30,
                 captions_per_video: int = 20, vocab: int = 8000,
                 feat_shapes: Sequence[Tuple[int, int]] = ((28, 2048),
                                                          (1, 4096)),
                 read_ms: float = 0.0, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.video_ids: List[str] = [f"v{i}" for i in range(num_videos)]
        self._feats = [rng.standard_normal((num_videos, t, d))
                       .astype(np.float32) for t, d in feat_shapes]
        self._labels = rng.integers(
            1, vocab, (num_videos * captions_per_video, seq_len)
        ).astype(np.int32)
        self._cpv = captions_per_video
        self.label_start = np.arange(num_videos) * captions_per_video
        self.label_end = self.label_start + captions_per_video
        self._seq_len = seq_len
        self._read_ms = float(read_ms)

    @property
    def num_videos(self) -> int:
        return len(self.video_ids)

    @property
    def seq_length(self) -> int:
        return self._seq_len

    def features(self, video_ix: np.ndarray) -> List[np.ndarray]:
        if self._read_ms > 0:
            time.sleep(self._read_ms / 1000.0)
        ix = np.asarray(video_ix)
        # A copy per batch, as a real read allocates and fills one.
        return [f[ix].copy() for f in self._feats]

    def captions_for(self, video_ix: int) -> np.ndarray:
        s = int(video_ix) * self._cpv
        return self._labels[s:s + self._cpv]


def feed_probe(batch_size: int = 32, seq_per_img: int = 20,
               seq_len: int = 30, vocab: int = 8000,
               num_videos: int = 64, workers: int = 1,
               read_ms: float = 10.0, consumer_ms: float = 0.0,
               batches: int = 48, prefetch_size: int = 4,
               warmup: int = 4, seed: int = 0,
               feat_shapes: Sequence[Tuple[int, int]] = ((28, 2048),
                                                        (1, 4096)),
               dataset=None) -> Dict:
    """One feed-rate measurement at one worker count; -> the record.

    1. **Drain**: the consumer takes ``batches`` batches as fast as they
       come: batches/s and captions/s.
    2. **Paced** (``consumer_ms`` > 0): the consumer sleeps
       ``consumer_ms`` after each batch, a step of that length, and
       times each wait: the data-wait share at that step time and the
       mean queue depth at each arrival.  Skipped at 0 (its fields are
       null).
    """
    if dataset is None:
        dataset = SyntheticFeedDataset(
            num_videos, seq_len=seq_len, captions_per_video=seq_per_img,
            vocab=vocab, feat_shapes=feat_shapes, read_ms=read_ms,
            seed=seed)
    loader = CaptionLoader(dataset, batch_size=batch_size,
                           seq_per_img=seq_per_img, shuffle=True, seed=seed)
    caps_per_batch = batch_size * seq_per_img
    registry = MetricsRegistry()
    it = prefetch_to_device(loader, size=prefetch_size, workers=workers,
                            registry=registry)
    waits: List[float] = []
    depths: List[float] = []
    paced_s = 0.0
    try:
        for _ in range(max(int(warmup), 1)):  # threads and allocator warm
            next(it)
        t0 = time.perf_counter()
        for _ in range(int(batches)):
            next(it)
        drain_s = time.perf_counter() - t0
        if consumer_ms > 0:
            paced_t0 = time.perf_counter()
            for _ in range(int(batches)):
                w0 = time.perf_counter()
                next(it)
                waits.append((time.perf_counter() - w0) * 1000.0)
                depths.append(registry.snapshot()["gauges"].get(
                    "loader_queue_depth", 0))
                time.sleep(consumer_ms / 1000.0)
            paced_s = time.perf_counter() - paced_t0
    finally:
        it.close()
    batches_per_sec = batches / drain_s

    def rnd(x: Optional[float], nd: int) -> Optional[float]:
        return None if x is None else round(float(x), nd)

    return {
        "batches_per_sec": round(batches_per_sec, 2),
        "captions_per_sec": round(batches_per_sec * caps_per_batch, 1),
        "consumer_ms": float(consumer_ms),
        "data_wait_ms_mean": rnd(np.mean(waits) if waits else None, 3),
        "data_wait_ms_p99": rnd(np.percentile(waits, 99) if waits
                                else None, 3),
        "data_wait_share": rnd(np.sum(waits) / (paced_s * 1000.0)
                               if waits else None, 4),
        "queue_depth_mean": rnd(np.mean(depths) if depths else None, 2),
        "queue_capacity": prefetch_size,
        "loader_workers": int(workers),
        "read_ms": float(read_ms),
        "batches": int(batches),
        "num_videos": int(num_videos),
        "retries": registry.counter("loader_retries"),
    }
