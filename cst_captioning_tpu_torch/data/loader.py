"""Batch assembly over a split, in memory or on disk, and its ordered
prefetcher (counterpart of the reference's ``data/loader.py``: ``CaptionLoader``,
``BatchPlan``, ``_OrderedPrefetcher`` and ``prefetch_to_device``).

The same stream as the reference's for the same seed: the epoch order is
shuffled by ``np.random.default_rng(seed)``, a partial final batch is
filled from the next epoch, each video's ``seq_per_img`` caption rows
are drawn from the same generator (without replacement when the video
has enough captions), and the WXE weights of the drawn rows ride along.
``iter_eval`` is one ordered pass whose last batch wraps around to the
first videos (callers dedupe by video id).  ``skip_batches(n)`` replays
the draws of ``n`` batches without assembling them, the data half of a
bit-identical resume.  No sharding.

A batch is drawn in two halves: ``next_plan`` makes every random draw
(videos, caption rows, labels, weights), sequentially; ``assemble`` reads
the features, has no randomness, and may run on any thread and be
retried.  ``prefetch_to_device`` runs ``workers`` assembler threads ahead
of the consumer and emits the batches in plan order, so the stream is
the same at any worker count (and runs none where no features are read:
the consumer then assembles each batch itself).  The ``loader_err`` fault
(``resilience/faults.py``) raises from a batch's feature read, and the
prefetcher retries it with backoff (``TRANSIENT_ERRORS``).

``host_feats`` is the cast on the host before the copy
(``--bf16_feats``): a batch's features as host tensors in the dtype they
travel and reside in.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..resilience.faults import FaultPlan, InjectedFault
from ..utils.locksan import declare_order, named_lock
from .dataset import SplitData

log = logging.getLogger(__name__)

#: The two locks are never nested (a worker draws under the plan lock,
#: releases it, then deposits under the queue lock); the declared order
#: makes a future nesting checkable (``utils/locksan.py``).
LOCK_ORDER = ("data.loader.plan", "data.loader.queue")
declare_order(*LOCK_ORDER)

#: Errors the prefetcher treats as transient (retried with backoff before
#: they reach the consumer): a flaky read surfaces as ``OSError``, and the
#: ``loader_err`` fault injects one.
TRANSIENT_ERRORS = (OSError,)


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


def host_feats(feats: Sequence[Union[np.ndarray, torch.Tensor]],
               dtype: torch.dtype) -> List[torch.Tensor]:
    """Features (arrays, or host tensors the prefetcher already cast) as
    host tensors in ``dtype``, cast on the host (before the copy to the
    device: bfloat16 halves the bytes copied).  Labels and weights are
    not features and keep their dtypes."""
    return [torch.as_tensor(f).to(dtype) for f in feats]


@dataclass
class BatchPlan:
    """The random half of a batch: everything ``next_batch`` decides
    (videos, caption rows, labels and weights) but the feature read.
    ``seq`` is the batch's ordinal in the stream."""

    seq: int
    ix: np.ndarray                     # (B,) split indices
    labels: np.ndarray                 # (B*S, L) int32
    weights: np.ndarray                # (B*S,) float32
    video_ids: List[str]


class CaptionLoader:
    """Infinite shuffled batch stream over a split."""

    def __init__(self, split: SplitData, batch_size: int,
                 seq_per_img: int = 20, shuffle: bool = True, seed: int = 0,
                 consensus_weights: Optional[Dict[str, np.ndarray]] = None,
                 fault_plan: Optional[FaultPlan] = None):
        self.ds = split
        # ``loader_err@batch=N`` raises from batch N's feature read.
        self._faults = fault_plan
        self._batches_served = 0
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
    def batches_served(self) -> int:
        """Batches drawn (or skipped) so far: the next plan's ``seq``."""
        return self._batches_served

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
            self._batches_served += 1

    def next_plan(self) -> BatchPlan:
        """Draw the next batch's plan: all of the stream's random draws
        and none of its feature reads.  Sequential: the prefetcher draws
        under one lock, in stream order."""
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
        seq = self._batches_served
        self._batches_served += 1
        return BatchPlan(seq=seq, ix=ix, labels=labels, weights=weights,
                         video_ids=vids)

    def assemble(self, plan: BatchPlan, read_feats: bool = True) -> Batch:
        """Plan -> batch: the feature read (none with ``read_feats``
        False, for a consumer that gathers the features from tables on
        the device by ``video_ix``: ``feats`` is then empty).  Draws
        nothing, so a retry after a transient error assembles the same
        batch.  The ``loader_err`` fault fires here, keyed on the plan's
        ordinal."""
        if (self._faults is not None
                and self._faults.fire("loader_err", plan.seq)):
            raise InjectedFault(
                f"injected transient feature-read error at batch {plan.seq}")
        feats = self.ds.features(plan.ix) if read_feats else []
        return Batch(feats=feats, labels=plan.labels,
                     weights=plan.weights, video_ids=plan.video_ids,
                     video_ix=plan.ix)

    def next_batch(self) -> Batch:
        return self.assemble(self.next_plan())

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


class _OrderedPrefetcher:
    """``workers`` assembler threads feeding a bounded reassembly buffer
    that the consumer empties in plan order (the reference's
    ``_OrderedPrefetcher``).

    The emitted stream is the loader's own, batch for batch, at any
    worker count: plans are drawn under one lock in stream order; the
    feature reads, the host cast and the retries run in parallel; the
    consumer takes batch ``seq`` only after batch ``seq - 1``.  A
    transient read error is retried on the same plan (nothing redrawn),
    so a retry changes neither the order nor the batch (without features
    to read, the consumer assembles in its own thread).  A ticket
    semaphore bounds the batches drawn and not yet consumed to ``size``.
    ``close()`` wakes every worker and joins it (bounded by a deadline):
    no ``loader-prefetch-*`` thread outlives the consumer.
    """

    def __init__(self, loader: CaptionLoader, workers: int, size: int,
                 feat_dtype: Optional[torch.dtype], retries: int,
                 retry_backoff_s: float, registry, read_feats: bool = True):
        self._loader = loader
        self._read_feats = read_feats
        self._workers = int(workers)
        self._capacity = max(int(size), 1)
        self._feat_dtype = feat_dtype
        self._retries = int(retries)
        self._backoff = float(retry_backoff_s)
        self._registry = registry
        self._plan_lock = named_lock("data.loader.plan")   # the draws
        self._qlock = named_lock("data.loader.queue")  # _buffer, _next_emit
        self._poisoned = False               # under _plan_lock
        # Keyed on ``BatchPlan.seq``; the stream may start past 0 (after
        # ``skip_batches``).
        self._buffer: Dict[int, object] = {}
        self._next_emit = loader.batches_served
        self._avail = threading.Event()      # a deposit landed
        self._closed = threading.Event()     # the consumer is gone
        self._tickets = threading.Semaphore(self._capacity)
        self._threads: List[threading.Thread] = []
        if registry is not None:
            # Declared at 0: "armed, no retry" reads apart from "absent".
            registry.declare("loader_retries",
                             *(f"loader_retries_worker{i}"
                               for i in range(self._workers)))
            registry.set_gauge("loader_queue_depth", 0)
            registry.set_gauge("loader_queue_capacity", self._capacity)

    def start(self) -> "_OrderedPrefetcher":
        for i in range(self._workers):
            t = threading.Thread(target=self._work, args=(i,),
                                 name=f"loader-prefetch-{i}", daemon=True)
            self._threads.append(t)
            t.start()
        return self

    def _assemble_with_retry(self, plan: BatchPlan, wix: int) -> Batch:
        delay = self._backoff
        for attempt in range(self._retries + 1):
            try:
                return self._loader.assemble(plan, self._read_feats)
            except TRANSIENT_ERRORS as e:
                if attempt >= self._retries or self._closed.is_set():
                    raise
                if self._registry is not None:
                    self._registry.inc("loader_retries")
                    self._registry.inc(f"loader_retries_worker{wix}")
                log.warning(
                    "transient batch-read error in loader-prefetch-%d "
                    "(%s); retry %d/%d of batch %d in %.2fs", wix, e,
                    attempt + 1, self._retries, plan.seq, delay)
                time.sleep(delay)
                delay *= 2
        raise AssertionError("unreachable")

    def _work(self, wix: int) -> None:
        while not self._closed.is_set():
            if not self._tickets.acquire(timeout=0.1):
                continue
            draw_error: Optional[BaseException] = None
            with self._plan_lock:
                if self._poisoned or self._closed.is_set():
                    self._tickets.release()
                    return
                # A failed draw takes the place of the plan it would
                # have been.
                seq = self._loader.batches_served
                try:
                    plan = self._loader.next_plan()
                except BaseException as e:
                    # A failed draw may have consumed part of the random
                    # stream: nothing after it can be drawn right.  The
                    # consumer raises it at its place in the order.
                    self._poisoned = True
                    draw_error = e
            if draw_error is not None:
                self._deposit(seq, draw_error)
                return
            try:
                batch = self._assemble_with_retry(plan, wix)
                if self._feat_dtype is not None:
                    batch.feats = host_feats(batch.feats, self._feat_dtype)
                item: object = batch
            except BaseException as e:
                with self._plan_lock:
                    self._poisoned = True
                item = e
            self._deposit(plan.seq, item)

    def _deposit(self, seq: int, item) -> None:
        with self._qlock:
            self._buffer[seq] = item
            depth = len(self._buffer)
        self._avail.set()
        if self._registry is not None:
            self._registry.set_gauge("loader_queue_depth", depth)

    def batches(self) -> Iterator[Batch]:
        """The ordered stream; the workers start at the first ``next``.
        Without features to read there is nothing to run ahead: the
        consumer draws and assembles each batch itself, with the same
        retry, and no worker starts (one would only contend with the
        consumer's launch loop for the GIL)."""
        if not self._read_feats:
            while not self._closed.is_set():
                yield self._assemble_with_retry(self._loader.next_plan(), 0)
            return
        self.start()
        try:
            while True:
                self._avail.clear()
                with self._qlock:
                    item = self._buffer.pop(self._next_emit, None)
                    if item is not None:
                        self._next_emit += 1
                    depth = len(self._buffer)
                if item is None:        # the next batch is not in yet
                    self._avail.wait(timeout=0.05)
                    continue
                if self._registry is not None:
                    self._registry.set_gauge("loader_queue_depth", depth)
                if isinstance(item, BaseException):
                    raise item
                self._tickets.release()
                yield item
        finally:
            self.close()

    def close(self) -> None:
        """Wake and join every worker (daemon threads: the deadline gives
        up the join, never the wake-up)."""
        self._closed.set()
        self._avail.set()
        deadline = time.monotonic() + 5.0
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))


def prefetch_to_device(loader: CaptionLoader, size: int = 2,
                       feat_dtype: Optional[torch.dtype] = None,
                       retries: int = 3, retry_backoff_s: float = 0.05,
                       registry=None, workers: int = 1,
                       read_feats: bool = True) -> Iterator[Batch]:
    """The loader's batch stream, assembled ``size`` batches ahead by
    ``workers`` threads and emitted in the loader's own order.

    ``feat_dtype`` casts the features to host tensors of that dtype in
    the worker (``host_feats``), before the consumer's copy to the
    device; ``read_feats`` False skips the feature read (the consumer
    gathers the features on the device by ``video_ix``) and, with nothing
    left to run ahead, the threads: the consumer assembles each batch.  A
    ``TRANSIENT_ERRORS`` failure of a feature read is retried
    ``retries`` times with exponential backoff from ``retry_backoff_s``
    before it reaches the consumer; any other failure reaches it at once,
    in its place in the order.  ``registry`` (a ``MetricsRegistry``)
    counts ``loader_retries`` (and ``loader_retries_worker<i>``) and
    holds the ``loader_queue_depth`` and ``loader_queue_capacity``
    gauges.  Closing the iterator (or dropping it) joins every worker.
    """
    if workers < 1:
        raise ValueError(f"prefetch needs at least one worker, got "
                         f"{workers}")
    return _OrderedPrefetcher(loader, workers=workers, size=size,
                              feat_dtype=feat_dtype, retries=retries,
                              retry_backoff_s=retry_backoff_s,
                              registry=registry,
                              read_feats=read_feats).batches()
