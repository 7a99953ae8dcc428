"""The port's ordered prefetcher (``data/loader.prefetch_to_device``):
the stream it emits at 1 and at 4 workers is the loader's own, batch for
batch; ``loader_err@batch=N`` fires in a worker and the retry recovers
without a reorder or a lost batch, through the train CLI too; a failure
that is not transient, or a spent retry budget, reaches the consumer in
its place; closing the stream mid-epoch joins every worker.
"""

import json
import logging
import os
import sys
import threading

import numpy as np
import pytest
import torch

from cst_captioning_tpu_torch import train
from cst_captioning_tpu_torch.data import synthetic
from cst_captioning_tpu_torch.data.loader import (CaptionLoader,
                                                  prefetch_to_device)
from cst_captioning_tpu_torch.metrics.consensus import normalize_weights
from cst_captioning_tpu_torch.resilience.faults import FaultPlan
from cst_captioning_tpu_torch.telemetry.registry import MetricsRegistry
from cst_captioning_tpu_torch.training.trainer import Trainer

SPEC = synthetic.SyntheticSpec(num_videos=10, captions_per_video=5,
                               max_len=9, feat_dims=(16, 6),
                               feat_times=(3, 1), seed=0)
N_BATCHES = 13          # four epochs and a part, at 3 videos a batch


@pytest.fixture(scope="module")
def split():
    return synthetic.generate("train", SPEC)


def loader(split, seq_per_img=3, fault_plan=None, skip=0):
    ld = CaptionLoader(split, 3, seq_per_img=seq_per_img, seed=7,
                       consensus_weights=normalize_weights(split.consensus),
                       fault_plan=fault_plan)
    ld.skip_batches(skip)
    return ld


def take(stream, n):
    out = [next(stream) for _ in range(n)]
    stream.close()
    return out


def assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.video_ids == b.video_ids
        np.testing.assert_array_equal(a.video_ix, b.video_ix)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.weights, b.weights)
        for fa, fb in zip(a.feats, b.feats):
            np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("loader-prefetch-") and t.is_alive()]


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("seq_per_img,skip", [(3, 0), (7, 0), (3, 5)],
                         ids=["without-replacement", "with-replacement",
                              "after-skip"])
def test_order_equals_the_loaders(split, workers, seq_per_img, skip):
    """The sequential loader of the same seed (``next_batch``, as the
    trainer drew batches before the prefetcher) is the reference stream;
    a resumed stream (``skip_batches``) too."""
    ref = loader(split, seq_per_img, skip=skip)
    want = [ref.next_batch() for _ in range(N_BATCHES)]
    got = take(prefetch_to_device(loader(split, seq_per_img, skip=skip),
                                  size=3, workers=workers), N_BATCHES)
    assert_same(got, want)


def test_order_holds_with_more_workers_than_cores(split):
    """16 workers, a thread switch every microsecond: the stream is still
    the loader's (a lost update of the reassembly buffer or the draw
    counter would reorder or drop a batch)."""
    ref = loader(split)
    want = [ref.next_batch() for _ in range(40)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = take(prefetch_to_device(loader(split), size=20, workers=16),
                   40)
    finally:
        sys.setswitchinterval(interval)
    assert_same(got, want)
    assert not prefetch_threads()


def test_feat_dtype_casts_features_only(split):
    got = take(prefetch_to_device(loader(split), feat_dtype=torch.bfloat16,
                                  workers=2), 2)
    want = loader(split).next_batch()
    assert all(f.dtype == torch.bfloat16 for f in got[0].feats)
    assert torch.equal(got[0].feats[0],
                       torch.from_numpy(want.feats[0]).bfloat16())
    assert got[0].labels.dtype == np.int32
    assert got[0].weights.dtype == np.float32


@pytest.mark.parametrize("workers", [1, 4])
def test_read_feats_false_reads_no_features(split, workers, monkeypatch):
    """For a consumer with the features on the device: the same plans,
    no feature read and no worker thread, and the ``loader_err`` fault
    still fires and is retried."""
    ref = loader(split)
    want = [ref.next_batch() for _ in range(N_BATCHES)]
    ld = loader(split, fault_plan=FaultPlan.parse("loader_err@batch=2"))

    def no_read(ix):
        raise AssertionError("features read")

    monkeypatch.setattr(ld.ds, "features", no_read)
    registry = MetricsRegistry()
    stream = prefetch_to_device(ld, workers=workers, read_feats=False,
                                feat_dtype=torch.bfloat16,
                                retry_backoff_s=0.001, registry=registry)
    first = next(stream)
    assert not prefetch_threads()
    got = [first] + take(stream, N_BATCHES - 1)
    assert all(b.feats == [] for b in got)
    assert_same(got, want)
    assert registry.counter("loader_retries") == 1


@pytest.mark.parametrize("workers", [1, 4])
def test_loader_err_is_retried_without_reorder_or_loss(split, workers,
                                                       caplog):
    plan = FaultPlan.parse("loader_err@batch=1*2,loader_err@batch=6")
    registry = MetricsRegistry()
    with caplog.at_level(logging.WARNING):
        got = take(prefetch_to_device(
            loader(split, fault_plan=plan), workers=workers,
            retry_backoff_s=0.001, registry=registry), N_BATCHES)
    ref = loader(split)
    assert_same(got, [ref.next_batch() for _ in range(N_BATCHES)])
    assert registry.counter("loader_retries") == 3
    assert sum(registry.counter(f"loader_retries_worker{i}")
               for i in range(workers)) == 3
    assert sum("transient batch-read error" in r.message
               for r in caplog.records) == 3
    assert plan.pending("loader_err") == 0


def test_spent_retry_budget_reaches_the_consumer_in_order(split):
    plan = FaultPlan.parse("loader_err@batch=2")
    stream = prefetch_to_device(loader(split, fault_plan=plan), workers=3,
                                retries=0)
    ref = loader(split)
    assert_same([next(stream), next(stream)],
                [ref.next_batch(), ref.next_batch()])
    with pytest.raises(OSError, match="batch 2"):
        next(stream)
    assert not prefetch_threads()


def test_a_failed_draw_poisons_the_stream(split):
    ld = loader(split)
    real = ld.next_plan
    calls = []

    def next_plan():
        calls.append(1)
        if len(calls) == 3:
            raise ValueError("draw failed")
        return real()

    ld.next_plan = next_plan
    stream = prefetch_to_device(ld, workers=4, size=6)
    next(stream), next(stream)
    with pytest.raises(ValueError, match="draw failed"):
        next(stream)
    assert len(calls) == 3          # nothing drawn after the failure
    assert not prefetch_threads()


@pytest.mark.parametrize("workers", [1, 4])
def test_close_mid_epoch_reaps_every_worker(split, workers):
    stream = prefetch_to_device(loader(split), size=4, workers=workers)
    next(stream)
    assert len(prefetch_threads()) == workers
    stream.close()
    assert not prefetch_threads()


def test_refuses_zero_workers(split):
    with pytest.raises(ValueError, match="at least one worker"):
        prefetch_to_device(loader(split), workers=0)
    with pytest.raises(SystemExit):
        train.parse_args(["--loader_workers", "0"])


BASE = ["--device", "cpu", "--synthetic_videos", "8",
        "--synthetic_val_videos", "4", "--captions_per_video", "5",
        "--feat_shapes", "4x8,1x5", "--rnn_size", "16",
        "--input_encoding_size", "16", "--att_size", "16",
        "--batch_size", "2", "--seq_per_img", "5", "--max_length", "8",
        "--max_epochs", "1", "--log_every", "1", "--fast_val", "1"]


def test_train_cli_retries_loader_errors_through(tmp_path, capsys,
                                                 caplog):
    """The reference's drill (tests/test_resilience.py,
    ``test_loader_error_is_retried_through``): two transient read errors
    at batches 1 and 2, every step trained with a finite loss."""
    ck = str(tmp_path / "ld")
    with caplog.at_level(logging.WARNING):
        assert train.main(BASE + ["--checkpoint_path", ck, "--fault_plan",
                                  "loader_err@batch=1*2"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["last_step"] == 4
    assert sum("transient batch-read error" in r.message
               for r in caplog.records) == 2
    records = [json.loads(ln) for ln in open(os.path.join(ck,
                                                          "metrics.jsonl"))]
    train_steps = {r["step"]: r for r in records if r["scope"] == "train"}
    assert set(train_steps) == {1, 2, 3, 4}
    assert all(np.isfinite(r["loss"]) for r in train_steps.values())
    tel = json.load(open(os.path.join(ck, "telemetry.json")))
    assert tel["counters"]["loader_retries"] == 2
    assert tel["counters"]["fault_loader_err"] == 2


def test_trainer_state_is_the_same_at_any_worker_count(tmp_path):
    """XE steps fed by 1 and by 4 prefetch workers end in the same
    parameters, bit for bit."""
    params = []
    for workers in ("1", "4"):
        trainer = Trainer(train.parse_args(
            BASE + ["--loader_workers", workers, "--checkpoint_path",
                    str(tmp_path / workers)]))
        try:
            for _ in range(5):
                trainer.iteration()
            params.append([p.detach().clone()
                           for p in trainer.model.parameters()])
        finally:
            trainer.close()
        assert not prefetch_threads()
    assert all(torch.equal(a, b) for a, b in zip(*params))


def test_device_feats_trainer_reads_no_features(tmp_path, monkeypatch):
    """Under ``--device_feats 1`` the training stream reads no features
    on the host (the trainer gathers them from its tables on the
    device), and trains the same parameters, bit for bit, as with the
    features streamed from the host."""
    params = []
    for device_feats in ("0", "1"):
        trainer = Trainer(train.parse_args(
            BASE + ["--device_feats", device_feats, "--checkpoint_path",
                    str(tmp_path / device_feats)]))
        reads = []
        real = trainer.train_split.features

        def features(ix, real=real, reads=reads):
            reads.append(1)
            return real(ix)

        monkeypatch.setattr(trainer.train_split, "features", features)
        try:
            for _ in range(4):
                trainer.iteration()
            params.append([p.detach().clone()
                           for p in trainer.model.parameters()])
        finally:
            trainer.close()
        # Streamed from the host: the 4 batches and those read ahead.
        assert (len(reads) == 0 if device_feats == "1"
                else len(reads) >= 4)
    assert all(torch.equal(a, b) for a, b in zip(*params))
