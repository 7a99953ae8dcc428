"""The port's sharded data plane (``data/sharding.py``, the sharding of
``data/loader.py``, ``feed_probe``'s shards) against the JAX package's:
the same epoch orders, shard streams and strides, bit for bit; the
global plan a data-parallel rank assembles its rows of; a sharded
resume; and the reference's ``scripts/data_report.py`` on the port's
``--stage data`` record.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cst_captioning_tpu.data import bench as jax_bench
from cst_captioning_tpu.data import sharding as jax_sharding
from cst_captioning_tpu.data.loader import CaptionLoader as JaxLoader
from cst_captioning_tpu_torch.data import bench, sharding
from cst_captioning_tpu_torch.data.loader import CaptionLoader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VIDEOS, CPV, SEQ = 23, 5, 7


def _datasets(seed=3):
    kw = dict(seq_len=SEQ, captions_per_video=CPV, vocab=40,
              feat_shapes=((3, 4), (1, 2)), read_ms=0.0, seed=seed)
    return (bench.SyntheticFeedDataset(N_VIDEOS, **kw),
            jax_bench.SyntheticFeedDataset(N_VIDEOS, **kw))


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_shard_epoch_order_is_the_reference(seed, shards):
    for epoch in range(3):
        for k in range(shards):
            spec = sharding.ShardSpec(shards, k)
            jspec = jax_sharding.ShardSpec(shards, k)
            for shuffle in (True, False):
                np.testing.assert_array_equal(
                    sharding.shard_epoch_order(N_VIDEOS, seed, epoch, spec,
                                               shuffle),
                    jax_sharding.shard_epoch_order(N_VIDEOS, seed, epoch,
                                                   jspec, shuffle))
            assert sharding.shard_size(N_VIDEOS, spec) == \
                jax_sharding.shard_size(N_VIDEOS, jspec)


@pytest.mark.parametrize("shards", [2, 3, 5])
def test_the_shards_partition_the_epoch(shards):
    parts = [sharding.shard_epoch_order(N_VIDEOS, 9, 4,
                                        sharding.ShardSpec(shards, k))
             for k in range(shards)]
    allv = np.concatenate(parts)
    assert len(allv) == N_VIDEOS
    assert sorted(allv.tolist()) == list(range(N_VIDEOS))
    assert [len(p) for p in parts] == [
        sharding.shard_size(N_VIDEOS, sharding.ShardSpec(shards, k))
        for k in range(shards)]


def test_spec_and_resolution_refuse_what_the_reference_refuses():
    assert sharding.resolve_shard_spec(0, 0) is None
    assert sharding.resolve_shard_spec(3, 2) == sharding.ShardSpec(3, 2)
    for bad in ((0, 0), (2, 2), (2, -1)):
        with pytest.raises(ValueError):
            jax_sharding.ShardSpec(*bad)
        with pytest.raises(ValueError):
            sharding.ShardSpec(*bad)


def _batches(loader, n):
    out = []
    for _ in range(n):
        b = loader.next_batch()
        out.append((list(b.video_ids), b.labels.copy(), b.weights.copy(),
                    [f.copy() for f in b.feats]))
    return out


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for (va, la, wa, fa), (vb, lb, wb, fb) in zip(a, b):
        assert va == vb
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(wa, wb)
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shards,shard_id", [(2, 0), (2, 1), (3, 2)])
def test_sharded_loader_yields_the_reference_batches(shards, shard_id):
    ours, theirs = _datasets()
    mine = CaptionLoader(ours, 3, seq_per_img=4, seed=11,
                         shard_spec=sharding.ShardSpec(shards, shard_id))
    ref = JaxLoader(theirs, 3, seq_per_img=4, seed=11,
                    shard_spec=jax_sharding.ShardSpec(shards, shard_id))
    assert mine.batches_per_epoch == ref.batches_per_epoch
    _assert_streams_equal(_batches(mine, 12), _batches(ref, 12))


def test_process_strided_loaders_are_the_reference():
    ours, theirs = _datasets()
    for q in range(3):
        mine = CaptionLoader(ours, 4, seq_per_img=2, seed=5,
                             process_index=q, process_count=3)
        ref = JaxLoader(theirs, 4, seq_per_img=2, seed=5, process_index=q,
                        process_count=3)
        _assert_streams_equal(_batches(mine, 6), _batches(ref, 6))
        evals = [(list(a.video_ids), list(b.video_ids))
                 for a, b in zip(mine.iter_eval(), ref.iter_eval())]
        assert evals and all(a == b for a, b in evals)


def test_loader_refuses_a_shard_spec_with_a_process_count():
    ours, theirs = _datasets()
    for loader, spec in ((CaptionLoader, sharding.ShardSpec(2, 0)),
                         (JaxLoader, jax_sharding.ShardSpec(2, 0))):
        with pytest.raises(ValueError, match="pick ONE sharding scheme"):
            loader(ours if loader is CaptionLoader else theirs, 2,
                   seq_per_img=2, shard_spec=spec, process_count=2)


def test_sharded_resume_is_bit_identical():
    ours, _ = _datasets()
    spec = sharding.ShardSpec(3, 1)
    twin = CaptionLoader(ours, 2, seq_per_img=3, seed=4, shard_spec=spec)
    want = _batches(twin, 9)
    resumed = CaptionLoader(ours, 2, seq_per_img=3, seed=4, shard_spec=spec)
    resumed.skip_batches(5)
    assert resumed.batches_served == 5
    _assert_streams_equal(_batches(resumed, 4), want[5:])


@pytest.mark.parametrize("count", [2, 4])
def test_data_parallel_ranks_assemble_their_rows_of_one_plan(count):
    """Every rank draws the same global plan; its batch is its block of
    whole videos, and the blocks in rank order are world size 1's."""
    ours, _ = _datasets()
    one = _batches(CaptionLoader(ours, 4, seq_per_img=3, seed=2), 7)
    ranks = [_batches(CaptionLoader(ours, 4, seq_per_img=3, seed=2,
                                    dp_rank=(r, count)), 7)
             for r in range(count)]
    for i, (vids, labels, weights, feats) in enumerate(one):
        parts = [rank[i] for rank in ranks]
        assert sum((p[0] for p in parts), []) == vids
        np.testing.assert_array_equal(
            np.concatenate([p[1] for p in parts]), labels)
        np.testing.assert_array_equal(
            np.concatenate([p[2] for p in parts]), weights)
        for m in range(2):
            np.testing.assert_array_equal(
                np.concatenate([p[3][m] for p in parts]), feats[m])


def test_feed_probe_takes_shards():
    kw = dict(batch_size=2, seq_per_img=3, seq_len=5, vocab=30,
              num_videos=12, read_ms=0.0, batches=6, warmup=1,
              feat_shapes=((2, 3),))
    rec = bench.feed_probe(**kw, data_shards=3, data_shard_id=2)
    assert (rec["data_shards"], rec["data_shard_id"]) == (3, 2)
    assert rec["batches"] == 6 and rec["captions_per_sec"] > 0
    assert bench.feed_probe(**kw)["data_shards"] == 0
    with pytest.raises(ValueError):
        bench.feed_probe(**kw, data_shards=2, data_shard_id=2)


def test_data_report_reads_the_ports_data_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    rec = subprocess.run(
        [sys.executable, "-m", "cst_captioning_tpu_torch.bench", "--device",
         "cpu", "--stage", "data", "--batch_size", "4", "--seq_per_img",
         "4", "--vocab", "500", "--data_batches", "6", "--data_read_ms",
         "1", "--data_videos", "16", "--loader_workers", "2",
         "--data_shards", "2", "--data_shard_id", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert rec.returncode == 0, rec.stderr[-2000:]
    line = rec.stdout.strip().splitlines()[-1]
    doc = json.loads(line)
    assert doc["metric"] == "data_feed_captions_per_sec"
    assert (doc["data_shards"], doc["data_shard_id"]) == (2, 1)
    assert doc["config"]["data_shards"] == 2
    path = tmp_path / "data.json"
    path.write_text(line + "\n")
    report = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "data_report.py"),
         "--file", str(path)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert report.returncode == 0, report.stdout + report.stderr
    assert "1 of 2" in report.stdout
