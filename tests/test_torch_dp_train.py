"""The train CLI as a data-parallel run of two ``--device cpu``
processes (``--num_processes 2 --process_id i --coordinator_address
127.0.0.1:<port>``, gloo): its XE and fused CST losses and validation
scores are the one-process run's, only rank 0 writes, a resume ends
bit-identical to its uninterrupted twin; the strided validation gathers
every rank's predictions in split order; and what the parallel flags
refuse.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from cst_captioning_tpu.training.evaluation import \
    gather_strided_predictions as jax_gather
from cst_captioning_tpu_torch import train
from cst_captioning_tpu_torch.parallel import dryrun, make_mesh
from cst_captioning_tpu_torch.training.checkpoint import CheckpointManager
from cst_captioning_tpu_torch.training.evaluation import \
    gather_strided_predictions

import torch_rank_bodies as bodies

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--synthetic_videos", "16",
        "--synthetic_val_videos", "7", "--captions_per_video", "5",
        "--feat_shapes", "4x8,1x5", "--rnn_size", "16",
        "--input_encoding_size", "16", "--att_size", "16", "--batch_size",
        "4", "--seq_per_img", "5", "--max_length", "8", "--log_every", "1",
        "--eval_batch_size", "2", "--loglevel", "WARNING"]
TIMEOUT_S = 240
TOL = 1e-5


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(n: int, argv, ck):
    """The train CLI as ``n`` processes (one without the group flags)
    into ``ck``; -> their outputs, every one exited 0."""
    env = dict(os.environ, PYTHONPATH=REPO)
    base = [sys.executable, "-m", "cst_captioning_tpu_torch.train", *TINY,
            *argv, "--checkpoint_path", str(ck)]
    if n == 1:
        cmds = [base]
    else:
        port = _port()
        cmds = [base + ["--num_processes", str(n), "--process_id", str(r),
                        "--coordinator_address", f"127.0.0.1:{port}"]
                for r in range(n)]
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _records(ck):
    with open(os.path.join(ck, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _losses(ck):
    return {r["step"]: r["loss"] for r in _records(ck)
            if r["scope"] == "train"}


def _vals(ck):
    return [{k: v for k, v in r.items()
             if k not in ("time", "schema", "scope")}
            for r in _records(ck) if r["scope"] == "val"]


def _close(a, b):
    assert a.keys() == b.keys()
    np.testing.assert_allclose([a[k] for k in sorted(a)],
                               [b[k] for k in sorted(b)], rtol=TOL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """XE (2 epochs), fused CST and host-reward CST (1 epoch each) at one
    and at two processes; a two-process XE stopped after one epoch and
    resumed."""
    root = tmp_path_factory.mktemp("dp")
    xe = ["--max_epochs", "2"]
    cst = ["--max_epochs", "1", "--use_rl", "1", "--device_rewards", "1",
           "--decode_chunk", "3"]
    host = ["--max_epochs", "1", "--use_rl", "1", "--device_rewards", "0",
            "--overlap_rewards", "1", "--decode_chunk", "3"]
    out = {}
    for n in (1, 2):
        out[f"xe{n}"] = (root / f"xe{n}", _run(n, xe, root / f"xe{n}"))
        out[f"cst{n}"] = (root / f"cst{n}", _run(n, cst, root / f"cst{n}"))
        out[f"host{n}"] = (root / f"host{n}",
                           _run(n, host, root / f"host{n}"))
    _run(2, ["--max_epochs", "1"], root / "resumed")
    out["resumed"] = (root / "resumed", _run(2, xe, root / "resumed"))
    return out


def test_two_processes_give_the_one_process_losses(runs):
    for stage in ("xe", "cst"):
        one, two = _losses(runs[f"{stage}1"][0]), _losses(runs[f"{stage}2"][0])
        assert len(one) == (8 if stage == "xe" else 4)
        _close(two, one)
    cst_recs = [r for r in _records(runs["cst2"][0]) if r["scope"] == "train"]
    assert all("reward" in r and "advantage" in r for r in cst_recs)


def test_host_reward_stats_are_the_one_process_means(runs):
    """On the host-reward path each rank scores its own rows: the loss,
    reward, baseline and advantage of every step are still the global
    batch's, as at one process (the negative-advantage detector reads
    them, so every rank takes its decision on the same numbers)."""
    keys = ("loss", "reward", "baseline", "advantage", "sample_len")
    one, two = ([r for r in _records(runs[f"host{n}"][0])
                 if r["scope"] == "train"] for n in (1, 2))
    assert len(one) == len(two) == 4
    for a, b in zip(one, two):
        assert a["step"] == b["step"]
        np.testing.assert_allclose([b[k] for k in keys],
                                   [a[k] for k in keys], rtol=TOL)


def test_validation_scores_are_the_one_process_scores(runs):
    for stage in ("xe", "cst"):
        one, two = _vals(runs[f"{stage}1"][0]), _vals(runs[f"{stage}2"][0])
        assert len(one) == len(two) >= 1
        for a, b in zip(one, two):
            _close(a, b)


def test_only_rank_zero_writes(runs):
    ck, outs = runs["xe2"]
    steps = [(r["step"], r["scope"]) for r in _records(ck)]
    assert len(steps) == len(set(steps)) == 8 + 2
    assert os.path.exists(os.path.join(ck, "telemetry.json"))
    summaries = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert summaries[0] == summaries[1]


def test_resume_at_two_processes_is_bit_identical(runs):
    twin, resumed = runs["xe2"][0], runs["resumed"][0]
    step = CheckpointManager(str(twin), readonly=True).latest_step
    assert step == 8
    a = CheckpointManager(str(twin), readonly=True).load(step=step)
    b = CheckpointManager(str(resumed), readonly=True).load(step=step)
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert torch.equal(a["optimizer"]["count"], b["optimizer"]["count"])
    for x, y in zip(a["optimizer"]["state"], b["optimizer"]["state"],
                    strict=True):
        assert all(torch.equal(x[k], y[k]) for k in x)
    for k in ("dropout", "noise"):
        assert torch.equal(a["rng"][k], b["rng"][k])
    assert a["run"] == b["run"]
    _close(_losses(resumed), _losses(twin))


@pytest.mark.parametrize("count", [2, 3])
def test_gather_strided_predictions_is_the_reference(count):
    ids = [f"v{i}" for i in range(7)]
    rows = np.arange(7 * 3).reshape(7, 3)
    strides = [list(range(q, 7, count)) for q in range(count)]
    maxn = max(map(len, strides))

    def allgather(padded):
        out = np.zeros((count, maxn, 3), padded.dtype)
        for q, s in enumerate(strides):
            out[q, :len(s)] = rows[s]
        return out

    for q in range(count):
        got = gather_strided_predictions(rows[strides[q]], ids, q, count,
                                         allgather)
        want = jax_gather(rows[strides[q]], ids, q, count, allgather)
        assert got[0] == want[0]
        np.testing.assert_array_equal(np.stack(got[1]), np.stack(want[1]))
    with pytest.raises(ValueError):
        gather_strided_predictions(rows[:1], ids, 0, count, allgather)


def test_strided_validation_gathers_every_rank_in_split_order():
    want = bodies.decode_rank(make_mesh(), 11, 2, 8)
    assert [p["image_id"] for p in want] == [f"val_video{i}"
                                             for i in range(11)]
    assert len({p["caption"] for p in want}) > 5
    for got in dryrun.run_ranks(2, bodies.decode_rank, 11, 2, 8):
        assert got == want


@pytest.mark.parametrize("argv,needle", [
    (["--num_processes", "2", "--data_shards", "2"],
     "DISTINCT --data_shard_id"),
    (["--num_processes", "2", "--num_devices", "1"], "--num_processes"),
    (["--num_devices", "4"], "--num_processes"),
    (["--data_shard_id", "1"], "--data_shards"),
])
def test_parallel_flags_refuse(argv, needle, capsys):
    with pytest.raises(SystemExit) as e:
        train.parse_args(TINY + argv)
    assert e.value.code == 2
    assert needle in capsys.readouterr().err


def test_the_parallel_flags_parse():
    opt = train.parse_args(TINY + ["--num_processes", "2", "--process_id",
                                   "1", "--coordinator_address",
                                   "127.0.0.1:1", "--num_devices", "2"])
    assert (opt.num_processes, opt.process_id, opt.num_devices) == (2, 1, 2)
    opt = train.parse_args(TINY + ["--data_shards", "3", "--data_shard_id",
                                   "2"])
    assert (opt.data_shards, opt.data_shard_id) == (3, 2)



def test_a_batch_the_world_does_not_divide_is_refused(tmp_path):
    """Both ranks exit non-zero, naming the rule (the reference shrinks
    its mesh instead)."""
    with pytest.raises(AssertionError,
                       match="multiple of the world size 2"):
        _run(2, ["--batch_size", "3", "--max_epochs", "1"], tmp_path / "x")
