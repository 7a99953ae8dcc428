"""``python -m cst_captioning_tpu_torch.tools.profile_top``: the summary of
the trainer's ``--profile_dir`` window (the counterpart of the
reference's ``scripts/profile_top.py``).  A two-step ``--device cpu``
train run's trace gives CPU ops sorted by total and no device time; a
synthetic trace with ``kernel`` events is ranked, counted and its
device-busy share is the union of its intervals; a directory without a
trace is a usage error (exit 2), as the reference's tool's is.
"""

import json
import os
import subprocess
import sys

import pytest

from cst_captioning_tpu_torch import train
from cst_captioning_tpu_torch.resilience.exitcodes import EXIT_OK, EXIT_USAGE
from cst_captioning_tpu_torch.tools import profile_top

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--synthetic_videos", "4",
        "--synthetic_val_videos", "2", "--captions_per_video", "4",
        "--feat_shapes", "3x12,1x6", "--fast_val", "1", "--batch_size", "2",
        "--seq_per_img", "2", "--rnn_size", "16", "--input_encoding_size",
        "16", "--att_size", "16", "--drop_prob", "0.0", "--max_epochs", "1",
        "--max_length", "10", "--log_every", "1", "--seed", "0",
        "--loglevel", "WARNING"]


def _json(capsys, *argv):
    assert profile_top.main([*argv, "--json"]) == EXIT_OK
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cpu_window(tmp_path_factory):
    """A two-step profiler window of a ``--device cpu`` XE run."""
    root = tmp_path_factory.mktemp("prof")
    assert train.main(TINY + ["--checkpoint_path", str(root / "ck"),
                              "--profile_dir", str(root / "p"),
                              "--profile_start", "0",
                              "--profile_steps", "2"]) == 0
    with open(root / "ck" / "telemetry.json") as f:
        prof = json.load(f)["info"]["profile"]
    return root / "p", prof


def test_cpu_window_top_ops_sorted_by_total(cpu_window, capsys):
    pdir, prof = cpu_window
    capsys.readouterr()
    s = _json(capsys, str(pdir), "--top", "10")
    assert s["trace"] == prof["trace"]
    ops = s["cpu_ops"]
    assert 0 < len(ops) <= 10 and s["distinct_cpu_ops"] >= len(ops)
    totals = [r["total_us"] for r in ops]
    assert totals == sorted(totals, reverse=True) and totals[0] > 0
    for r in ops:
        assert r["count"] >= 1
        assert r["mean_us"] == pytest.approx(r["total_us"] / r["count"])
    assert any(r["name"].startswith("aten::") for r in ops)
    # The CPU runs no device kernel: nothing device-busy in the window.
    assert s["kernels"] == [] and s["distinct_kernels"] == 0
    assert s["device_busy_us"] == 0.0 and s["device_busy_share"] == 0.0
    assert s["span_us"] > 0


def test_cpu_window_file_path_and_human_output(cpu_window, capsys):
    pdir, prof = cpu_window
    capsys.readouterr()
    assert profile_top.main([prof["trace"], "--top", "3"]) == EXIT_OK
    out = capsys.readouterr().out
    assert out.startswith(f"profile_top: {prof['trace']}")
    assert "== device kernels: top 0 of 0 by total time ==" in out
    assert "== CPU ops: top 3 of " in out
    assert "device busy 0.000 ms (0.000 of the window)" in out


def _kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur}


SYNTHETIC = [
    {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "x"}},
    {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
     "pid": "Spans", "tid": "PyTorch Profiler", "ts": 0.0, "dur": 1e6},
    {"ph": "X", "cat": "cpu_op", "name": "aten::addmm", "pid": 1, "tid": 1,
     "ts": 100.0, "dur": 30.0},
    _kernel("fused_attention_kernel<float>", 110.0, 20.0),
    _kernel("decode_cell_gate_kernel<float>", 125.0, 10.0),   # overlaps
    _kernel("fused_attention_kernel<float>", 200.0, 20.0),
    _kernel("Memcpy HtoD", 300.0, 5.0, cat="gpu_memcpy"),
    _kernel("sgemm", 400.0, 1.0),
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "pid": 1, "tid": 1, "ts": 105.0, "dur": 3.0},
]


def _write(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_synthetic_kernels_ranked_and_busy_share(tmp_path, capsys):
    _write(tmp_path / "profile_1_steps2-4.json", SYNTHETIC)
    s = _json(capsys, str(tmp_path))
    assert [(r["name"], r["count"], r["total_us"]) for r in s["kernels"]] \
        == [("fused_attention_kernel<float>", 2, 40.0),
            ("decode_cell_gate_kernel<float>", 1, 10.0), ("sgemm", 1, 1.0)]
    assert s["kernels"][0]["mean_us"] == 20.0
    assert s["cpu_ops"] == [{"name": "aten::addmm", "count": 1,
                             "total_us": 30.0, "mean_us": 30.0}]
    # The window: the first event's start (100) to the last's end (401);
    # the profiler's own span is not an event of the window.  Busy: the
    # union [110, 135) + [200, 220) + [300, 305) + [400, 401) = 51 us.
    assert s["span_us"] == 301.0
    assert s["device_busy_us"] == 51.0
    assert s["device_busy_share"] == pytest.approx(51.0 / 301.0)
    top1 = _json(capsys, str(tmp_path), "--top", "1")
    assert [r["name"] for r in top1["kernels"]] == [
        "fused_attention_kernel<float>"]
    assert top1["distinct_kernels"] == 3
    assert len(_json(capsys, str(tmp_path), "--top", "0")["kernels"]) == 3


def test_newest_trace_under_the_directory(tmp_path, capsys):
    old, new = tmp_path / "profile_1_steps0-2.json", \
        tmp_path / "sub" / "profile_2_steps4-6.json"
    new.parent.mkdir()
    _write(old, SYNTHETIC)
    _write(new, [_kernel("only_kernel", 0.0, 2.0)])
    os.utime(old, (1, 1))
    s = _json(capsys, str(tmp_path))
    assert s["trace"] == str(new)
    assert [r["name"] for r in s["kernels"]] == ["only_kernel"]
    _write(tmp_path / "other.json", SYNTHETIC)     # not a profile_*.json
    assert _json(capsys, str(tmp_path))["trace"] == str(new)


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "cst_captioning_tpu_torch.tools.profile_top",
         *args], cwd=REPO, capture_output=True, text=True, timeout=120)


def test_empty_directory_is_a_usage_error(tmp_path):
    p = _cli(str(tmp_path))
    assert p.returncode == EXIT_USAGE
    assert "no profile_*.json under" in p.stderr
    assert p.stdout == "" and "Traceback" not in p.stderr


def test_unreadable_trace_is_a_usage_error(tmp_path):
    bad = tmp_path / "profile_1_steps0-1.json"
    bad.write_text("{not json")
    p = _cli(str(bad))
    assert p.returncode == EXIT_USAGE
    assert "cannot read a Chrome trace" in p.stderr
    assert p.stdout == ""
