"""A preempted and resumed stage of the port ends bit-identical to its
uninterrupted twin, and the train CLI's exit codes.

In-process at a tiny size on the CPU: XE (K1 route, the plain version on
the CPU), fused CST with the scb-sample baseline (K1 and the K2 route),
bfloat16 XE, and the host-reward CST path.  Each is preempted by the
``preempt`` fault at a mid-epoch step and at an epoch-boundary step (the
SIGTERM goes to an uninstalled ``PreemptionHandler``, so no real signal
reaches the test process), resumed by a fresh ``Trainer`` in the same
directory, and held against an uninterrupted run of the same seed: every
parameter, optimizer tensor and the count with ``torch.equal``, the
generator states, and every post-resume train record's loss (and the
other metrics) with ``==``.  The host-reward path drains its pipeline at
a mid-epoch preemption and the twin does not, so it is held only at the
epoch boundary, as the reference's.

Then the exit codes through the CLI: ``preempt@step=1`` exits 75 with the
reference's summary line and its rerun resumes and exits 0;
``wedge@step=1 --wedge_timeout 3`` exits 124 and its rerun completes
(four subprocesses); the negative-advantage abort exits 4.
"""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from cst_captioning_tpu_torch import train
from cst_captioning_tpu_torch.resilience import exitcodes, integrity
from cst_captioning_tpu_torch.resilience.preemption import (PreemptedExit,
                                                            PreemptionHandler)
from cst_captioning_tpu_torch.training import checkpoint
from cst_captioning_tpu_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = ["--device", "cpu", "--synthetic_videos", "12",
        "--synthetic_val_videos", "5", "--captions_per_video", "5",
        "--feat_shapes", "3x8,1x5", "--rnn_size", "16",
        "--input_encoding_size", "16", "--att_size", "16",
        "--batch_size", "4", "--seq_per_img", "5", "--max_length", "8",
        "--decode_chunk", "3", "--log_every", "1", "--max_epochs", "2",
        "--pallas_attention", "1"]
BPE = 3

CONFIGS = {
    "xe": [],
    "cst_fused": ["--use_rl", "1", "--rl_baseline", "scb-sample",
                  "--decode_kernel", "fused"],
    "xe_bf16": ["--use_bfloat16", "1"],
    "cst_host": ["--use_rl", "1", "--rl_baseline", "greedy",
                 "--device_rewards", "0", "--decode_kernel", "fused"],
}
#: (config, step the preempt fault fires at): dispatched step 0 is honored
#: at the mid-epoch boundary 1; step 2 at the epoch boundary 3, which the
#: epoch's own save already holds.
CASES = [("xe", 0), ("xe", 2), ("cst_fused", 0), ("cst_fused", 2),
         ("xe_bf16", 0), ("xe_bf16", 2), ("cst_host", 2)]


def _run(argv, preemption=None):
    trainer = Trainer(train.parse_args(TINY + argv), preemption=preemption)
    try:
        return trainer.train()
    finally:
        trainer.close()


def _train_records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["scope"] == "train"]


_TWINS = {}


def _twin(name, tmp_path_factory):
    if name not in _TWINS:
        ck = str(tmp_path_factory.mktemp(f"twin_{name}") / "ck")
        _TWINS[name] = (ck, _run(CONFIGS[name] + ["--checkpoint_path", ck]))
    return _TWINS[name]


def _assert_same_state(a, b):
    assert a["step"] == b["step"]
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    oa, ob = a["optimizer"], b["optimizer"]
    assert torch.equal(oa["count"], ob["count"])
    assert len(oa["state"]) == len(ob["state"])
    for x, y in zip(oa["state"], ob["state"]):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for k in ("dropout", "noise"):
        assert torch.equal(a["rng"][k], b["rng"][k]), k
    assert a["rng"]["salt"] == b["rng"]["salt"]
    assert a["run"] == b["run"]


@pytest.mark.parametrize("name,at", CASES)
def test_preempted_and_resumed_stage_is_bit_identical_to_its_twin(
        name, at, tmp_path, tmp_path_factory, monkeypatch):
    twin_ck, twin = _twin(name, tmp_path_factory)
    ck = str(tmp_path / "ck")
    argv = CONFIGS[name] + ["--checkpoint_path", ck,
                            "--fault_plan", f"preempt@step={at}"]
    handler = PreemptionHandler()
    monkeypatch.setattr(os, "kill",
                        lambda pid, sig: handler._handle(sig, None))
    with pytest.raises(PreemptedExit) as e:
        _run(argv, preemption=handler)
    boundary = at + 1
    assert e.value.step == boundary
    assert e.value.saved == (boundary % BPE != 0)
    if e.value.saved:
        assert integrity.verify_step_dir(os.path.join(
            ck, "recovery", str(boundary)))[0] == "verified"

    # The rerun, with the same plan (spent) and a fresh handler.
    resumed = Trainer(train.parse_args(TINY + argv),
                      preemption=PreemptionHandler())
    assert resumed.step == boundary
    try:
        result = resumed.train()
    finally:
        resumed.close()
    assert result == twin
    last = 2 * BPE
    _assert_same_state(checkpoint.CheckpointManager(ck).load(step=last),
                       checkpoint.CheckpointManager(twin_ck).load(step=last))
    mine = {r["step"]: r for r in _train_records(ck)}
    theirs = {r["step"]: r for r in _train_records(twin_ck)}
    assert sorted(mine) == sorted(theirs) == list(range(1, last + 1))
    for s in range(boundary + 1, last + 1):
        for key, v in theirs[s].items():
            if key not in ("time", "captions_per_sec"):
                assert mine[s][key] == v, (s, key)


# -- the CLI, in subprocesses ----------------------------------------------

def _cli(argv, timeout=20):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("CST_FAULT_PLAN", None)
    return subprocess.run(
        [sys.executable, "-m", "cst_captioning_tpu_torch.train", *TINY,
         *argv], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_cli_preempt_exits_75_and_the_rerun_resumes(tmp_path):
    ck = str(tmp_path / "p")
    argv = ["--checkpoint_path", ck, "--fault_plan", "preempt@step=1"]
    proc = _cli(argv)
    assert proc.returncode == exitcodes.EXIT_PREEMPTED, proc.stderr[-3000:]
    assert "Traceback" not in proc.stderr
    assert "preemption (SIGTERM) honored at step boundary 2" in proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "preempted": "SIGTERM", "step": 2, "saved": True,
        "checkpoint_path": ck}
    tel = json.load(open(os.path.join(ck, "telemetry.json")))
    assert tel["counters"]["preempt_signals"] == 1
    assert tel["counters"]["preempt_saves"] == 1
    assert tel["counters"]["fault_preempt"] == 1
    assert tel["gauges"]["preempt_exit_ms"] >= 0.0
    assert tel["histograms"]["ckpt_verify_ms"]["count"] >= 1

    proc = _cli(argv)
    assert proc.returncode == exitcodes.EXIT_OK, proc.stderr[-3000:]
    assert "resumed from step 2" in proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["last_step"] \
        == 2 * BPE


def test_cli_wedge_exits_124_and_the_rerun_completes(tmp_path):
    ck = str(tmp_path / "w")
    argv = ["--checkpoint_path", ck, "--fault_plan", "wedge@step=1",
            "--wedge_timeout", "3", "--save_every_steps", "1"]
    proc = _cli(argv)
    assert proc.returncode == exitcodes.EXIT_WEDGE, proc.stderr[-3000:]
    assert "WATCHDOG: no progress" in proc.stderr
    assert integrity.verify_step_dir(
        os.path.join(ck, "recovery", "1"))[0] == "verified"
    beat = json.load(open(os.path.join(ck, "heartbeat.json")))
    assert beat["loop_step"] == 1 and beat["timeout_s"] == 3.0

    proc = _cli(argv)
    assert proc.returncode == exitcodes.EXIT_OK, proc.stderr[-3000:]
    assert "resumed from step 1" in proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["last_step"] \
        == 2 * BPE


def test_cli_negative_advantage_window_exits_4(tmp_path, capsys):
    """A greedy-baseline CST stage from a trained XE model, sampling at
    temperature 5: the samples score below the greedy decode on five
    logged steps in a row and the stage stops with exit 4."""
    xe = str(tmp_path / "xe")
    base = [a for a in TINY if a not in ("--max_epochs", "2")]
    assert train.main(base + ["--checkpoint_path", xe, "--max_epochs", "25",
                              "--learning_rate", "1e-2",
                              "--max_patience", "0"]) == 0
    capsys.readouterr()
    argv = base + ["--checkpoint_path", str(tmp_path / "cst"),
                   "--start_from", xe, "--use_rl", "1", "--rl_baseline",
                   "greedy", "--temperature", "5", "--max_epochs", "3"]
    before = signal.getsignal(signal.SIGTERM)
    assert train.main(argv + ["--abort_on_negative_advantage_window",
                              "1"]) == exitcodes.EXIT_ADVANTAGE_ABORT
    assert signal.getsignal(signal.SIGTERM) == before   # uninstalled
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["aborted"] == "negative_advantage_window"
    assert "advantage has been negative" in out["detail"]
    tel = json.load(open(tmp_path / "cst" / "telemetry.json"))
    assert tel["counters"]["negative_advantage_aborts"] == 1
