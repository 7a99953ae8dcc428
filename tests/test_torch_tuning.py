"""The port's autotuner (``tuning/record.py``, ``tuning/sweep.py``,
``python -m cst_captioning_tpu_torch.tune``) against the reference's
``tests/test_tuning.py`` cases.

Every case that resolves a record points ``CST_TUNED_CONFIGS_TORCH`` (and,
for the reference, ``CST_TUNED_CONFIGS``) at its own file with
``monkeypatch``: nothing relies on ``tests/conftest.py``.

- The record: the per-platform merge, torn and missing files, incomplete
  entries never applied, invalid values dropped with a warning (the
  port's: ``scan_unroll`` other than 1, a ``pallas`` kernel), the
  informational ``bench_batch_size``.
- Resolution: explicit flag > record > default, with the same ``applied``
  set as the reference's ``parse_opts`` for the same record (``pallas``
  written ``fused``) and the same command line; the bench's fields.
- The sweep: the reference's point space under ``pallas`` -> ``fused``
  and ``scan_unroll`` = 1, deterministic; winners (ties to the earlier
  point, base-batch points only) equal to the reference's
  ``pick_winner`` on the same seeded points; persist, reuse with zero
  measurements, resume, errored points measured again, an identity
  mismatch restarting (``measure_point`` stubbed, as the reference's tests
  do); one fast sweep through the CLI on the real ``bench_cst`` at the
  reference tests' smallest shape, then a train run resolving it.
- ``--scan_unroll 2`` refused by the train CLI and the bench;
  ``scripts/tune_report.py --record`` prints the port's record.
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

from cst_captioning_tpu_torch import bench, train
from cst_captioning_tpu_torch import tune as tune_cli
from cst_captioning_tpu_torch.telemetry.registry import MetricsRegistry
from cst_captioning_tpu_torch.training.trainer import Trainer
from cst_captioning_tpu_torch.tuning import record as record_mod
from cst_captioning_tpu_torch.tuning import sweep as sweep_mod
from cst_captioning_tpu_torch.tuning.record import (load_record,
                                                    platform_entry,
                                                    resolve_platform,
                                                    resolved_tuned_defaults,
                                                    save_platform_entry)
from cst_captioning_tpu_torch.utils.platform import git_head_sha

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The reference tests' sweep shape (tests/test_tuning.py TINY).
TINY = dict(batch_size=2, seq_per_img=2, seq_len=8, vocab=60, hidden=16,
            steps=2, bfloat16=0, native_cider=0)


def make_entry(platform="cpu", complete=True, sha="deadbeef", **winner):
    axes = {"decode_chunk": 4, "scan_unroll": 1, "overlap_rewards": 1,
            "device_rewards": 1, "decode_kernel": "fused",
            "bench_batch_size": 64}
    axes.update(winner)
    return {"platform": platform, "git_sha": sha, "complete": complete,
            "measured_at": "2026-08-04 00:00:00", "winner": axes,
            "winner_captions_per_sec": 111.0, "points": []}


@pytest.fixture
def rec(tmp_path, monkeypatch):
    path = str(tmp_path / "rec.json")
    monkeypatch.setenv(record_mod.RECORD_ENV, path)
    save_platform_entry(make_entry("cpu"), path)
    return path


# -- the record ------------------------------------------------------------

def test_per_platform_merge_never_clobbers(tmp_path):
    path = str(tmp_path / "rec.json")
    save_platform_entry(make_entry("cuda", decode_chunk=16), path)
    save_platform_entry(make_entry("cpu", decode_chunk=4), path)
    doc = load_record(path)
    assert set(doc["platforms"]) == {"cuda", "cpu"}
    assert doc["version"] == 1
    save_platform_entry(make_entry("cpu", decode_chunk=8), path)
    assert platform_entry("cpu", path)["winner"]["decode_chunk"] == 8
    assert platform_entry("cuda", path) == make_entry("cuda",
                                                      decode_chunk=16)


def test_entry_requires_platform_key(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="platform"):
        save_platform_entry({"winner": {}}, str(tmp_path / "r.json"))
    monkeypatch.setenv(record_mod.RECORD_ENV, "")
    with pytest.raises(ValueError, match="disabled"):
        save_platform_entry(make_entry("cpu"))


@pytest.mark.parametrize("text", ['{"version": 1, "platfo', "[1, 2]",
                                  '{"platforms": 3}', ""])
def test_torn_records_degrade_to_empty(tmp_path, text):
    torn = tmp_path / "torn.json"
    torn.write_text(text)
    assert load_record(str(torn))["platforms"] == {}
    assert load_record(str(tmp_path / "nope.json"))["platforms"] == {}
    assert resolved_tuned_defaults(path=str(torn), platform="cpu") == (
        {}, None)


def test_resolve_platform_is_the_device_type():
    assert resolve_platform(None) == "cuda"
    assert resolve_platform("cpu") == "cpu"
    assert resolve_platform("cuda:1") == "cuda"


def test_incomplete_entry_is_not_applied(tmp_path):
    path = str(tmp_path / "rec.json")
    save_platform_entry(make_entry("cpu", complete=False), path)
    assert resolved_tuned_defaults(path=path, device="cpu") == ({}, None)


@pytest.mark.parametrize("bad", [
    dict(scan_unroll=0), dict(scan_unroll=2), dict(decode_chunk="8"),
    dict(decode_kernel="pallas"), dict(device_rewards=3),
    dict(overlap_rewards=-1), dict(decode_chunk=True)],
    ids=lambda d: "-".join(f"{k}={v}" for k, v in d.items()))
def test_invalid_record_values_dropped_with_warning(tmp_path, capsys, bad):
    path = str(tmp_path / "rec.json")
    save_platform_entry(make_entry("cpu", **bad), path)
    tuned, prov = resolved_tuned_defaults(path=path, device="cpu")
    (axis, _), = bad.items()
    assert axis not in tuned and prov is not None
    assert set(tuned) == set(record_mod.TUNABLE_AXES) - {axis}
    assert f"invalid {axis}" in capsys.readouterr().err


def test_applied_axes_exclude_informational_keys(rec):
    tuned, prov = resolved_tuned_defaults(device="cpu")
    assert "bench_batch_size" not in tuned
    assert set(tuned) == set(record_mod.TUNABLE_AXES)
    assert prov["platform"] == "cpu" and prov["record"] == rec
    assert prov["git_sha_matches_head"] is False     # deadbeef is not HEAD
    assert resolved_tuned_defaults(device="cuda") == ({}, None)


# -- resolution against the reference's ------------------------------------

def _ref_record(tmp_path, port_entry):
    """The reference's record of the same winner (``fused`` written
    ``pallas``)."""
    from cst_captioning_tpu.tuning.record import save_platform_entry as save

    entry = json.loads(json.dumps(port_entry))
    if entry["winner"].get("decode_kernel") == "fused":
        entry["winner"]["decode_kernel"] = "pallas"
    path = str(tmp_path / "ref_rec.json")
    save(entry, path)
    return path


ARGVS = [[], ["--decode_chunk", "16"],
         ["--decode_chunk", "16", "--decode_kernel", "reference"],
         ["--overlap_rewards", "3", "--device_rewards", "0"],
         ["--decode_chunk=2", "--scan_unroll", "1"],
         ["--decode_chunk", "4", "--scan_unroll", "1", "--overlap_rewards",
          "1", "--device_rewards", "1", "--decode_kernel", "fused"]]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_applied_set_equals_the_references(argv, rec, tmp_path, monkeypatch):
    from cst_captioning_tpu.opts import parse_opts

    ref_path = _ref_record(tmp_path, make_entry("cpu"))
    monkeypatch.setenv("CST_TUNED_CONFIGS", ref_path)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    ref_argv = [{"fused": "pallas"}.get(a, a) for a in argv]
    ref = parse_opts(ref_argv).tuned_provenance
    port = train.parse_args(argv + ["--device", "cpu"]).tuned_provenance
    assert port["tuned"] == ref["tuned"]
    if ref["tuned"]:
        mapped = {k: {"pallas": "fused"}.get(v, v)
                  for k, v in ref["applied"].items()}
        assert port["applied"] == mapped
        assert port["platform"] == ref["platform"] == "cpu"
        assert port["git_sha"] == ref["git_sha"]
    json.dumps(port)                                  # rides into infos


def test_explicit_flag_wins_and_device_is_not_device_rewards(rec):
    ns = train.parse_args(["--device", "cpu", "--decode_chunk", "16",
                           "--decode_kernel", "reference"])
    assert ns.decode_chunk == 16 and ns.decode_kernel == "reference"
    assert ns.scan_unroll == 1 and ns.overlap_rewards == 1
    assert set(ns.tuned_provenance["applied"]) == {
        "scan_unroll", "overlap_rewards", "device_rewards"}
    # An abbreviated flag is the flag, as the parser reads it.
    ns = train.parse_args(["--device", "cpu", "--decode_ch", "2"])
    assert ns.decode_chunk == 2
    assert "decode_chunk" not in ns.tuned_provenance["applied"]


def test_disabled_or_other_platform_keeps_builtins(rec, monkeypatch):
    ns = train.parse_args([])                       # cuda: no entry
    assert ns.tuned_provenance == {"tuned": False}
    monkeypatch.setenv(record_mod.RECORD_ENV, "")
    ns = train.parse_args(["--device", "cpu"])
    assert ns.tuned_provenance == {"tuned": False}
    assert (ns.decode_chunk, ns.scan_unroll, ns.overlap_rewards,
            ns.device_rewards, ns.decode_kernel) == (
        train.DEFAULT_DECODE_CHUNK, train.DEFAULT_SCAN_UNROLL,
        train.DEFAULT_OVERLAP_REWARDS, train.DEFAULT_DEVICE_REWARDS,
        train.DEFAULT_DECODE_KERNEL)


@pytest.mark.parametrize("cli", ["train", "bench"])
def test_scan_unroll_other_than_one_is_refused(cli, capsys, monkeypatch):
    monkeypatch.setenv(record_mod.RECORD_ENV, "")
    parse = train.parse_args if cli == "train" else bench.parse_args
    assert parse(["--device", "cpu", "--scan_unroll", "1"]).scan_unroll == 1
    for bad in ("2", "0"):
        with pytest.raises(SystemExit) as e:
            parse(["--device", "cpu", "--scan_unroll", bad])
        assert e.value.code == 2
        assert "no scan to unroll" in capsys.readouterr().err


def test_bench_fields_follow_the_record(rec):
    args = bench.parse_args(["--device", "cpu"])
    assert bench.tuning_fields(args) == {
        "tuned": True, "tuning_record": rec,
        "tuned_axes": {"decode_chunk": 4, "scan_unroll": 1,
                       "overlap_rewards": 1, "device_rewards": 1,
                       "decode_kernel": "fused"},
        "tuning_git_sha_matches_head": False}
    assert args.overlap_depth == 1 and args.decode_chunk == 4
    explicit = bench.parse_args(["--device", "cpu", "--decode_chunk", "16",
                                 "--overlap_depth", "2"])
    assert explicit.decode_chunk == 16 and explicit.overlap_depth == 2
    assert set(bench.tuning_fields(explicit)["tuned_axes"]) == {
        "scan_unroll", "device_rewards", "decode_kernel"}
    all_flags = bench.parse_args([
        "--device", "cpu", "--decode_chunk", "4", "--scan_unroll", "1",
        "--decode_kernel", "fused", "--overlap_depth", "1",
        "--device_rewards", "1"])
    assert bench.tuning_fields(all_flags) == {"tuned": False,
                                              "tuning_record": None}
    # The same measurement: the resolved config equals the explicit one.
    assert bench.resolved_config(args) == bench.resolved_config(all_flags)


def test_bench_without_a_record_is_as_before(monkeypatch):
    monkeypatch.setenv(record_mod.RECORD_ENV, "")
    args = bench.parse_args(["--device", "cpu"])
    assert bench.tuning_fields(args) == {"tuned": False,
                                         "tuning_record": None}
    assert (args.decode_chunk, args.overlap_depth, args.device_rewards,
            args.decode_kernel) == (8, 2, 1, "fused")
    assert args.scan_unroll == 1


def test_provenance_rides_into_infos_and_telemetry(rec, tmp_path):
    ck = str(tmp_path / "xe")
    opt = train.parse_args([
        "--device", "cpu", "--synthetic_videos", "4",
        "--synthetic_val_videos", "2", "--captions_per_video", "2",
        "--feat_shapes", "2x4", "--rnn_size", "8",
        "--input_encoding_size", "8", "--att_size", "8",
        "--batch_size", "2", "--seq_per_img", "2", "--max_length", "5",
        "--max_epochs", "1", "--fast_val", "1", "--checkpoint_path", ck,
        "--decode_chunk", "3"])
    trainer = Trainer(opt)
    try:
        trainer.train()
    finally:
        trainer.close()
    with open(os.path.join(ck, "telemetry.json")) as f:
        meta = json.load(f)["meta"]["tuned_config"]
    with open(os.path.join(ck, "infos.json")) as f:
        infos = json.load(f)
    assert meta == opt.tuned_provenance == infos["opt"]["tuned_provenance"]
    assert meta["tuned"] and "decode_chunk" not in meta["applied"]
    assert opt.overlap_rewards == 1


def test_registry_meta_rides_into_the_snapshot_as_the_references(tmp_path):
    from cst_captioning_tpu.telemetry import MetricsRegistry as RefRegistry

    prov = {"tuned": True, "applied": {"decode_chunk": 4},
            "record": "/x/TUNED_CONFIGS_TORCH.json"}
    snaps = []
    for cls in (RefRegistry, MetricsRegistry):
        reg = cls()
        reg.set_meta("tuned_config", prov)
        path = str(tmp_path / f"{cls.__module__}.json")
        reg.write_snapshot(path)
        with open(path) as f:
            snaps.append(json.load(f)["meta"])
    assert snaps[0] == snaps[1] == {"tuned_config": prov}


# -- the sweep ---------------------------------------------------------------

def _ref_sweep():
    from cst_captioning_tpu.tuning import sweep as ref_sweep

    return ref_sweep


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "full"])
def test_space_is_the_references_under_fused_and_unroll_one(fast):
    ref_sweep = _ref_sweep()
    ref = [{**p, "decode_kernel": {"pallas": "fused"}.get(
        p["decode_kernel"], p["decode_kernel"])}
        for p in ref_sweep.sweep_space(ref_sweep.base_namespace(**TINY),
                                       fast=fast)
        if p["scan_unroll"] == 1]
    base = sweep_mod.base_namespace(**TINY)
    port = sweep_mod.sweep_space(base, fast=fast)
    assert port == ref
    assert port == sweep_mod.sweep_space(base, fast=fast)
    assert len(port) == (2 if fast else 17)
    assert sweep_mod.sweep_identity(base, fast) == ref_sweep.sweep_identity(
        ref_sweep.base_namespace(**TINY), fast)


@pytest.mark.parametrize("seed", range(4))
def test_winners_equal_the_references(seed):
    """Ties to the earlier point, failed points skipped, and only the
    base batch compared: the reference's ``pick_winner`` on the same
    seeded points."""
    ref_sweep = _ref_sweep()
    rng = np.random.default_rng(seed)
    space = sweep_mod.sweep_space(sweep_mod.base_namespace(**TINY))
    points = []
    for cfg in space:
        caps = (None if rng.random() < 0.2
                else float(rng.choice([5.0, 7.0, 7.0, 9.0])))
        points.append({"config": dict(cfg), "captions_per_sec": caps})
    for batch in (None, TINY["batch_size"], 2 * TINY["batch_size"]):
        assert (sweep_mod.pick_winner(points, batch_size=batch)
                is ref_sweep.pick_winner(points, batch_size=batch))
    assert sweep_mod.pick_winner(
        [{"config": {}, "captions_per_sec": None}]) is None


def _stub(calls, caps=lambda n: 100.0 + n):
    def fake_measure(base, cfg, device):
        calls.append(dict(cfg))
        return {"config": dict(cfg), "captions_per_sec": caps(len(calls)),
                "path": "device_fused"}
    return fake_measure


def test_sweep_persists_reuses_and_resumes(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(sweep_mod, "measure_point", _stub(calls))
    path = str(tmp_path / "rec.json")
    save_platform_entry(make_entry("cuda"), path)          # must survive
    base = sweep_mod.base_namespace(**TINY)
    n0 = sweep_mod.MEASUREMENTS
    entry, reused = sweep_mod.run_sweep(base, fast=False, record_path=path,
                                        device="cpu")
    assert not reused and len(calls) == 17 and entry["complete"]
    assert entry["platform"] == "cpu" and entry["device_kind"] == "cpu"
    # The 2x-batch probe (the last, most captions/s) never wins.
    assert entry["winner"]["bench_batch_size"] == TINY["batch_size"]
    assert entry["winner_captions_per_sec"] == 116.0
    assert set(entry["winner"]) == set(record_mod.TUNABLE_AXES) | {
        "bench_batch_size"}
    again, reused = sweep_mod.run_sweep(base, fast=False, record_path=path,
                                        device="cpu")
    assert reused and again == entry and len(calls) == 17
    assert sweep_mod.MEASUREMENTS == n0        # the stub counts nothing
    # A partial record resumes: only the dropped points are measured.
    doc = load_record(path)
    doc["platforms"]["cpu"]["complete"] = False
    doc["platforms"]["cpu"]["points"] = doc["platforms"]["cpu"]["points"][:5]
    from cst_captioning_tpu_torch.resilience.integrity import \
        atomic_json_write
    atomic_json_write(path, doc)
    resumed, reused = sweep_mod.run_sweep(base, fast=False,
                                          record_path=path, device="cpu")
    assert not reused and len(calls) == 17 + 12 and resumed["complete"]
    assert platform_entry("cuda", path) == make_entry("cuda")
    # --force measures everything again.
    sweep_mod.run_sweep(base, fast=True, record_path=path, device="cpu",
                        force=True)
    assert len(calls) == 29 + 2


def test_identity_mismatch_restarts_not_resumes(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(sweep_mod, "measure_point", _stub(calls))
    path = str(tmp_path / "rec.json")
    sweep_mod.run_sweep(sweep_mod.base_namespace(**TINY), fast=True,
                        record_path=path, device="cpu")
    assert len(calls) == 2
    sweep_mod.run_sweep(sweep_mod.base_namespace(**{**TINY, "steps": 3}),
                        fast=True, record_path=path, device="cpu")
    assert len(calls) == 4
    doc = load_record(path)
    doc["platforms"]["cpu"]["git_sha"] = "another"
    from cst_captioning_tpu_torch.resilience.integrity import \
        atomic_json_write
    atomic_json_write(path, doc)
    sweep_mod.run_sweep(sweep_mod.base_namespace(**{**TINY, "steps": 3}),
                        fast=True, record_path=path, device="cpu")
    assert len(calls) == 6


def test_resume_remeasures_errored_points(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(sweep_mod, "measure_point",
                        _stub(calls, caps=lambda n: 50.0))
    path = str(tmp_path / "rec.json")
    base = sweep_mod.base_namespace(**TINY)
    space = sweep_mod.sweep_space(base, fast=True)
    save_platform_entry({
        "platform": "cpu", "git_sha": git_head_sha(REPO),
        "sweep": sweep_mod.sweep_identity(base, True), "complete": False,
        "points": [
            {"config": dict(space[0]), "captions_per_sec": 100.0,
             "path": "device_fused"},
            {"config": dict(space[1]), "captions_per_sec": None,
             "path": None, "error": "transient"}]}, path)
    entry, reused = sweep_mod.run_sweep(base, fast=True, record_path=path,
                                        device="cpu")
    assert not reused and calls == [space[1]]
    assert all(p["captions_per_sec"] is not None for p in entry["points"])
    assert entry["winner"]["decode_kernel"] == "reference"   # 100 > 50


def test_a_point_that_raises_is_recorded_and_the_sweep_goes_on(
        tmp_path, monkeypatch):
    def broken(args, device, paths, probe):
        raise RuntimeError("boom")

    monkeypatch.setattr(bench, "bench_cst", broken)
    base = sweep_mod.base_namespace(**TINY)
    out = sweep_mod.measure_point(base, sweep_mod.sweep_space(base, True)[0],
                                  "cpu")
    assert out["captions_per_sec"] is None and "boom" in out["error"]


def test_a_point_that_raises_on_the_card_propagates(monkeypatch):
    """On CUDA a point's error (a kernel that does not build or launch)
    is never recorded as a skipped point."""
    def broken(args, device, paths, probe):
        raise RuntimeError("K2 failed to launch")

    monkeypatch.setattr(bench, "bench_cst", broken)
    base = sweep_mod.base_namespace(**TINY)
    n0 = sweep_mod.MEASUREMENTS
    with pytest.raises(RuntimeError, match="K2 failed to launch"):
        sweep_mod.measure_point(base, sweep_mod.sweep_space(base, True)[1],
                                torch.device("cuda"))
    assert sweep_mod.MEASUREMENTS == n0 + 1


def test_a_fused_point_that_raises_leaves_no_winner_applied(
        tmp_path, monkeypatch, capsys):
    """The tune CLI over a ``measure_point`` that raises for the ``fused``
    point, as it does on the card: the CLI fails, the entry stays
    incomplete, and neither the train CLI nor the bench applies the
    shipped point that did measure; the rerun resumes at the fused
    point."""
    calls = []
    measured = _stub(calls)

    def fused_fails(base, cfg, device):
        if cfg["decode_kernel"] == "fused":
            raise RuntimeError("K2 failed to build")
        return measured(base, cfg, device)

    monkeypatch.setattr(sweep_mod, "measure_point", fused_fails)
    path = str(tmp_path / "rec.json")
    monkeypatch.setenv(record_mod.RECORD_ENV, path)
    argv = ["--fast", "--device", "cpu", "--record", path,
            *(f"--{k}={v}" for k, v in TINY.items())]
    with pytest.raises(RuntimeError, match="K2 failed to build"):
        tune_cli.main(argv)
    assert capsys.readouterr().out == ""
    entry = platform_entry("cpu", path)
    assert entry["complete"] is False and len(entry["points"]) == 1
    assert resolved_tuned_defaults(path=path, device="cpu") == ({}, None)
    ns = train.parse_args(["--device", "cpu"])
    assert ns.tuned_provenance["tuned"] is False
    assert ns.decode_chunk == train.DEFAULT_DECODE_CHUNK
    fields = bench.tuning_fields(bench.parse_args(["--device", "cpu"]))
    assert fields["tuned"] is False
    monkeypatch.setattr(sweep_mod, "measure_point", measured)
    assert tune_cli.main(argv) == 0
    assert len(calls) == 2 and calls[1]["decode_kernel"] == "fused"
    assert platform_entry("cpu", path)["complete"] is True


def test_fast_sweep_through_the_cli_on_the_real_bench(tmp_path, monkeypatch,
                                                      capsys):
    """The real ``bench_cst`` at the reference tests' smallest shape, on
    the CPU: measured, reused with zero measurements, resolved by the
    train CLI; then tune_report prints it."""
    path = str(tmp_path / "rec.json")
    monkeypatch.setenv(record_mod.RECORD_ENV, "")
    argv = ["--fast", "--device", "cpu", "--record", path,
            *(f"--{k}={v}" for k, v in TINY.items())]
    assert tune_cli.main(argv) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["platform"] == "cpu" and first["points"] == 2
    assert first["measured"] == 2 and first["reused"] is False
    assert first["winner"]["device_rewards"] == 1
    assert first["winner_captions_per_sec"] > 0
    entry = platform_entry("cpu", path)
    assert entry["complete"] and all(
        p["captions_per_sec"] > 0 and p["path"] == "device_fused"
        and p["scorer"] == "python" for p in entry["points"])
    assert tune_cli.main(argv) == 0
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert second["reused"] is True and second["measured"] == 0
    monkeypatch.setenv(record_mod.RECORD_ENV, path)
    ns = train.parse_args(["--device", "cpu"])
    assert ns.tuned_provenance["tuned"] is True
    for axis, value in ns.tuned_provenance["applied"].items():
        assert getattr(ns, axis) == value == entry["winner"][axis]
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import tune_report
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(sys, "argv", ["tune_report.py", "--record", path])
    assert tune_report.main() == 0
    out = capsys.readouterr().out
    assert "== cpu (cpu)" in out and "fast sweep" in out
    assert "*WINNER*" in out and "complete" in out


def test_tune_cli_without_a_record_exits_2(monkeypatch, capsys):
    monkeypatch.setenv(record_mod.RECORD_ENV, "")
    assert tune_cli.main(["--fast", "--device", "cpu"]) == 2
    assert "nowhere to keep" in capsys.readouterr().err


def test_tune_report_prints_failed_points(tmp_path, monkeypatch, capsys):
    path = str(tmp_path / "rec.json")
    entry = make_entry("cuda")
    entry["device_kind"] = "NVIDIA H100 80GB HBM3"
    entry["points"] = [
        {"config": {"decode_chunk": 4, "scan_unroll": 1,
                    "overlap_rewards": 1, "device_rewards": 1,
                    "decode_kernel": "fused", "batch_size": 64},
         "captions_per_sec": 111.0, "path": "device_fused"},
        {"config": {"decode_chunk": 0, "scan_unroll": 1,
                    "overlap_rewards": 1, "device_rewards": 1,
                    "decode_kernel": "reference", "batch_size": 64},
         "captions_per_sec": None, "path": None, "error": "boom"}]
    save_platform_entry(entry, path)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import tune_report
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(sys, "argv", ["tune_report.py", "--record", path])
    assert tune_report.main() == 0
    out = capsys.readouterr().out
    assert "== cuda (NVIDIA H100 80GB HBM3)" in out
    assert "*WINNER*" in out and "failed" in out and "boom" in out


def test_point_namespace_is_the_benchs():
    base = sweep_mod.base_namespace(**TINY)
    cfg = sweep_mod.sweep_space(base, fast=False)[-5]
    ns = sweep_mod.point_namespace(base, cfg)
    assert isinstance(ns, argparse.Namespace)
    assert (ns.overlap_depth, ns.device_rewards, ns.decode_chunk) == (
        cfg["overlap_rewards"], cfg["device_rewards"], cfg["decode_chunk"])
