"""The port's bench (``python -m cst_captioning_tpu_torch.bench``) on the
CPU at a tiny shape: one JSON line per stage with the reference bench's
key names and headline; its FLOPs, arrival schedules and request mix
against the reference's, exactly; the refused flags; no fall-back to the
CPU.  The numbers of a CPU run are not device numbers: these tests read
the shape of the output only.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as ref_bench
from cst_captioning_tpu.serving import bench as ref_serving_bench
from cst_captioning_tpu.telemetry import flops as ref_flops
from cst_captioning_tpu_torch import bench
from cst_captioning_tpu_torch.ops import _cuda
from cst_captioning_tpu_torch.serving import bench as serving_bench
from cst_captioning_tpu_torch.telemetry import flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--batch_size", "4", "--seq_per_img", "4",
        "--vocab", "500", "--hidden", "64", "--steps", "3"]
STAGE_ARGS = {
    "both": [], "xe": [], "cst": [],
    "serving": ["--serve_requests", "6", "--serve_rate", "200"],
    "data": ["--data_batches", "6", "--data_read_ms", "1",
             "--loader_workers", "2", "--data_consumer_ms", "1"],
}
# The reference's record keys (root bench.py, run_measurement).
COMMON = {"metric", "value", "vs_baseline", "unit", "platform",
          "num_devices", "tuned", "tuning_record"}
MFU = {"model_tflops_per_step", "achieved_tflops", "mfu_pct"}
KEYS = {
    "both": COMMON | {
        "xe_captions_per_sec", "cst_captions_per_sec", "cst_path",
        "cst_host_pipeline_captions_per_sec", "cst_serial_captions_per_sec",
        "cst_fused_captions_per_sec", "cst_overlap_depth", "cst_scorer",
        "cst_decode_chunk", "cst_decode_kernel", "cst_rollout_probe",
        "cst_host_pipeline_rollout_steps", "cst_serial_rollout_steps",
        "cst_fused_rollout_steps"}
    | {f"{s}_{k}" for s in ("xe", "cst") for k in MFU},
    "xe": COMMON | MFU,
    "cst": COMMON | MFU | {
        "path", "host_pipeline_captions_per_sec", "serial_captions_per_sec",
        "fused_captions_per_sec", "overlap_depth", "scorer", "decode_chunk",
        "decode_kernel", "rollout_probe", "host_pipeline_rollout_steps",
        "serial_rollout_steps", "fused_rollout_steps"},
    "serving": COMMON | {
        "latency_p50_ms", "latency_p99_ms", "latency_mean_ms",
        "num_requests", "completed", "shed", "dropped", "rate_hz",
        "arrival_shape", "arrival_seed", "unique_videos", "zipf_alpha",
        "makespan_s", "buckets", "slots", "chunk_dispatches", "beam_size",
        "decode_chunk", "max_len", "eos_bias"},
    "data": COMMON | {
        "batches_per_sec", "consumer_ms", "data_wait_ms_mean",
        "data_wait_ms_p99", "data_wait_share", "queue_depth_mean",
        "queue_capacity", "loader_workers", "read_ms", "batches",
        "num_videos", "retries", "single_worker_captions_per_sec",
        "workers_speedup"},
}


def test_metric_names_and_baseline_are_the_references():
    assert bench.HEADLINE_METRIC == ref_bench.HEADLINE_METRIC
    assert bench.BASELINE_CAPTIONS_PER_SEC == \
        ref_bench.BASELINE_CAPTIONS_PER_SEC == 5000.0


@pytest.mark.parametrize("stage", list(STAGE_ARGS))
def test_one_json_line_per_stage(stage, capsys):
    assert bench.main(TINY + ["--stage", stage] + STAGE_ARGS[stage]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert KEYS[stage] <= set(rec), KEYS[stage] - set(rec)
    assert rec["metric"] == bench.HEADLINE_METRIC[stage]
    assert (rec["platform"], rec["device"]) == ("cpu", "cpu")
    assert rec["tuned"] is False and rec["tuning_record"] is None
    assert np.isfinite(rec["value"]) and rec["value"] > 0
    if stage == "both":
        assert rec["value"] == min(rec["xe_captions_per_sec"],
                                   rec["cst_captions_per_sec"])
        assert rec["cst_path"] == "device_fused"
        assert rec["cst_captions_per_sec"] == \
            rec["cst_fused_captions_per_sec"]
        assert rec["cst_scorer"] == "native"
        assert rec["xe_mfu_pct"] is None    # no peak for the CPU
        assert rec["vs_baseline"] == round(rec["value"] / 5000.0, 3)
        assert rec["cst_rollout_probe"]["steps_executed"] <= 30
        assert rec["config"]["steps"] == 3
        # The CPU runs the kernels' plain versions: no launches.
        assert rec["xe_launches"] == rec["cst_launches"] == {
            "fused_additive_attention": 0, "fused_decode_cell": 0}
    if stage in ("serving", "data"):
        assert rec["vs_baseline"] is None
    if stage == "serving":
        assert rec["completed"] == rec["answered"] == rec["attempted"] == 6
        assert rec["libraries_loaded_after_warmup"] == 0
        assert rec["warmup_requests"] == 1 + 4 + 8
    if stage == "data":
        assert rec["unit"] == "captions/s" and rec["retries"] == 0
        assert rec["loader_workers"] == 2


@pytest.mark.parametrize("args", [
    (32, 20, 30, 8000, 512), (4, 4, 30, 500, 64), (64, 20, 30, 7752, 512),
    (2, 3, 8, 60, 16)])
def test_caption_step_flops_equal_the_references(args):
    assert flops.caption_step_flops(*args) == \
        ref_flops.caption_step_flops(*args)


def test_mfu_fields():
    """The reference's arithmetic over the H100's dense bfloat16 peak; a
    device without a peak in the table reports ``mfu_pct`` null."""
    fl = flops.caption_step_flops(32, 20, 30, 8000, 512)["cst"]
    ours = flops.mfu_fields(fl, 9000.0, 640, "NVIDIA H100 80GB HBM3")
    ref = ref_flops.mfu_fields(fl, 9000.0, 640, "TPU v4")
    assert ours["achieved_tflops"] == ref["achieved_tflops"]
    assert ours["model_tflops_per_step"] == ref["model_tflops_per_step"]
    achieved = fl * 9000.0 / 640 / 1e12
    assert ours["mfu_pct"] == float(f"{100.0 * achieved / 989.0:.4g}")
    assert flops.mfu_fields(fl, 9000.0, 640, "cpu")["mfu_pct"] is None
    assert flops.peak_tflops("NVIDIA H100 PCIe") is None


@pytest.mark.parametrize("shape", ["poisson", "diurnal", "burst", "replay"])
@pytest.mark.parametrize("seed", [0, 777])
def test_arrivals_equal_the_references(shape, seed, tmp_path):
    trace = None
    if shape == "replay":
        trace = str(tmp_path / "trace.jsonl")
        rng = np.random.default_rng(seed)
        with open(trace, "w") as f:
            for t in rng.uniform(0, 30, 40):
                f.write(json.dumps({"t": float(t)}) + "\n")
    ours = serving_bench.make_arrivals(shape, 24, 8.0, seed,
                                       trace_path=trace)
    theirs = ref_serving_bench.make_arrivals(shape, 24, 8.0, seed,
                                             trace_path=trace)
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("alpha", [0.0, 1.1])
def test_zipfian_mix_equals_the_references(alpha):
    assert np.array_equal(serving_bench.zipfian_mix(50, 12, alpha, 779),
                          ref_serving_bench.zipfian_mix(50, 12, alpha, 779))


@pytest.fixture(scope="module")
def ref_probe_record():
    """The reference's probe record with streaming and the cache on, on a
    tiny model, and its engine's recovery counters: the key sets the
    port's records are held to."""
    import jax
    from cst_captioning_tpu.models import CaptionModel
    from cst_captioning_tpu.serving.engine import ServingEngine

    model = CaptionModel(vocab_size=20, embed_size=16, hidden_size=16,
                         attn_size=16, dropout_rate=0.0)
    variables = model.init(jax.random.PRNGKey(0),
                           [np.zeros((2, 4, 8), np.float32)],
                           np.zeros((2, 6), np.int32))
    rec = ref_serving_bench.serving_probe(
        model, variables, [(4, 8)], num_requests=4, rate_hz=50.0,
        max_len=6, decode_chunk=2, bucket_sizes=(1, 2), seed=4,
        stream=True, cache_size=8, unique_videos=2)
    recovery = ServingEngine(model, variables, [(4, 8)],
                             max_len=6).recovery_counters()
    return rec, set(recovery)


# EOS bias 0 lets the untrained model's captions run across several
# chunks (the default 10 ends them at once: nothing would stream); rate
# 5/s spaces a video's repeat well after its first decode, so it hits.
SERVE_RECORDS = {
    "stream": ["--serve_requests", "6", "--serve_rate", "200",
               "--serve_stream", "1", "--probe_eos_bias", "0"],
    "cache": ["--serve_requests", "6", "--serve_rate", "5",
              "--serve_cache", "8", "--serve_unique", "2"],
    "cache_compare": ["--serve_requests", "6", "--serve_rate", "5",
                      "--serve_cache", "8", "--serve_unique", "2",
                      "--serve_cache_compare", "1"],
}


@pytest.mark.parametrize("case", list(SERVE_RECORDS))
def test_serving_stream_and_cache_records(case, ref_probe_record, capsys):
    assert bench.main(TINY + ["--stage", "serving"]
                      + SERVE_RECORDS[case]) == 0
    rec = json.loads(capsys.readouterr().out)
    ref, recovery = ref_probe_record
    assert rec["completed"] == rec["answered"] == 6
    # The recovery audit, as the reference's probe renders it: all 0.
    assert recovery <= set(ref)
    assert {k: rec.get(k) for k in recovery} == dict.fromkeys(recovery, 0)
    st, ca = rec["stream"], rec["cache"]
    if case == "stream":
        assert set(st) == set(ref["stream"])
        assert st["enabled"] and st["prefix_ok"]
        # Precondition: every caption spans at least two chunks.
        assert st["chunks"] >= 2 * 6
        assert st["ttft_p50_ms"] is not None
        assert st["chunk_gap_p50_ms"] is not None
        assert ca == {"enabled": False}
        assert "cache_speedup" not in rec
        return
    assert st == {"enabled": False}
    assert set(ca) == set(ref["cache"])
    assert ca["enabled"] and ca["parity_ok"] and ca["parity_mismatches"] == 0
    assert ca["misses"] >= 2 and ca["hits"] >= 1
    assert ca["hits"] + ca["misses"] == 6
    assert ca["hit_rate"] == round(ca["hits"] / 6, 4)
    assert ca["bypass"] == ca["errors"] == ca["evictions"] == 0
    assert ca["entries"] == 2 and ca["capacity"] == 8
    assert rec["config"]["serve_cache"] == 8
    if case == "cache_compare":
        assert rec["cache_off_captions_per_sec"] > 0
        assert rec["cache_speedup"] == round(
            rec["value"] / rec["cache_off_captions_per_sec"], 3)
    else:
        assert "cache_speedup" not in rec


@pytest.mark.parametrize("flag", ["data_shard_id", "data_shards"])
def test_refused_flags_raise(flag, capsys):
    """The bench refuses none of the reference bench's flags any more:
    the last two, ``--data_shards`` and ``--data_shard_id``, reach the
    data stage.  What they refuse is an out-of-range value, as a usage
    error."""
    bad = {"data_shards": ["--data_shards", "-1"],
           "data_shard_id": ["--data_shard_id", "1"]}[flag]
    with pytest.raises(SystemExit) as e:
        bench.parse_args(TINY + bad)
    assert e.value.code == 2
    assert f"--{flag}" in capsys.readouterr().err
    args = bench.parse_args(TINY + ["--stage", "data", "--data_shards", "2",
                                    "--data_shard_id", "1"])
    assert (args.data_shards, args.data_shard_id) == (2, 1)
    assert bench.resolved_config(args)[flag] == getattr(args, flag)


def test_raises_without_a_gpu_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(argv + ["--stage", "xe"])


def test_cli_exits_nonzero_without_a_gpu():
    """No GPU in this process's reach and no ``--device cpu``: the CLI
    exits non-zero and prints no record."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    proc = subprocess.run(
        [sys.executable, "-m", "cst_captioning_tpu_torch.bench", "--stage",
         "xe"] + argv, cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_serving_probe_fails_on_a_library_loaded_under_the_clock(
        monkeypatch):
    model, _, _, _ = bench.build(bench.parse_args(TINY), torch.device("cpu"))
    model.eval()
    loads = iter([(), (("decode_cell", "decode_cell_forward"),)])
    monkeypatch.setattr(_cuda, "loaded_libraries", lambda: next(loads))
    with pytest.raises(RuntimeError, match="while the serving clock ran"):
        serving_bench.serving_probe(
            model, [(28, 2048), (1, 4096)], num_requests=2, rate_hz=500.0,
            max_len=4, bucket_sizes=(1, 2))


def test_warm_buckets_runs_every_bucket():
    model, _, _, _ = bench.build(bench.parse_args(TINY), torch.device("cpu"))
    model.eval()
    feats = [[np.zeros((28, 2048), np.float32), np.zeros((1, 4096),
                                                         np.float32)]]
    seen = []

    def make():
        engine = serving_bench.ServingEngine(
            model, [(28, 2048), (1, 4096)], max_len=4,
            bucket_sizes=(1, 2, 3), queue_limit=0)
        real = engine.step

        def step():
            out = real()
            seen.append(engine.stats()["slots"])
            return out

        engine.step = step
        return engine

    assert serving_bench.warm_buckets(make, feats) == 1 + 2 + 3
    assert set(seen) == {1, 2, 3}


def test_snapshot_restore_puts_back_weights_optimizer_and_noise():
    args = bench.parse_args(TINY)
    model, opt, feats, labels = bench.build(args, torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    weights0 = {k: v.clone() for k, v in model.state_dict().items()}
    snap = bench.snapshot(model, opt, gen)
    draw = torch.rand(5, generator=gen)
    for _ in range(2):
        bench.xe_step(model, opt, feats, labels,
                      torch.ones(labels.shape[0]), args.seq_per_img, gen)
    assert opt.count.item() == 2.0
    bench.restore(model, opt, gen, snap)
    assert opt.count.item() == 0.0
    assert all(torch.equal(v, weights0[k])
               for k, v in model.state_dict().items())
    assert all(torch.count_nonzero(v) == 0 for st in opt.state
               for v in st.values())
    assert torch.equal(torch.rand(5, generator=gen), draw)


def test_cst_paths_each_start_from_the_first_state(monkeypatch):
    """The host pipeline, the serial loop and the fused step each time
    their first step from the weights the first warm-up started from:
    the rate of one path does not depend on the steps of the others."""
    seen = {"rollout": [], "fused": []}

    def weights(model):
        return torch.cat([p.detach().flatten().float()
                          for p in model.parameters()]).clone()

    real_rollout, real_fused = bench.rollout, bench.fused_cst_step

    def rollout(model, *a, **kw):
        seen["rollout"].append(weights(model))
        return real_rollout(model, *a, **kw)

    def fused(model, *a, **kw):
        seen["fused"].append(weights(model))
        return real_fused(model, *a, **kw)

    monkeypatch.setattr(bench, "rollout", rollout)
    monkeypatch.setattr(bench, "fused_cst_step", fused)
    args = bench.parse_args(TINY + ["--decode_chunk", "0"])
    bench.bench_cst(args, torch.device("cpu"))
    r, f = seen["rollout"], seen["fused"]
    # 2 warm-up rollouts, then 3 host-pipeline and 3 serial ones; the
    # fused step's warm-up and 3 timed steps.
    assert len(r) == 8 and len(f) == 4
    first = r[0]
    for w in (r[2], r[5], f[0], f[1]):
        assert torch.equal(w, first)
    # Each loop trained as it ran: the state was restored, not untouched.
    assert not torch.equal(r[7], first) and not torch.equal(f[3], first)


# -- the fleet and the lifecycle tracer in the serving stage ------------------

FLEET_ARGS = ["--stage", "serving", "--serve_requests", "6",
              "--serve_rate", "200", "--probe_eos_bias", "0",
              "--serve_buckets", "1,2"]


def _bench_record(capsys, *extra):
    assert bench.main(TINY + FLEET_ARGS + list(extra)) == 0
    return json.loads(capsys.readouterr().out)


def test_serving_fleet_with_a_kill_keeps_parity(capsys):
    rec = _bench_record(capsys, "--replicas", "2", "--serve_kill_replica",
                        "0")
    fl = rec["fleet"]
    assert fl["enabled"] and fl["replicas"] == 2
    assert fl["parity_ok"] is True and fl["parity_mismatches"] == 0
    assert fl["killed_replica"] == 0
    assert (fl["fleet_replica_kills"], fl["fleet_replica_restarts"]) == (1, 1)
    assert fl["answered"] == rec["completed"] == 6
    assert len(fl["per_replica"]) == 2
    assert rec["replicas_share_device"] is True
    assert rec["libraries_loaded_after_warmup"] == 0
    assert rec["lifecycle"] == {"enabled": False}
    assert (rec["config"]["replicas"], rec["config"]["serve_kill_replica"],
            rec["config"]["serve_trace"]) == (2, 0, 0)


def test_serving_trace_writes_a_balanced_blackbox(capsys, tmp_path):
    box = tmp_path / "bb.json"
    rec = _bench_record(capsys, "--serve_trace", "1", "--serve_blackbox",
                        str(box))
    lc = rec["lifecycle"]
    assert lc["enabled"] and lc["terminal_ok"] and lc["submitted"] == 6
    assert lc["blackbox"] == str(box)
    assert rec["attribution"]["reconcile_ok"]
    assert rec["attribution"]["requests"] == 6
    doc = json.loads(box.read_text())
    assert doc["reason"] == "probe_end" and doc["accounting"]["terminal_ok"]
    assert "fleet" not in rec and "replicas_share_device" not in rec
    assert rec["config"]["serve_trace"] == 1


@pytest.fixture(scope="module")
def ref_fleet_probe(tmp_path_factory):
    """The reference probe's fleet, lifecycle and attribution records on a
    tiny model with replicas, a kill and the tracer on."""
    import jax
    from cst_captioning_tpu.models import CaptionModel

    model = CaptionModel(vocab_size=20, embed_size=16, hidden_size=16,
                         attn_size=16, dropout_rate=0.0)
    variables = model.init(jax.random.PRNGKey(0),
                           [np.zeros((2, 4, 8), np.float32)],
                           np.zeros((2, 6), np.int32))
    return ref_serving_bench.serving_probe(
        model, variables, [(4, 8)], num_requests=6, rate_hz=200.0,
        max_len=6, decode_chunk=2, bucket_sizes=(1, 2), seed=4,
        replicas=2, kill_replica=0, lifecycle=True,
        blackbox_path=str(tmp_path_factory.mktemp("ref") / "bb.json"))


@pytest.mark.parametrize("record", ["fleet", "lifecycle", "attribution"])
def test_fleet_and_lifecycle_keys_are_the_references(record, capsys,
                                                     tmp_path,
                                                     ref_fleet_probe):
    rec = _bench_record(capsys, "--replicas", "2", "--serve_kill_replica",
                        "0", "--serve_trace", "1", "--serve_blackbox",
                        str(tmp_path / "bb.json"))
    assert set(rec[record]) == set(ref_fleet_probe[record])
    if record == "attribution":
        assert set(rec[record]["components"]) == \
            set(ref_fleet_probe[record]["components"])


@pytest.fixture(scope="module")
def port_fleet_record(tmp_path_factory):
    """One traced fleet record of the port's bench, with a kill."""
    import contextlib
    import io

    out = io.StringIO()
    box = tmp_path_factory.mktemp("port") / "bb.json"
    with contextlib.redirect_stdout(out):
        assert bench.main(TINY + FLEET_ARGS + [
            "--replicas", "2", "--serve_kill_replica", "1",
            "--serve_trace", "1", "--serve_blackbox", str(box)]) == 0
    return json.loads(out.getvalue())


def _serve_report(record, tmp_path):
    path = tmp_path / "serving.json"
    path.write_text(json.dumps(record) + "\n")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "serve_report.py"),
         "--file", str(path)], capture_output=True, text=True, cwd=REPO,
        timeout=120)


@pytest.mark.parametrize("fault", [None, "parity", "accounting",
                                   "reconcile"])
def test_serve_report_gates_pass_on_the_ports_records(fault, tmp_path,
                                                      port_fleet_record):
    """The reference's report (standard library only) reads the port's
    fleet and lifecycle records: its gates pass on a real record and fail
    on the same record with one verdict flipped."""
    rec = json.loads(json.dumps(port_fleet_record))
    if fault == "parity":
        rec["fleet"].update(parity_ok=False, parity_mismatches=1)
    elif fault == "accounting":
        rec["lifecycle"].update(terminal_ok=False, unterminated=1)
    elif fault == "reconcile":
        rec["attribution"]["reconcile_ok"] = False
    proc = _serve_report(rec, tmp_path)
    if fault is None:
        assert proc.returncode == 0, proc.stderr
        assert "captions/s/fleet" in proc.stdout
        assert "replica 0" in proc.stdout and "replica 1" in proc.stdout
        assert "parity_ok=True" in proc.stdout
        assert "queue_wait" in proc.stdout
    else:
        assert proc.returncode == 1, proc.stdout
        assert "!!" in proc.stderr
