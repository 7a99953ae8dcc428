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


@pytest.mark.parametrize("flag", sorted(bench.REFUSED))
def test_refused_flags_raise(flag, capsys):
    value = {"serve_blackbox": "bb.json", "scan_unroll": "4",
             "replicas": "2", "serve_kill_replica": "0"}.get(flag, "1")
    with pytest.raises(SystemExit) as e:
        bench.parse_args(TINY + [f"--{flag}", value])
    assert e.value.code == 2
    assert "not ported" in capsys.readouterr().err
    # The value that leaves the part off is accepted.
    off = bench.REFUSED[flag][0]
    if off is not None:
        bench.parse_args(TINY + [f"--{flag}", str(off)])


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
