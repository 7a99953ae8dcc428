#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit);
2. build of both CUDA kernels from ``cst_captioning_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together;
3. each kernel against its plain PyTorch version on seeded inputs at the
   serving shapes (B in 1, 8, 40; T=29, A=H=E=512), max-abs error within
   1e-5, and times (device time from ``torch.profiler``; the CUDA-event
   time of back-to-back calls beside it) next to each kernel's bound;
4. greedy serving at full MSR-VTT width through the port's entry points
   (``serve.build_backend`` -> ``ServingEngine`` -> ``CaptionServer``):
   16 requests, decode kernel ``fused`` (K2); every request completes
   and equals the offline ``greedy_decode`` of the same videos;
5. beam-5 serving, 8 requests, against the offline ``beam_search``;
6. the reference cell with the K1 attention kernel over the phase-4
   requests, against its own offline decode, with its agreement with
   phase 4 printed.

Each serving phase sets every kernel's launch count to 0 just before it
and reads the counts just after; a kernel of the path that was not
launched fails the run.  The line before the last is a JSON object with
one entry per kernel; the last line is ``{"ok": true, "device": ...}``.
Without a CUDA device, or run outside a checkout of the repository, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TOL = 1e-5

# Full MSR-VTT width served by the port: data/bench.py's default vocab
# and feature shapes (28 x 2048 + 1 x 4096), hidden/embed/attention 512.
MAX_LEN, CHUNK = 30, 8
WIDTH_ARGS = ["--vocab_size", "8000", "--rnn_size", "512",
              "--input_encoding_size", "512", "--att_size", "512",
              "--feat_shapes", "28x2048,1x4096",
              "--max_length", str(MAX_LEN), "--decode_chunk", str(CHUNK),
              "--serve_buckets", "1,4,8",
              "--serve_videos", "16", "--seed", "0"]
# EOS-logit bias of the seeded model: captions end at mixed lengths.
EOS_BIAS = "0.35"
T_MEM, E, H, A = 29, 512, 512, 512


EXIT_FAILURE = 1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(EXIT_FAILURE)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of one ``fn()`` over ``iters`` back-to-back calls
    (CUDA events; the weights stay in the 50 MB L2 between calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 50):
    """Device time per ``fn()`` from ``torch.profiler``: the sum of the
    CUDA kernels' time over ``iters`` calls, divided by ``iters`` (host
    overhead between launches excluded).  -> (ms per call, wall ms per
    call of the same profiled calls (host clock, profiler overhead
    included), top kernels as [(name, ms per call, launches per call)]).
    Fails the run when the profiler reports no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        fail("torch.profiler reported no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return total_us / iters / 1e3, wall_ms, [
        (e.key[:60], e.self_device_time_total / iters / 1e3,
         e.count / iters) for e in top]


def timed(fn) -> dict:
    """``ms``: profiler kernel time per call (device time only);
    ``call_ms``: CUDA-event time per call back to back (what the stream
    sees, host launch gaps included)."""
    dev, _, _ = device_profile(fn)
    return {"ms": dev, "call_ms": cuda_ms(fn)}


def bound_ms(n_bytes: float, n_ops: float):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def attention_inputs(b: int, gen):
    import torch

    def r(*shape):
        return torch.randn(*shape, generator=gen).cuda()

    return r(b, A), r(b, T_MEM, A), r(b, T_MEM, H), r(A) / A ** 0.5


def kernel_checks():
    """Phase 3: K1 and K2 against their plain versions at B in 1, 8, 40.
    -> {kernel: {batch: measurement dict}}."""
    import torch

    from cst_captioning_tpu_torch.ops import attention_kernel as k1
    from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2

    gen = torch.Generator().manual_seed(1234)
    res = {"K1": {}, "K2": {}}
    for b in (1, 8, 40):
        q, pm, mem, v = attention_inputs(b, gen)
        ctx, w = k1.fused_additive_attention(q, pm, mem, v)
        torch.cuda.synchronize()
        ctx_p, w_p = k1.additive_attention_plain(q, pm, mem, v)
        err = max((ctx - ctx_p).abs().max().item(),
                  (w - w_p).abs().max().item())
        n_bytes = 4 * (b * A + b * T_MEM * A + b * T_MEM * H + A
                       + b * H + b * T_MEM)
        n_ops = b * (4 * T_MEM * A + 5 * T_MEM + 2 * T_MEM * H)
        bound, by = bound_ms(n_bytes, n_ops)
        k, p = (timed(lambda: k1.fused_additive_attention(q, pm, mem, v)),
                timed(lambda: k1.additive_attention_plain(q, pm, mem, v)))
        res["K1"][b] = {
            "max_abs_err": err, **k, "plain_ms": p["ms"],
            "plain_call_ms": p["call_ms"], "bound_ms": bound,
            "bound_by": by, "library_ms": None}

        x = torch.randn(b, E, generator=gen).cuda()
        c = torch.randn(b, H, generator=gen).cuda()
        h = torch.tanh(torch.randn(b, H, generator=gen)).cuda()
        wg = (torch.randn(E + 2 * H, 4 * H, generator=gen)
              / (E + H) ** 0.5).cuda()
        bias = (0.1 * torch.randn(4 * H, generator=gen)).cuda()
        args = (x, c, h, q, pm, mem, v, wg, bias)
        c_k, h_k = k2.fused_decode_cell(*args)
        torch.cuda.synchronize()
        c_p, h_p = k2.decode_cell_plain(*args)
        err = max((c_k - c_p).abs().max().item(),
                  (h_k - h_p).abs().max().item())
        n_bytes = 4 * (b * (E + 2 * H + A) + b * T_MEM * (A + H) + A
                       + (E + 2 * H) * 4 * H + 4 * H + 2 * b * H)
        n_ops = (b * (4 * T_MEM * A + 5 * T_MEM + 2 * T_MEM * H)
                 + 2 * b * (E + 2 * H) * 4 * H + 10 * b * H)
        bound, by = bound_ms(n_bytes, n_ops)
        xin = torch.cat([x, torch.randn(b, H, device="cuda"), h], dim=-1)
        k, p, lib = (timed(lambda: k2.fused_decode_cell(*args)),
                     timed(lambda: k2.decode_cell_plain(*args)),
                     # The gate product alone as one library call
                     # (a yardstick; the port never calls it).
                     timed(lambda: torch.addmm(bias, xin, wg)))
        res["K2"][b] = {
            "max_abs_err": err, **k, "plain_ms": p["ms"],
            "plain_call_ms": p["call_ms"], "bound_ms": bound,
            "bound_by": by, "library_ms": lib["ms"],
            "library_call": "torch.addmm (gate product only)"}
        for name in ("K1", "K2"):
            m = res[name][b]
            print(f"kernel {name} B={b}: max_abs_err={m['max_abs_err']:.3e} "
                  f"ms={m['ms']:.5f} (call {m['call_ms']:.5f}) "
                  f"plain_ms={m['plain_ms']:.5f} (call "
                  f"{m['plain_call_ms']:.5f}) bound_ms={m['bound_ms']:.5f} "
                  f"({m['bound_by']}) library_ms={m['library_ms']}")
            if not m["max_abs_err"] <= TOL:
                fail(f"{name} at B={b} disagrees with its plain version: "
                     f"{m['max_abs_err']:.3e} > {TOL}")
    return res


def serve_phase(name: str, extra_args, n_requests: int):
    """Build the backend through the CLI's own parser and serve
    ``n_requests`` JSONL lines through ``CaptionServer``.  -> (model,
    vocab, feats_for, {video_id: caption}, engine stats, launches,
    seconds)."""
    import torch

    from cst_captioning_tpu_torch import serve
    from cst_captioning_tpu_torch.ops import launch_counts, \
        reset_launch_counts
    from cst_captioning_tpu_torch.serving.buckets import parse_buckets
    from cst_captioning_tpu_torch.serving.engine import ServingEngine
    from cst_captioning_tpu_torch.serving.server import CaptionServer

    opt = serve.parse_args(["--serve_demo", "1",
                            "--serve_demo_eos_bias", EOS_BIAS]
                           + WIDTH_ARGS + list(extra_args))
    model, vocab, feat_shapes, feats_for = serve.build_backend(opt)

    def engine():
        return ServingEngine(
            model, feat_shapes, max_len=opt.max_length,
            beam_size=opt.beam_size, decode_chunk=opt.decode_chunk,
            bucket_sizes=parse_buckets(opt.serve_buckets),
            queue_limit=opt.serve_queue_limit)

    lines = [json.dumps({"id": i, "video_id": f"v{i}"}) + "\n"
             for i in range(n_requests)]
    # Warm-up: one request through a throw-away engine (cuBLAS handles,
    # allocator); not counted.
    CaptionServer(engine(), vocab, feats_for,
                  out=io.StringIO()).run_stdin(lines=lines[:1])
    torch.cuda.synchronize()

    eng = engine()
    out = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = CaptionServer(eng, vocab, feats_for, out=out).run_stdin(
        lines=lines)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    if rc != 0:
        fail(f"{name}: server exited {rc}")
    replies = [json.loads(ln) for ln in out.getvalue().splitlines()]
    errors = [r for r in replies if "error" in r]
    if errors:
        fail(f"{name}: error replies {errors[:3]}")
    captions = {r["video_id"]: r["caption"] for r in replies}
    if len(captions) != n_requests:
        fail(f"{name}: {len(captions)} of {n_requests} requests completed")
    stats = eng.stats()
    lengths = {}
    for cap in captions.values():
        n = len(cap.split())
        lengths[n] = lengths.get(n, 0) + 1
    print(f"{name}: {n_requests} requests in {seconds:.4f} s = "
          f"{n_requests / seconds:.3f} req/s; decode_ms_per_step="
          f"{stats['decode_ms_per_step']:.4f} "
          f"(steps={stats['decode_steps']}, slots={stats['slots']}); "
          f"latency p50={stats['latency_p50_ms']:.3f} ms "
          f"p99={stats['latency_p99_ms']:.3f} ms; "
          f"caption-length histogram={dict(sorted(lengths.items()))}; "
          f"launches={launches}")
    if len(lengths) < 2:
        print(f"{name}: note: every caption has the same length",
              file=sys.stderr)

    def replay():
        eng = engine()
        for i in range(n_requests):
            eng.submit(i, feats_for(f"v{i}"))
        eng.run_until_idle()

    # Where the device time goes: the same requests on a fresh engine
    # under the profiler; device time and wall time are both of this
    # profiled replay (the counts above are from the unprofiled run).
    dev_ms, wall_ms, top = device_profile(replay, iters=1)
    print(f"{name}: profiled replay: device kernel time {dev_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall = busy share {dev_ms / wall_ms:.3f}; top "
          "kernels (name, ms, launches): "
          + "; ".join(f"{k} {ms:.3f} {n:.0f}" for k, ms, n in top))
    return model, vocab, feats_for, captions, stats, launches, seconds


def offline_captions(model, vocab, feats_for, n: int, beam_size: int):
    """The offline decoders of the port on the same videos, one batch."""
    import numpy as np
    import torch

    from cst_captioning_tpu_torch.ops.beam import beam_search
    from cst_captioning_tpu_torch.ops.sampling import greedy_decode

    feats = [torch.from_numpy(np.stack([feats_for(f"v{i}")[m]
                                        for i in range(n)])).cuda()
             for m in range(len(model.feat_dims))]
    if beam_size == 1:
        toks = greedy_decode(model, feats, MAX_LEN, decode_chunk=CHUNK)
    else:
        toks = beam_search(model, feats, beam_size, MAX_LEN,
                           decode_chunk=CHUNK)[0]
    return {f"v{i}": cap for i, cap in
            enumerate(vocab.decode_batch(toks.cpu().numpy()))}


def check_against_offline(name, served, offline):
    same = sum(served[v] == offline[v] for v in offline)
    print(f"{name}: {same}/{len(offline)} captions equal to the offline "
          f"decode")
    if same != len(offline):
        bad = [v for v in offline if served[v] != offline[v]][:3]
        fail(f"{name}: served captions differ from the offline decode "
             f"for {bad}")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "cst_captioning_tpu_torch")):
        print("chip_smoke: no cst_captioning_tpu_torch package beside "
              "this script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs one CUDA device", file=sys.stderr)
        return 1

    from cst_captioning_tpu_torch.ops import _cuda

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          + json.dumps({n: round(b["seconds"], 2) for n, b in built.items()}))
    for name, b in built.items():
        for ln in b["ptxas"].splitlines():
            print(f"build {name}: {ln.strip()}")

    measured = kernel_checks()

    # Phase 4: greedy, K2 on every decode step.
    model, vocab, feats_for, greedy_caps, g_stats, g_launch, _ = \
        serve_phase("greedy-fused", ["--decode_kernel", "fused",
                                     "--beam_size", "1"], 16)
    if g_launch["fused_decode_cell"] == 0:
        fail("greedy serving did not launch the K2 decode-cell kernel")
    check_against_offline("greedy-fused", greedy_caps,
                          offline_captions(model, vocab, feats_for, 16, 1))

    # Phase 5: beam 5, K2.
    model, vocab, feats_for, beam_caps, b_stats, b_launch, _ = \
        serve_phase("beam5-fused", ["--decode_kernel", "fused",
                                    "--beam_size", "5"], 8)
    if b_launch["fused_decode_cell"] == 0:
        fail("beam serving did not launch the K2 decode-cell kernel")
    check_against_offline("beam5-fused", beam_caps,
                          offline_captions(model, vocab, feats_for, 8, 5))

    # Phase 6: reference cell, attention on K1.
    model, vocab, feats_for, ref_caps, r_stats, r_launch, _ = \
        serve_phase("greedy-reference-k1",
                    ["--decode_kernel", "reference", "--pallas_attention",
                     "1", "--beam_size", "1"], 16)
    if r_launch["fused_additive_attention"] == 0:
        fail("reference-cell serving did not launch the K1 kernel")
    check_against_offline("greedy-reference-k1", ref_caps,
                          offline_captions(model, vocab, feats_for, 16, 1))
    agree = sum(ref_caps[v] == greedy_caps[v] for v in greedy_caps)
    print(f"greedy-reference-k1: {agree}/{len(greedy_caps)} captions equal "
          f"to greedy-fused (the two cells differ by float32 rounding)")

    # The kernels line: launches from the serving phases; times at B=8,
    # the greedy serving batch (8-slot bucket).
    launches = {"K1": r_launch["fused_additive_attention"],
                "K2": g_launch["fused_decode_cell"]
                + b_launch["fused_decode_cell"]}
    meta = {
        "K1": ("fused_additive_attention", "cst_captioning_tpu_torch/csrc/"
               "attention.cu", "cst_captioning_tpu/ops/pallas_attention.py:86"),
        "K2": ("fused_decode_cell", "cst_captioning_tpu_torch/csrc/"
               "decode_cell.cu",
               "cst_captioning_tpu/ops/pallas_decode_cell.py:139"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        m = measured[key][8]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": max(measured[key][b]["max_abs_err"]
                               for b in measured[key]),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "batch": 8,
            "call_ms": m["call_ms"],
            "by_batch": {str(b): measured[key][b] for b in measured[key]}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
