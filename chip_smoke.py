#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit);
2. build of both CUDA kernels from ``cst_captioning_tpu_torch/csrc``,
   one ``nvcc`` per source, all started together;
3. each kernel against its plain PyTorch version on seeded inputs at the
   serving shapes (B in 1, 8, 40; T=29, A=H=E=512), max-abs error within
   1e-5, and times next to each kernel's bound: device time from
   ``torch.profiler`` (the kernels' summed durations, and the busy time
   and overlap of their intervals in the trace), ``graph_ms`` (CUDA events
   around a CUDA-graph replay of back-to-back calls: no host gaps),
   ``cold_ms`` (the same with L2 flushed before every call, the flush's
   own time taken off), ``call_ms`` (CUDA events around back-to-back
   wrapper calls, host gaps included) and the wrapper's host microseconds
   per call;
4. greedy serving at full MSR-VTT width through the port's entry points
   (``serve.build_backend`` -> ``ServingEngine`` -> ``CaptionServer``):
   16 requests, decode kernel ``fused`` (K2); every request completes
   and equals the offline ``greedy_decode`` of the same videos;
5. beam-5 serving, 8 requests, against the offline ``beam_search``;
6. the reference cell with the K1 attention kernel over the phase-4
   requests, against its own offline decode, with its agreement with
   phase 4 printed;
7. training at full width through the train CLI's parser and ``Trainer``
   (``python -m cst_captioning_tpu_torch.train``): a synthetic train
   split at MSR-VTT's size (6513 videos x 20 captions, rich vocabulary
   8000, which realises 7752 rows) and a 497-video val split; then XE
   (2 warm-up + 10 timed steps), WXE (3 timed), and CST with the greedy
   baseline on both of its paths, each stage a fresh ``Trainer`` started
   from the previous one's ``best.pt``.  CST first on the default fused
   path (``--device_rewards 1``: rollout, on-device CIDEr-D, gradient and
   guarded update; the table build, the table bytes and the match
   envelope printed; 1 warm-up + 3 timed steps with the per-phase
   medians from CUDA events); one all-NaN feature batch through the
   guarded fused step (``bad_step`` 1, every parameter and optimizer
   tensor bit-identical); one validation pass; one real rollout's 1344
   captions scored on the device against the host CIDEr-D within 1e-4
   relative; then the host-reward path (``--device_rewards 0
   --overlap_rewards 2``: 2 pushes to fill the pipeline, 1 warm-up and 2
   timed steady iterations, the drain).  K1 runs every teacher-forced
   step (``--pallas_attention 1``) and K2 every rollout and validation
   step (``--decode_kernel fused``).  Before the stages: K1 (forward,
   and the gradients of its autograd backward) at the training batch
   B = 1280 and K2 at the rollout batch B = 1344, against their plain
   versions within 1e-5, with times; K1's gradients through the kernel
   equal, bit for bit, the plain backward on the same inputs and
   upstream gradients at B = 64.

Each serving phase sets every kernel's launch count to 0 just before it
and reads the counts just after; a kernel of the path launched other
than its count per decode step (K2 twice, K1 once) fails the run.  The
training phase does the same around each timed step: K1 exactly
``max_length`` launches per teacher-forced forward (one per step the
iteration completed), K2 exactly 2 per executed step of the rollout it
dispatched; the fused path builds no host reward.

Output: phase lines as they run; then a JSON object with one entry per
kernel (times at the serving batch B = 8, every measured batch under
``by_batch``); then the card line (``nvidia-smi`` name and power limit);
and last ``{"ok": true, "device": ...}``.  Without a CUDA device, or run
outside a checkout of the repository, the script exits non-zero and
prints no result.
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
# Written before every call of a cold-L2 timing: over twice the 50 MB L2.
FLUSH_BYTES = 128 << 20

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
# Phase 7: the reference's default batch (64 videos x 20 captions), the
# rollout's rows (the samples and one greedy row per video), and the
# vocabulary the synthetic MSR-VTT-size split realises (measured with the
# reference's generator).
TRAIN_BATCH, TRAIN_SEQ = 64, 20
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ
ROLLOUT_ROWS = TRAIN_ROWS + TRAIN_BATCH
TRAIN_VOCAB = 7752


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


def busy_and_overlap(spans):
    """(busy, overlap) of device intervals [(start, end)]: the time some
    interval covers (each instant once), and the time covered by two at
    once (what the kernels' summed durations count twice)."""
    busy = overlap = 0.0
    end = float("-inf")
    for s, e in sorted(spans):
        if s < end:
            overlap += min(e, end) - s
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy, overlap


def device_profile(fn, iters: int = 50):
    """Device time per ``fn()`` from ``torch.profiler`` over ``iters``
    calls (host overhead between launches excluded): ``ms`` is the sum of
    the device activities' durations, ``busy_ms`` the time the trace shows
    the device busy (overlapping intervals counted once) and
    ``overlap_ms`` the time two ran at once; ``wall_ms`` is the host clock
    of the same profiled calls (profiler overhead included); ``top`` the
    top kernels as [(name, ms per call, launches per call)].  Fails the
    run when the profiler reports no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A profiling session now and then comes back without its device
    # events (seen once in ~20 sessions, torch 2.11, H100); such a session
    # is taken again, up to twice, and said so.
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        total_us = sum(e.self_device_time_total for e in kernels)
        if total_us > 0:
            break
        print(f"profiler: session {attempt + 1} reported no device time",
              file=sys.stderr)
    else:
        fail("torch.profiler reported no device time in 3 sessions")
    busy_us, overlap_us = busy_and_overlap(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"ms": total_us / iters / 1e3,
            "busy_ms": busy_us / iters / 1e3,
            "overlap_ms": overlap_us / iters / 1e3, "wall_ms": wall_ms,
            "top": [(e.key[:60], e.self_device_time_total / iters / 1e3,
                     e.count / iters) for e in top]}


def capture(fn, n: int):
    """A CUDA graph of ``n`` back-to-back ``fn()`` calls, replayed once."""
    import torch

    for _ in range(3):      # allocator, library handles, kernel attributes
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return g


def graph_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time per ``fn()`` free of host gaps: CUDA events around
    ``reps`` replays of one CUDA graph of ``n`` back-to-back calls."""
    import torch

    g = capture(fn, n)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def graph_trace(fn, n: int = 20) -> dict:
    """The profiler's trace of replays of a graph of ``n`` calls, per
    call: ``busy_ms`` and ``overlap_ms`` (where the two launches of K2
    overlap, the trace shows it here)."""
    g = capture(fn, n)
    prof = device_profile(g.replay, iters=5)
    return {"graph_busy_ms": prof["busy_ms"] / n,
            "graph_overlap_ms": prof["overlap_ms"] / n}


def cold_ms(fn, flush) -> float:
    """``graph_ms`` with L2 flushed before every call (``flush`` is
    written), less the graph time of the flushes alone."""

    def flush_then_call():
        flush.fill_(1.0)
        fn()

    return (graph_ms(flush_then_call, n=10, reps=5)
            - graph_ms(lambda: flush.fill_(1.0), n=10, reps=5))


def host_us(fn, n: int = 200) -> float:
    """Host microseconds per ``fn()`` (the wrapper's checks, allocations
    and launches), the device left to run behind."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / n * 1e6


def timed(fn, flush, trace_graph: bool = False) -> dict:
    """Every time of ``fn`` that the kernels line carries (see the module
    docstring): ``ms``, ``busy_ms``, ``overlap_ms`` (profiler),
    ``graph_ms``, ``cold_ms``, ``call_ms``, ``host_us``; with
    ``trace_graph`` also ``graph_busy_ms`` and ``graph_overlap_ms``."""
    prof = device_profile(fn)
    out = {"ms": prof["ms"], "busy_ms": prof["busy_ms"],
           "overlap_ms": prof["overlap_ms"], "graph_ms": graph_ms(fn),
           "cold_ms": cold_ms(fn, flush), "call_ms": cuda_ms(fn),
           "host_us": host_us(fn)}
    if trace_graph:
        out.update(graph_trace(fn))
    return out


def bound_ms(n_bytes: float, n_ops: float):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_OPS_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def k1_bound(b: int):
    n_bytes = 4 * (b * A + b * T_MEM * A + b * T_MEM * H + A + b * H
                   + b * T_MEM)
    return bound_ms(n_bytes, b * (4 * T_MEM * A + 5 * T_MEM + 2 * T_MEM * H))


def k2_bound(b: int):
    n_bytes = 4 * (b * (E + 2 * H + A) + b * T_MEM * (A + H) + A
                   + (E + 2 * H) * 4 * H + 4 * H + 2 * b * H)
    n_ops = (b * (4 * T_MEM * A + 5 * T_MEM + 2 * T_MEM * H)
             + 2 * b * (E + 2 * H) * 4 * H + 10 * b * H)
    return bound_ms(n_bytes, n_ops)


def attention_inputs(b: int, gen):
    import torch

    def r(*shape):
        return torch.randn(*shape, generator=gen).cuda()

    return r(b, A), r(b, T_MEM, A), r(b, T_MEM, H), r(A) / A ** 0.5


def check_k1(b: int, attn, gen, flush, backward: bool = False) -> dict:
    """K1 at batch ``b`` on the attention inputs ``attn`` against its plain
    version; times next to its bound.  With ``backward``, the forward runs
    under autograd with upstream gradients drawn from ``gen``: its
    gradients are held against autograd through the plain forward (error
    relative to max(1, max|g|)) and the plain backward is timed too."""
    import torch

    from cst_captioning_tpu_torch.ops import attention_kernel as k1

    q, pm, mem, v = attn
    if backward:
        g_ctx = torch.randn(b, H, generator=gen).cuda()
        g_w = torch.randn(b, T_MEM, generator=gen).cuda()
        leaves = [t.clone().requires_grad_() for t in attn]
        ctx, w = k1.fused_additive_attention(*leaves)
        torch.autograd.backward([ctx, w], [g_ctx, g_w])
        plain_leaves = [t.clone().requires_grad_() for t in attn]
        torch.autograd.backward(
            list(k1.additive_attention_plain(*plain_leaves)), [g_ctx, g_w])
    else:
        ctx, w = k1.fused_additive_attention(q, pm, mem, v)
    torch.cuda.synchronize()
    ctx_p, w_p = k1.additive_attention_plain(q, pm, mem, v)
    err = max((ctx - ctx_p).abs().max().item(),
              (w - w_p).abs().max().item())
    bound, by = k1_bound(b)
    k, p = (timed(lambda: k1.fused_additive_attention(q, pm, mem, v), flush),
            timed(lambda: k1.additive_attention_plain(q, pm, mem, v), flush))
    m = {"max_abs_err": err, "ms": k["ms"], "ms_is": "profiler",
         "plain_ms": p["ms"], "bound_ms": bound, "bound_by": by,
         "library_ms": None, "kernel": k, "plain": p}
    if backward:
        m["grad_rel_err"] = max(
            ((a.grad - g.grad).abs().max()
             / max(1.0, g.grad.abs().max().item())).item()
            for a, g in zip(leaves, plain_leaves))
        bwd = timed(lambda: k1.additive_attention_backward(
            q, pm, mem, v, g_ctx, g_w), flush)
        m.update({"backward_ms": bwd["ms"],
                  "backward_graph_ms": bwd["graph_ms"]})
    return m


def check_k2(b: int, attn, gen, flush) -> dict:
    """K2 at batch ``b`` (attention inputs ``attn``, the rest drawn from
    ``gen``) against its plain version; times next to its bound and to
    ``torch.addmm`` of its gate product."""
    import torch

    from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2

    q, pm, mem, v = attn
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
    bound, by = k2_bound(b)
    xin = torch.cat([x, torch.randn(b, H, device="cuda"), h], dim=-1)
    k, p, lib = (timed(lambda: k2.fused_decode_cell(*args), flush,
                       trace_graph=True),
                 timed(lambda: k2.decode_cell_plain(*args), flush),
                 # The gate product alone as one library call
                 # (a yardstick; the port never calls it).
                 timed(lambda: torch.addmm(bias, xin, wg), flush))
    return {"max_abs_err": err, "ms": k["graph_ms"], "ms_is": "graph_ms",
            "plain_ms": p["graph_ms"], "bound_ms": bound, "bound_by": by,
            "library_ms": lib["graph_ms"],
            "library_call": "torch.addmm (gate product only)",
            "kernel": k, "plain": p, "library": lib}


def report_check(name: str, b: int, m: dict, label: str = "") -> None:
    """Print one kernel check; fail if it disagrees with its plain version
    (or, where its gradients were checked, with their plain version's)."""
    extra = "".join(f" {key}={m[key]:.6f}" for key in
                    ("backward_ms", "backward_graph_ms") if key in m)
    grad = (f" grad_rel_err={m['grad_rel_err']:.3e}"
            if "grad_rel_err" in m else "")
    print(f"kernel {name} B={b}{label}: max_abs_err={m['max_abs_err']:.3e}"
          f"{grad} ms={m['ms']:.6f} ({m['ms_is']}) "
          f"plain_ms={m['plain_ms']:.6f} bound_ms={m['bound_ms']:.6f} "
          f"({m['bound_by']}) library_ms={m['library_ms']}{extra}")
    for part in ("kernel", "plain", "library"):
        if part in m:
            print(f"kernel {name} B={b} {part}: " + ", ".join(
                f"{key}={val:.6f}" for key, val in m[part].items()))
    errs = [m["max_abs_err"], m.get("grad_rel_err", 0.0)]
    if not all(e <= TOL for e in errs):
        fail(f"{name} at B={b} disagrees with its plain version: forward "
             f"{errs[0]:.3e}, gradient {errs[1]:.3e}, tolerance {TOL}")


def kernel_checks():
    """Phase 3: K1 and K2 against their plain versions at B in 1, 8, 40.
    -> {kernel: {batch: measurement dict}}.  A kernel's ``ms`` (and its
    plain version's and library call's) is the profiler's device time for
    K1, one launch; for K2, whose gate launch starts under its attention
    launch (programmatic dependent launch), the profiler would count the
    overlap twice, so its ``ms`` is ``graph_ms``."""
    import ctypes

    import torch

    from cst_captioning_tpu_torch.ops import _cuda
    from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2

    clusters = ctypes.c_int(0)
    rc = _cuda.load("decode_cell", "decode_cell_gate_max_clusters")(
        E, H, ctypes.byref(clusters))
    _cuda.check(rc, "decode_cell_gate_max_clusters")
    tiles = k2.gate_geometry(8, E, H)["column_tiles"]
    print(f"K2 gate stage: the card holds {clusters.value} clusters of "
          f"{k2.GATE_CLUSTER} blocks at once; the serving width has "
          f"{tiles} (one wave: {clusters.value >= tiles})")

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator().manual_seed(1234)
    res = {"K1": {}, "K2": {}}
    for b in (1, 8, 40):
        attn = attention_inputs(b, gen)
        res["K1"][b] = check_k1(b, attn, gen, flush)
        res["K2"][b] = check_k2(b, attn, gen, flush)
        for name in ("K1", "K2"):
            report_check(name, b, res[name][b])
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
    prof = device_profile(replay, iters=1)
    print(f"{name}: profiled replay: device time {prof['ms']:.3f} ms "
          f"(summed durations), busy {prof['busy_ms']:.3f} ms (trace "
          f"intervals, overlap {prof['overlap_ms']:.3f} ms counted once) of "
          f"{prof['wall_ms']:.3f} ms wall = busy share "
          f"{prof['busy_ms'] / prof['wall_ms']:.3f}; top kernels (name, ms, "
          "launches): " + "; ".join(f"{k} {ms:.3f} {n:.0f}"
                                    for k, ms, n in prof["top"]))
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


def check_launches(phase: str, kernel: str, launches: int, steps: int,
                   per_step: int) -> None:
    """Fail unless the phase ran decode steps and launched ``kernel``
    exactly ``per_step`` times in each."""
    if steps == 0 or launches != per_step * steps:
        fail(f"{phase}: {kernel} launched {launches} times in {steps} "
             f"decode steps ({per_step} a step expected)")


def check_against_offline(name, served, offline):
    same = sum(served[v] == offline[v] for v in offline)
    print(f"{name}: {same}/{len(offline)} captions equal to the offline "
          f"decode")
    if same != len(offline):
        bad = [v for v in offline if served[v] != offline[v]][:3]
        fail(f"{name}: served captions differ from the offline decode "
             f"for {bad}")


def training_kernel_checks(res) -> None:
    """Phase 7a: K1 at the teacher-forced batch (64 videos x 20 captions
    = 1280 rows), forward and autograd backward, and K2 at the rollout
    batch (1280 sampled + 64 greedy rows), each against its plain version
    within ``TOL``; adds ``res["K1"][1280]`` and ``res["K2"][1344]``.
    Then K1's gradients at B = 64: through the kernel, bit for bit the
    plain backward's on the same inputs and upstream gradients."""
    import torch

    from cst_captioning_tpu_torch.ops import attention_kernel as k1

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator().manual_seed(4321)
    res["K1"][TRAIN_ROWS] = check_k1(
        TRAIN_ROWS, attention_inputs(TRAIN_ROWS, gen), gen, flush,
        backward=True)
    report_check("K1", TRAIN_ROWS, res["K1"][TRAIN_ROWS], " (training rows)")
    res["K2"][ROLLOUT_ROWS] = check_k2(
        ROLLOUT_ROWS, attention_inputs(ROLLOUT_ROWS, gen), gen, flush)
    report_check("K2", ROLLOUT_ROWS, res["K2"][ROLLOUT_ROWS],
                 " (rollout rows)")

    # The kernel route's gradients against the plain backward alone.
    gen = torch.Generator().manual_seed(99)
    q, pm, mem, v = attention_inputs(64, gen)
    g_ctx = torch.randn(64, H, generator=gen).cuda()
    g_w = torch.randn(64, T_MEM, generator=gen).cuda()
    leaves = [t.clone().requires_grad_() for t in (q, pm, mem, v)]
    torch.autograd.backward(list(k1.fused_additive_attention(*leaves)),
                            [g_ctx, g_w])
    plain = k1.additive_attention_backward(q, pm, mem, v, g_ctx, g_w)
    same = all(torch.equal(a.grad, g) for a, g in zip(leaves, plain))
    print(f"K1 gradients at B=64: kernel route bitwise equal to the plain "
          f"backward: {same}")
    if not same:
        fail("K1's gradients through the kernel differ from the plain "
             "backward on the same inputs")


def stage_args(*extra) -> list:
    """Train-CLI arguments of phase 7: full MSR-VTT width, the reference's
    batch (64 videos x 20 captions) and optimiser."""
    return ["--synthetic_videos", "6513", "--synthetic_val_videos", "497",
            "--synthetic_rich_vocab", "8000", "--captions_per_video", "20",
            "--feat_shapes", "28x2048,1x4096", "--synthetic_seed", "0",
            "--max_length", str(MAX_LEN), "--rnn_size", "512",
            "--input_encoding_size", "512", "--att_size", "512",
            "--drop_prob", "0.5", "--pallas_attention", "1",
            "--decode_kernel", "fused", "--batch_size", "64",
            "--seq_per_img", "20", "--optim", "adam",
            "--learning_rate", "2e-4", "--grad_clip", "10",
            "--decode_chunk", str(CHUNK), "--seed", "0", *extra]


def timed_steps(trainer, n: int, check) -> list:
    """``n`` iterations of ``trainer``, each synchronised and timed, with
    the launch counts set to 0 before and checked by ``check(completed,
    launches)`` after each (``completed``: the (step, metrics) pairs the
    iteration completed).  -> [(seconds, completed, launches)]."""
    import torch

    from cst_captioning_tpu_torch.ops import launch_counts, \
        reset_launch_counts

    out = []
    for _ in range(n):
        reset_launch_counts()
        t0 = time.perf_counter()
        done = trainer.iteration()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = launch_counts()
        check(done, launches)
        out.append((sec, done, launches))
    return out


def report_stage(name: str, steps, rows: int) -> float:
    import numpy as np

    secs = np.array([s for s, _, _ in steps])
    med = float(np.median(secs))
    losses = [float(m["loss"]) for _, done, _ in steps for _, m in done]
    print(f"train {name}: {len(steps)} timed steps, median "
          f"{med * 1e3:.3f} ms/step (min {secs.min() * 1e3:.3f}, max "
          f"{secs.max() * 1e3:.3f}) = {rows / med:.1f} captions/s; loss "
          f"first {losses[0]:.6f} last {losses[-1]:.6f}; launches per step "
          f"{steps[-1][2]}")
    if not all(np.isfinite(losses)):
        fail(f"train {name}: loss not finite: {losses}")
    return med


def phase_medians(steps) -> dict:
    """Median milliseconds of each phase over the completed steps."""
    import numpy as np

    from cst_captioning_tpu_torch.training.trainer import phase_ms

    per = {}
    for _, done, _ in steps:
        for _, m in done:
            ms = phase_ms(m)
            for key in ("fetch_wait_s", "reward_s"):
                if key in m:
                    ms[key.replace("_s", "")] = m[key] * 1e3
            for key, val in ms.items():
                per.setdefault(key, []).append(val)
    return {key: float(np.median(v)) for key, v in per.items()}


def device_and_host_scores(cst, host_scorer) -> None:
    """One real rollout of the fused CST trainer (1280 samples and 64
    greedy rows of one batch), and the batch's 1280 reference caption
    rows, which score high, scored on the device against the host
    CIDEr-D (``metrics/ciderd.py``): within 1e-4 relative (1e-6 absolute
    for zero scores)."""
    import numpy as np
    import torch

    from cst_captioning_tpu_torch.ops.device_ciderd import ciderd_scores
    from cst_captioning_tpu_torch.training.steps import rollout

    batch = cst.loader.next_batch()
    vix = torch.from_numpy(batch.video_ix).cuda()
    hyp_vix = torch.repeat_interleave(vix, TRAIN_SEQ)
    sampled, greedy, n_steps = rollout(
        cst.model, cst._feats(batch), MAX_LEN, TRAIN_SEQ, cst.noise,
        greedy_baseline=True, decode_chunk=CHUNK)
    labels = torch.from_numpy(batch.labels).long().cuda()
    corpus, tables = cst.fused["corpus"], cst.fused["tables"]
    row_vids = np.repeat(batch.video_ids, TRAIN_SEQ).tolist()
    for name, rows, dev_vix, vids in (
            ("rollout", torch.cat([sampled, greedy]),
             torch.cat([hyp_vix, vix]), row_vids + list(batch.video_ids)),
            ("reference captions", labels, hyp_vix, row_vids)):
        dev = ciderd_scores(rows, dev_vix, corpus, tables).cpu().numpy()
        rows = rows.cpu().numpy()
        t0 = time.perf_counter()
        host = host_scorer(vids, rows)
        host_s = time.perf_counter() - t0
        err = np.abs(dev - host)
        rel = float((err / np.maximum(np.abs(host), 1e-12))[host != 0].max(
            initial=0.0))
        print(f"train CST reward check, {name}: {len(rows)} captions"
              + (f" ({n_steps} rollout steps)" if name == "rollout" else "")
              + f", on-device CIDEr-D vs the host scorer: max relative "
              f"error {rel:.3e}, max abs {err.max():.3e}; mean "
              f"{dev.mean():.6f} vs {host.mean():.6f}; "
              f"{int((host > 0).sum())} nonzero; host scoring {host_s:.3f} s")
        if not np.all(err <= 1e-4 * np.abs(host) + 1e-6):
            fail(f"on-device CIDEr-D disagrees with the host scorer on the "
                 f"{name}: max relative error {rel:.3e}")
    if len(sampled) + len(greedy) != ROLLOUT_ROWS:
        fail(f"the rollout had {len(sampled) + len(greedy)} rows, "
             f"{ROLLOUT_ROWS} expected")


def nan_guard_check(cst) -> None:
    """One all-NaN feature batch through the guarded fused step: bad_step
    1, every parameter, optimizer tensor and the count bit-identical."""
    import numpy as np
    import torch

    opt = cst.optimizer
    before = ([p.detach().clone() for p in cst.model.parameters()],
              [{k: v.clone() for k, v in st.items()} for st in opt.state],
              opt.count.clone())
    batch = cst.loader.next_batch()
    batch.feats = [np.full_like(f, np.nan) for f in batch.feats]
    (_, m), = cst.rl_iteration(batch)
    torch.cuda.synchronize()
    same = (all(torch.equal(a, p.detach())
                for a, p in zip(before[0], cst.model.parameters()))
            and all(torch.equal(a[k], st[k])
                    for a, st in zip(before[1], opt.state) for k in st)
            and torch.equal(before[2], opt.count))
    print(f"train CST NaN guard: all-NaN features -> bad_step "
          f"{float(m['bad_step'])}, loss {float(m['loss'])}; "
          f"{len(before[0])} parameters, "
          f"{sum(len(st) for st in opt.state)} optimizer tensors and the "
          f"count (={float(opt.count)}) bit-identical: {same}")
    if float(m["bad_step"]) != 1.0 or not same:
        fail("the guarded fused step changed state on an all-NaN batch")


def train_phase():
    """Phase 7: XE -> WXE -> CST at full width through the train CLI's
    parser and ``Trainer``; CST on the fused path (the default), then on
    the host-reward path.  -> {kernel: launches in the phase}."""
    import shutil

    import numpy as np
    import torch

    from cst_captioning_tpu_torch import train
    from cst_captioning_tpu_torch.training import checkpoint
    from cst_captioning_tpu_torch.training.trainer import (Trainer,
                                                           build_splits)

    ckpt_root = os.path.join(HERE, "checkpoints", "chip_smoke")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    t0 = time.perf_counter()
    splits = build_splits(train.parse_args(stage_args(
        "--use_consensus_weights", "1")))
    vocab = splits[0].vocab.size_with_pad
    print(f"train data: {splits[0].num_videos} + {splits[1].num_videos} "
          f"videos, {splits[0].labels.shape[0]} captions, vocabulary "
          f"{vocab} rows, features "
          f"{sum(f.nbytes for f in splits[0].feats) / 1e9:.3f} GB, built "
          f"in {time.perf_counter() - t0:.1f} s (host)")
    if vocab != TRAIN_VOCAB:
        fail(f"the synthetic train split realised {vocab} vocabulary rows, "
             f"the reference's generator {TRAIN_VOCAB}")
    rows = TRAIN_BATCH * TRAIN_SEQ
    total = {"fused_additive_attention": 0, "fused_decode_cell": 0}

    def teacher_forced(done, launches):
        if launches["fused_additive_attention"] != MAX_LEN * len(done):
            fail(f"K1 launched {launches['fused_additive_attention']} times "
                 f"in {len(done)} teacher-forced steps, {MAX_LEN} a step "
                 "expected")

    def add(steps):
        for _, _, launches in steps:
            for key in total:
                total[key] += launches[key]

    def save_best(trainer, stage):
        path = os.path.join(ckpt_root, stage)
        checkpoint.save(path, checkpoint.BEST,
                        trainer.checkpoint_payload(0.0, 0.0))
        return path

    torch.cuda.reset_peak_memory_stats()
    xe = Trainer(train.parse_args(stage_args(
        "--checkpoint_path", os.path.join(ckpt_root, "xe"))), splits)
    add(timed_steps(xe, 2, teacher_forced))
    xe_steps = timed_steps(xe, 10, teacher_forced)
    add(xe_steps)
    report_stage("XE", xe_steps, rows)
    first, last = (float(xe_steps[i][1][0][1]["loss"]) for i in (0, -1))
    if not last < first:
        fail("XE loss of the last timed step is not below the first")
    # Where an XE step's device time goes (two more steps, not counted).
    prof = device_profile(xe.iteration, iters=1)
    print(f"train XE: profiled step: device time {prof['ms']:.3f} ms "
          f"(summed), busy {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} "
          f"ms wall = busy share {prof['busy_ms'] / prof['wall_ms']:.3f}; "
          "top kernels (name, ms, launches): " + "; ".join(
              f"{k} {ms:.3f} {n:.0f}" for k, ms, n in prof["top"]))
    start = save_best(xe, "xe")
    del xe

    wxe = Trainer(train.parse_args(stage_args(
        "--use_consensus_weights", "1", "--learning_rate", "1e-4",
        "--start_from", start,
        "--checkpoint_path", os.path.join(ckpt_root, "wxe"))), splits)
    wxe_steps = timed_steps(wxe, 3, teacher_forced)
    add(wxe_steps)
    report_stage("WXE", wxe_steps, rows)
    start = save_best(wxe, "wxe")
    del wxe

    cst_args = ("--use_rl", "1", "--rl_baseline", "greedy",
                "--learning_rate", "2e-5", "--start_from", start)

    # CST, fused on-device path (--device_rewards 1, the default).
    t0 = time.perf_counter()
    cst = Trainer(train.parse_args(stage_args(
        *cst_args, "--checkpoint_path", os.path.join(ckpt_root, "cst"))),
        splits)
    setup = cst.reward_setup
    print(f"train CST fused: trainer built in {time.perf_counter() - t0:.1f} "
          f"s; reward tables built in {setup['table_build_s']:.3f} s "
          f"(host), {setup['table_bytes'] / 2 ** 20:.1f} MiB on the device "
          f"({setup['ngrams']} distinct n-grams in {setup['slots']} df "
          f"slots, refs x grams {setup['refs_grams']}); "
          f"match envelope {setup['envelope_bytes'] / 2 ** 20:.1f} MiB "
          f"against a budget of {setup['budget_bytes'] / 2 ** 20:.0f} MiB: "
          + ("one shot" if setup["ref_chunk"] is None
             else f"chunked at {setup['ref_chunk']} refs"))
    if cst.reward_computer is not None or cst.pipeline is not None:
        fail("the default CST trainer built a host reward path")

    def fused_step(done, launches):
        teacher_forced(done, launches)
        (_, m), = done
        if launches["fused_decode_cell"] != 2 * float(m["rollout_steps"]):
            fail(f"K2 launched {launches['fused_decode_cell']} times in a "
                 f"rollout of {float(m['rollout_steps'])} steps (2 a step)")
        if not np.isfinite(float(m["reward"])):
            fail(f"CST reward not finite: {float(m['reward'])}")

    before = [p.detach().clone() for p in cst.model.parameters()]
    add(timed_steps(cst, 1, fused_step))
    cst_steps = timed_steps(cst, 3, fused_step)
    add(cst_steps)
    fused_ms = report_stage("CST fused", cst_steps, rows)
    changed = sum(not torch.equal(a, p.detach())
                  for a, p in zip(before, cst.model.parameters()))
    ms = phase_medians(cst_steps)
    print(f"train CST fused phases (median ms, CUDA events): rollout "
          f"{ms['rollout']:.3f} ({ROLLOUT_ROWS} rows, steps "
          f"{[float(m['rollout_steps']) for _, d, _ in cst_steps for _, m in d]}"
          f"), on-device reward {ms['reward']:.3f}, grad {ms['grad']:.3f}; "
          f"step {fused_ms * 1e3:.3f} ms = {rows / fused_ms:.1f} captions/s; "
          f"reward {[round(float(m['reward']), 6) for _, d, _ in cst_steps for _, m in d]}, "
          f"advantage {[round(float(m['advantage']), 6) for _, d, _ in cst_steps for _, m in d]}; "
          f"{changed}/{len(before)} parameter tensors changed")
    if changed == 0:
        fail("CST steps left every parameter unchanged")
    # Where a fused step's device time goes (two more steps, not counted).
    prof = device_profile(cst.iteration, iters=1)
    print(f"train CST fused: profiled step: device time {prof['ms']:.3f} ms "
          f"(summed), busy {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} "
          f"ms wall = busy share {prof['busy_ms'] / prof['wall_ms']:.3f}; "
          "top kernels (name, ms, launches): " + "; ".join(
              f"{k} {ms:.3f} {n:.0f}" for k, ms, n in prof["top"]))
    nan_guard_check(cst)

    from cst_captioning_tpu_torch.ops import launch_counts, \
        reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    scores = cst.validate()
    torch.cuda.synchronize()
    launches = launch_counts()
    total["fused_decode_cell"] += launches["fused_decode_cell"]
    print(f"train validation: {splits[1].num_videos} videos, greedy through "
          f"K2 at B={TRAIN_BATCH}, {time.perf_counter() - t0:.3f} s, "
          f"CIDEr-D {scores['CIDEr']:.6f}; launches {launches}")
    if (launches["fused_decode_cell"] == 0
            or launches["fused_decode_cell"] % 2
            or not np.isfinite(scores["CIDEr"])):
        fail(f"validation: launches {launches}, scores {scores}")

    # CST, host-reward path: --device_rewards 0 through the pipeline at
    # depth 2.  Two pushes fill it, then 1 warm-up and 2 timed steady
    # iterations (each a rollout dispatched and an older step completed),
    # then the drain.
    host = Trainer(train.parse_args(stage_args(
        *cst_args, "--device_rewards", "0", "--overlap_rewards", "2",
        "--checkpoint_path", os.path.join(ckpt_root, "cst_host"))), splits)
    device_and_host_scores(cst, host.reward_computer._score)
    del cst

    def host_step(done, launches):
        teacher_forced(done, launches)
        if launches["fused_decode_cell"] != 2 * host.last_rollout_steps:
            fail(f"host path: K2 launched {launches['fused_decode_cell']} "
                 f"times in a rollout of {host.last_rollout_steps} steps")

    fill = timed_steps(host, 2, host_step)
    if any(done for _, done, _ in fill):
        fail("the depth-2 pipeline completed a step while filling")
    add(fill)
    add(timed_steps(host, 1, host_step))
    host_steps = timed_steps(host, 2, host_step)
    add(host_steps)
    host_ms = report_stage("CST host (depth 2)", host_steps, rows)
    reset_launch_counts()
    t0 = time.perf_counter()
    drained = host.drain()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = launch_counts()
    teacher_forced(drained, launches)
    add([(drain_s, drained, launches)])
    ms = phase_medians(host_steps)
    print(f"train CST host phases (median ms): rollout {ms['rollout']:.3f} "
          f"(CUDA events), fetch wait {ms['fetch_wait']:.3f}, host reward "
          f"{ms['reward']:.3f}, grad {ms['grad']:.3f} (CUDA events); "
          f"iteration {host_ms * 1e3:.3f} ms = {rows / host_ms:.1f} "
          f"captions/s; in flight {[m['overlap_inflight'] for _, d, _ in host_steps for _, m in d]}; "
          f"drain of {len(drained)} steps {drain_s * 1e3:.3f} ms")
    if host.fused is not None or len(drained) != 2:
        fail(f"host path: {len(drained)} steps drained, 2 expected")
    print(f"train peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    del host
    shutil.rmtree(ckpt_root, ignore_errors=True)
    return total


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
    check_launches("greedy-fused", "K2", g_launch["fused_decode_cell"],
                   g_stats["decode_steps"], 2)
    check_against_offline("greedy-fused", greedy_caps,
                          offline_captions(model, vocab, feats_for, 16, 1))

    # Phase 5: beam 5, K2.
    model, vocab, feats_for, beam_caps, b_stats, b_launch, _ = \
        serve_phase("beam5-fused", ["--decode_kernel", "fused",
                                    "--beam_size", "5"], 8)
    check_launches("beam5-fused", "K2", b_launch["fused_decode_cell"],
                   b_stats["decode_steps"], 2)
    check_against_offline("beam5-fused", beam_caps,
                          offline_captions(model, vocab, feats_for, 8, 5))

    # Phase 6: reference cell, attention on K1.
    model, vocab, feats_for, ref_caps, r_stats, r_launch, _ = \
        serve_phase("greedy-reference-k1",
                    ["--decode_kernel", "reference", "--pallas_attention",
                     "1", "--beam_size", "1"], 16)
    check_launches("greedy-reference-k1", "K1",
                   r_launch["fused_additive_attention"],
                   r_stats["decode_steps"], 1)
    check_against_offline("greedy-reference-k1", ref_caps,
                          offline_captions(model, vocab, feats_for, 16, 1))
    agree = sum(ref_caps[v] == greedy_caps[v] for v in greedy_caps)
    print(f"greedy-reference-k1: {agree}/{len(greedy_caps)} captions equal "
          f"to greedy-fused (the two cells differ by float32 rounding)")

    # Phase 7: training, K1 and K2 at the training batches first.
    training_kernel_checks(measured)
    t_launch = train_phase()

    # The kernels line: launches from the serving and training phases;
    # times at B=8, the greedy serving batch (8-slot bucket).
    launches = {"K1": r_launch["fused_additive_attention"]
                + t_launch["fused_additive_attention"],
                "K2": g_launch["fused_decode_cell"]
                + b_launch["fused_decode_cell"]
                + t_launch["fused_decode_cell"]}
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
            "library_ms": m["library_ms"], "batch": 8, "ms_is": m["ms_is"],
            "graph_ms": m["kernel"]["graph_ms"],
            "cold_ms": m["kernel"]["cold_ms"],
            "call_ms": m["kernel"]["call_ms"],
            "host_us": m["kernel"]["host_us"],
            "by_batch": {str(b): measured[key][b] for b in measured[key]}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
