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
   from the previous one's best step.  CST first on the default fused
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
   upstream gradients at B = 64;
8. bfloat16 storage and compute: K1 at B = 1, 8, 40, 1280 (its gradients
   through the autograd Function at 1280 bit for bit the plain
   backward's) and K2 at B = 1, 8, 40, 1344 in bfloat16 storage against
   their plain versions on the card, compared in bfloat16 within one
   bfloat16 ulp of each output's magnitude for K1 and two for K2 (its
   float32 gate sums, in another order than cuBLAS's, flip a rounding
   now and then, and ten roundings follow), both bitwise batch-invariant
   at B = 40, with times next to bounds counted on bfloat16 bytes (K2's
   weight stream 6.3 MB) and the bfloat16 tensor-core rate; greedy
   serving of a bfloat16 model on K2 (``--use_bfloat16 1 --decode_kernel
   fused``) and of the float32 model through the bfloat16 decode variant
   with K1 (``--decode_kernel bf16 --pallas_attention 1``), each against
   its offline decode; then bfloat16 training at full width with
   ``--use_bfloat16 1 --device_feats 1`` on the phase-7 splits: 2 + 5 XE
   steps (K1 bfloat16 forward and backward) and the fused CST step (1 +
   3, K2 bfloat16 at 1344 rows), with ms/step, captions/s, the rollout,
   reward and grad split, a profiled step and peak memory.  Every launch
   of phase 8 must be a bfloat16 one;
9. beam-5 evaluation through ``python -m cst_captioning_tpu_torch.eval``
   of the CST checkpoint phase 7 wrote: K2 at the eval's 320 rows (64
   videos x 5 beams) against its plain version within 1e-5, with times;
   the 497 val videos decoded with ``--decode_kernel fused``, K2 launched
   exactly twice per executed beam step; the seven scores, decode seconds
   and videos/s, and each scorer's host seconds; ``--engine serving``
   equal to the offline decode on every video; and 12 requests through
   ``serve --checkpoint_path`` equal to the eval's predictions;
10. resume on the card: ``python -m cst_captioning_tpu_torch.train`` in
   8 processes at phase 7's width and batch (E = H = A = 512, features
   28 x 2048 + 1 x 4096, 64 x 20 a batch) on a 384-video split of 6
   batches an epoch whose vocabulary (7777 rows) is within 10% of phase
   7's: for float32 XE (K1) and fused CST (K1, K2) an uninterrupted
   twin, a ``--fault_plan preempt@step=N`` run (N mid-epoch; exit 75 and
   its summary line) and its resume (exit 0); then a ``wedge`` drill with
   ``--wedge_timeout`` (exit 124) and its resume.  Each resumed run's
   last checkpoint must be bit-identical to its twin's (parameters,
   Adam's moments and count, generator states, run state) and its
   post-resume train losses equal; each process reports its kernel
   launches in its ``telemetry.json``.  Prints each run's seconds,
   ``preempt_exit_ms``, the checkpoint save and verify milliseconds and
   the phase's total;
11. the bench: first K1 (with its gradients, bit for bit) and K2 in
   bfloat16 storage at the rows the bench's processes run them at that
   phase 8 did not check (K1 at 640, K2 at 4, 5, 20 and 672), against
   their plain versions at phase 8's tolerances; then the native CIDEr-D
   library this process loaded, which must be the build of
   ``native/ciderd.cpp`` by this machine's g++ (its digest covers the
   compiler and the platform), held against the Python scorer on phase
   7's rollout (1344 captions) within rtol 1e-9, each timed; then
   ``python -m cst_captioning_tpu_torch.bench`` as four processes: at its
   defaults (XE and CST, 32 videos x 20 captions, bfloat16; the record
   must say ``cst_scorer`` native and the fused path, every rate finite
   and positive, K1 launched in XE and K1 and K2 in CST), ``--stage
   serving`` greedy (24 requests at 8 Hz, buckets 1,4,8) and at beam 5
   (8 requests), every request answered and K2 launched, and ``--stage
   data --loader_workers 4`` paced at this run's XE step time.  Each
   record is printed as its own line.

Each serving phase sets every kernel's launch count to 0 just before it
and reads the counts just after; a kernel of the path launched other
than its count per decode step (K2 twice, K1 once) fails the run.  The
training phase does the same around each timed step: K1 exactly
``max_length`` launches per teacher-forced forward (one per step the
iteration completed), K2 exactly 2 per executed step of the rollout it
dispatched; the fused path builds no host reward.

Output: phase lines as they run; then a JSON object with one entry per
kernel and storage dtype (``storage``; times at the serving batch B = 8,
every measured batch under ``by_batch``; launches of phases 4-7, 9 and
10 for float32, of phases 8 and 11 for bfloat16); then the card line (``nvidia-smi``
name and power limit); and last ``{"ok": true, "device": ...}``.
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

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, the
# float32 rate outside the tensor cores, and the dense bfloat16 rate of the
# tensor cores (the least time the card could take for bfloat16 work).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
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
# Phase 7 writes each stage's checkpoint here; phase 9 evaluates CST's.
CKPT_ROOT = os.path.join(HERE, "checkpoints", "chip_smoke")
# Phase 9: the beam-5 eval at the eval CLI's default batch of 64 videos.
EVAL_BATCH, EVAL_BEAM = 64, 5
EVAL_ROWS = EVAL_BATCH * EVAL_BEAM


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


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ops_per_s * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def k1_bound(b: int, elem: int = 4):
    """K1's bound with q, proj_mem, memory, ctx and w in ``elem``-byte
    storage (score_v float32)."""
    n_bytes = (elem * (b * A + b * T_MEM * A + b * T_MEM * H + b * H
                       + b * T_MEM) + 4 * A)
    return bound_ms(n_bytes, b * (4 * T_MEM * A + 5 * T_MEM + 2 * T_MEM * H),
                    FP32_OPS_PER_S if elem == 4 else BF16_OPS_PER_S)


def k2_bound(b: int, elem: int = 4):
    """K2's bound with every operand but score_v in ``elem``-byte storage
    (the gate weights 12.6 MB in float32, 6.3 MB in bfloat16)."""
    n_bytes = (elem * (b * (E + 2 * H + A) + b * T_MEM * (A + H)
                       + (E + 2 * H) * 4 * H + 4 * H + 2 * b * H) + 4 * A)
    n_ops = (b * (4 * T_MEM * A + 5 * T_MEM + 2 * T_MEM * H)
             + 2 * b * (E + 2 * H) * 4 * H + 10 * b * H)
    return bound_ms(n_bytes, n_ops,
                    FP32_OPS_PER_S if elem == 4 else BF16_OPS_PER_S)


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

    for elem, dtype in ((4, "float32"), (2, "bfloat16")):
        clusters = ctypes.c_int(0)
        rc = _cuda.load("decode_cell", "decode_cell_gate_max_clusters")(
            E, H, elem, ctypes.byref(clusters))
        _cuda.check(rc, "decode_cell_gate_max_clusters")
        tiles = k2.gate_geometry(8, E, H, elem)["column_tiles"]
        print(f"K2 gate stage ({dtype}): the card holds {clusters.value} "
              f"clusters of {k2.GATE_CLUSTER} blocks at once; the serving "
              f"width has {tiles} (one wave: {clusters.value >= tiles})")
        if clusters.value < tiles:
            fail(f"K2's {dtype} gate clusters do not fit in one wave")

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
    from cst_captioning_tpu_torch.ops import (launch_counts,
                                              launch_counts_by_dtype,
                                              reset_launch_counts)
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
    launches = {**launch_counts(), **launch_counts_by_dtype()}
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

    from cst_captioning_tpu_torch.ops import (launch_counts,
                                              launch_counts_by_dtype,
                                              reset_launch_counts)

    out = []
    for _ in range(n):
        reset_launch_counts()
        t0 = time.perf_counter()
        done = trainer.iteration()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {**launch_counts(), **launch_counts_by_dtype()}
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


def device_and_host_scores(cst, host_scorer):
    """One real rollout of the fused CST trainer (1280 samples and 64
    greedy rows of one batch), and the batch's 1280 reference caption
    rows, which score high, scored on the device against the host
    CIDEr-D (the host path's scorer, the native one): within 1e-4
    relative (1e-6 absolute for zero scores).  -> (the rollout's rows,
    their video ids) for phase 11."""
    import numpy as np
    import torch

    from cst_captioning_tpu_torch.ops.device_ciderd import ciderd_scores
    from cst_captioning_tpu_torch.training.steps import rollout

    batch = cst.next_batch()
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
    rollout_rows = torch.cat([sampled, greedy]).cpu().numpy()
    return rollout_rows, row_vids + list(batch.video_ids)


def nan_guard_check(cst) -> None:
    """One all-NaN feature batch through the guarded fused step: bad_step
    1, every parameter, optimizer tensor and the count bit-identical."""
    import numpy as np
    import torch

    opt = cst.optimizer
    before = ([p.detach().clone() for p in cst.model.parameters()],
              [{k: v.clone() for k, v in st.items()} for st in opt.state],
              opt.count.clone())
    batch = cst.next_batch()
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


def train_splits():
    """The synthetic train (MSR-VTT's 6513 videos x 20 captions, with
    consensus scores) and val splits of phases 7 and 8, built once."""
    from cst_captioning_tpu_torch import train
    from cst_captioning_tpu_torch.training.trainer import build_splits

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
    return splits


def train_phase(splits):
    """Phase 7: XE -> WXE -> CST at full width through the train CLI's
    parser and ``Trainer``; CST on the fused path (the default), then on
    the host-reward path (the native CIDEr-D, ``--native_cider 1``).
    -> ({kernel: launches in the phase}, one rollout's rows with their
    video ids, the tokenized references and the vocabulary, for phase
    11)."""
    import shutil

    import numpy as np
    import torch

    from cst_captioning_tpu_torch import train
    from cst_captioning_tpu_torch.training import checkpoint
    from cst_captioning_tpu_torch.training.trainer import Trainer

    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
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
        path = os.path.join(CKPT_ROOT, stage)
        checkpoint.CheckpointManager(path).save(
            trainer.step, trainer.checkpoint_payload(), score=0.0)
        return path

    torch.cuda.reset_peak_memory_stats()
    xe = Trainer(train.parse_args(stage_args(
        "--checkpoint_path", os.path.join(CKPT_ROOT, "xe"))), splits)
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
        "--checkpoint_path", os.path.join(CKPT_ROOT, "wxe"))), splits)
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
        *cst_args, "--checkpoint_path", os.path.join(CKPT_ROOT, "cst"))),
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
    save_best(cst, "cst")                   # phase 9 evaluates it
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

    from cst_captioning_tpu_torch.ops import (launch_counts,
                                              launch_counts_by_dtype,
                                              reset_launch_counts)

    reset_launch_counts()
    t0 = time.perf_counter()
    scores = cst.validate()
    torch.cuda.synchronize()
    launches = {**launch_counts(), **launch_counts_by_dtype()}
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
        "--checkpoint_path", os.path.join(CKPT_ROOT, "cst_host"))), splits)
    if host.cst_scorer != "native":
        fail(f"the host path scored with the {host.cst_scorer} CIDEr-D; "
             "--native_cider 1 (the default) must build and load the "
             "native one")
    rollout_rows, rollout_vids = device_and_host_scores(
        cst, host.reward_computer._reward)
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
    launches = {**launch_counts(), **launch_counts_by_dtype()}
    teacher_forced(drained, launches)
    add([(drain_s, drained, launches)])
    ms = phase_medians(host_steps)
    print(f"train CST host phases (median ms): rollout {ms['rollout']:.3f} "
          f"(CUDA events), fetch wait {ms['fetch_wait']:.3f}, host reward "
          f"({host.cst_scorer} CIDEr-D) {ms['reward']:.3f}, grad {ms['grad']:.3f} (CUDA events); "
          f"iteration {host_ms * 1e3:.3f} ms = {rows / host_ms:.1f} "
          f"captions/s; in flight {[m['overlap_inflight'] for _, d, _ in host_steps for _, m in d]}; "
          f"drain of {len(drained)} steps {drain_s * 1e3:.3f} ms")
    if host.fused is not None or len(drained) != 2:
        fail(f"host path: {len(drained)} steps drained, 2 expected")
    print(f"train peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    scored = {"rows": rollout_rows, "vids": rollout_vids,
              "refs": host.reward_computer.refs, "vocab": host.vocab}
    del host
    return total, scored


def to_bf16(*tensors) -> tuple:
    import torch

    return tuple(t.to(torch.bfloat16) for t in tensors)


def bf16_ulp(ref) -> float:
    """One bfloat16 ulp at the magnitude of ``ref`` (its largest |value|):
    the tolerance of a bfloat16 kernel against its plain version (float32
    sums in another order before the rounding)."""
    import math

    m = ref.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def bf16_errors(got, want, ulps: int = 1):
    """(max abs error, tolerance, within, share of outputs that differ)
    over output pairs compared in bfloat16: each output within ``ulps``
    ulps of its own magnitude.  K1 rounds once, at the end: one ulp.  K2's
    float32 gate sums run in another order than cuBLAS's, so now and then
    one rounds to the neighbouring bfloat16 value, and its gate chain
    rounds ten times after them: where two such flips meet in one element
    c' or h' moves by up to two ulps of the magnitude."""
    import torch

    errs = [((g.float() - w.float()).abs().max().item(), ulps * bf16_ulp(w))
            for g, w in zip(got, want)]
    differ = sum((g != w).sum().item() for g, w in zip(got, want)) / sum(
        w.numel() for w in want)
    return (max(e for e, _ in errs), max(t for _, t in errs),
            all(g.dtype == w.dtype == torch.bfloat16
                for g, w in zip(got, want))
            and all(e <= t for e, t in errs), differ)


def bf16_batch_invariant(fn, args, per_row: int) -> bool:
    """A row's outputs have the same bits in a batch, alone, and at
    another index of the batch."""
    import torch

    b = args[0].shape[0]
    full = fn(*args)

    def rows(idx):
        return [a[idx].contiguous() if i < per_row else a
                for i, a in enumerate(args)]

    perm = torch.roll(torch.arange(b, device="cuda"), 17)
    same = all(torch.equal(o[perm], m) for o, m in zip(full, fn(*rows(perm))))
    for r in (0, b // 3, b - 1):
        same &= all(torch.equal(o[r:r + 1], a)
                    for o, a in zip(full, fn(*rows(slice(r, r + 1)))))
    return same


def check_k1_bf16(b: int, attn, gen, flush, backward: bool = False) -> dict:
    """K1 in bfloat16 storage (score_v float32) at batch ``b`` against its
    plain version, compared in bfloat16; with ``backward`` its gradients
    through the autograd Function against the plain backward on the same
    inputs and upstream gradients, bit for bit."""
    import torch

    from cst_captioning_tpu_torch.ops import attention_kernel as k1

    q, pm, mem, v = attn
    args = to_bf16(q, pm, mem) + (v,)
    got = k1.fused_additive_attention(*args)
    torch.cuda.synchronize()
    err, tol, ok, differ = bf16_errors(got,
                                       k1.additive_attention_plain(*args))
    bound, by = k1_bound(b, 2)
    k, p = (timed(lambda: k1.fused_additive_attention(*args), flush),
            timed(lambda: k1.additive_attention_plain(*args), flush))
    m = {"max_abs_err": err, "tol": tol, "ok": ok, "differ": differ,
         "ms": k["ms"],
         "ms_is": "profiler", "plain_ms": p["ms"], "bound_ms": bound,
         "bound_by": by, "library_ms": None, "kernel": k, "plain": p}
    if backward:
        g_ctx = torch.randn(b, H, generator=gen).cuda().to(torch.bfloat16)
        g_w = torch.randn(b, T_MEM, generator=gen).cuda().to(torch.bfloat16)
        leaves = [t.clone().requires_grad_() for t in args]
        torch.autograd.backward(list(k1.fused_additive_attention(*leaves)),
                                [g_ctx, g_w])
        want = k1.additive_attention_backward(*args, g_ctx, g_w)
        m["grad_bitwise"] = all(
            a.grad.dtype == a.dtype and torch.equal(a.grad, g)
            for a, g in zip(leaves, want))
        bwd = timed(lambda: k1.additive_attention_backward(
            *args, g_ctx, g_w), flush)
        m.update({"backward_ms": bwd["ms"],
                  "backward_graph_ms": bwd["graph_ms"]})
    return m


def check_k2_bf16(b: int, attn, gen, flush) -> dict:
    """K2 in bfloat16 storage at batch ``b`` (weights and state bfloat16,
    score_v float32) against its plain version, compared in bfloat16;
    times next to its bound and to ``torch.addmm`` of its gate product in
    bfloat16."""
    import torch

    from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2

    q, pm, mem, v = attn
    x = torch.randn(b, E, generator=gen).cuda()
    c = torch.randn(b, H, generator=gen).cuda()
    h = torch.tanh(torch.randn(b, H, generator=gen)).cuda()
    wg = (torch.randn(E + 2 * H, 4 * H, generator=gen)
          / (E + H) ** 0.5).cuda()
    bias = (0.1 * torch.randn(4 * H, generator=gen)).cuda()
    args = to_bf16(x, c, h, q, pm, mem) + (v,) + to_bf16(wg, bias)
    got = k2.fused_decode_cell(*args)
    torch.cuda.synchronize()
    err, tol, ok, differ = bf16_errors(got, k2.decode_cell_plain(*args),
                                       ulps=2)
    bound, by = k2_bound(b, 2)
    xin = torch.cat([args[0], *to_bf16(torch.randn(b, H, device="cuda")),
                     args[2]], dim=-1)
    k, p, lib = (timed(lambda: k2.fused_decode_cell(*args), flush,
                       trace_graph=True),
                 timed(lambda: k2.decode_cell_plain(*args), flush),
                 timed(lambda: torch.addmm(args[8], xin, args[7]), flush))
    return {"max_abs_err": err, "tol": tol, "ok": ok, "differ": differ,
            "ms": k["graph_ms"],
            "ms_is": "graph_ms", "plain_ms": p["graph_ms"],
            "bound_ms": bound, "bound_by": by,
            "library_ms": lib["graph_ms"],
            "library_call": "torch.addmm (bfloat16 gate product only)",
            "kernel": k, "plain": p, "library": lib,
            "batch_invariant": (bf16_batch_invariant(
                k2.fused_decode_cell, args, 6) if b == 40 else None)}


def report_bf16(name: str, b: int, m: dict) -> None:
    """Print one bfloat16 kernel check; fail on any disagreement."""
    extra = "".join(f" {key}={m[key]}" for key in
                    ("grad_bitwise", "batch_invariant", "backward_ms",
                     "backward_graph_ms") if m.get(key) is not None)
    print(f"kernel {name} bfloat16 B={b}: max_abs_err={m['max_abs_err']:.3e}"
          f" (tolerance, in bfloat16 ulps of the output's magnitude: "
          f"{m['tol']:.3e}; outputs that differ: {m['differ']:.3e}) "
          f"ms={m['ms']:.6f} ({m['ms_is']}) plain_ms={m['plain_ms']:.6f} "
          f"bound_ms={m['bound_ms']:.6f} ({m['bound_by']}) "
          f"library_ms={m['library_ms']}{extra}")
    for part in ("kernel", "plain", "library"):
        if part in m:
            print(f"kernel {name} bfloat16 B={b} {part}: " + ", ".join(
                f"{key}={val:.6f}" for key, val in m[part].items()))
    if not m["ok"] or m.get("grad_bitwise") is False \
            or m.get("batch_invariant") is False:
        fail(f"{name} in bfloat16 at B={b} disagrees with its plain version: "
             f"{m['max_abs_err']:.3e} against {m['tol']:.3e}, "
             f"gradients bitwise {m.get('grad_bitwise')}, batch invariant "
             f"{m.get('batch_invariant')}")


def bf16_kernel_checks() -> dict:
    """Phase 8a: K1 at B = 1, 8, 40, 1280 (its gradients at 1280) and K2 at
    B = 1, 8, 40, 1344 in bfloat16 storage against their plain versions;
    both bitwise batch-invariant at B = 40.  -> {kernel: {batch: dict}}."""
    import torch

    from cst_captioning_tpu_torch.ops import attention_kernel as k1

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator().manual_seed(5678)
    res = {"K1": {}, "K2": {}}
    for b1, b2 in ((1, 1), (8, 8), (40, 40), (TRAIN_ROWS, ROLLOUT_ROWS)):
        res["K1"][b1] = check_k1_bf16(b1, attention_inputs(b1, gen), gen,
                                      flush, backward=b1 == TRAIN_ROWS)
        if b1 == 40:
            q, pm, mem, v = attention_inputs(40, gen)
            res["K1"][b1]["batch_invariant"] = bf16_batch_invariant(
                k1.fused_additive_attention,
                to_bf16(q, pm, mem) + (v,), 3)
        report_bf16("K1", b1, res["K1"][b1])
        res["K2"][b2] = check_k2_bf16(b2, attention_inputs(b2, gen), gen,
                                      flush)
        report_bf16("K2", b2, res["K2"][b2])
    return res


def bf16_serve_phases() -> dict:
    """Phase 8b: greedy serving of a bfloat16 model on K2 in bfloat16
    storage (``--use_bfloat16 1 --decode_kernel fused``), then of the
    float32 model through the bfloat16 decode variant with its attention
    on K1 in bfloat16 (``--decode_kernel bf16 --pallas_attention 1``);
    each against the offline greedy decode of the same model and kernel,
    every launch a bfloat16 one.  -> {counter: launches}."""
    total = {}
    for name, args, counter, per_step in (
            ("greedy-fused-bf16", ["--use_bfloat16", "1", "--decode_kernel",
                                   "fused"], "fused_decode_cell", 2),
            ("greedy-bf16-variant-k1", ["--decode_kernel", "bf16",
                                        "--pallas_attention", "1"],
             "fused_additive_attention", 1)):
        model, vocab, feats_for, caps, stats, launches, _ = serve_phase(
            name, args + ["--beam_size", "1"], 16)
        check_launches(name, counter, launches[f"{counter}/bfloat16"],
                       stats["decode_steps"], per_step)
        if launches[f"{counter}/float32"] or launches[counter] != \
                launches[f"{counter}/bfloat16"]:
            fail(f"{name}: float32 launches in a bfloat16 path: {launches}")
        check_against_offline(name, caps, offline_captions(
            model, vocab, feats_for, 16, 1))
        for key, n in launches.items():
            total[key] = total.get(key, 0) + n
    return total


def bf16_train_phase(splits) -> dict:
    """Phase 8c: bfloat16 training at full width (64 x 20, V = 7752) with
    ``--use_bfloat16 1 --device_feats 1`` (the features resident on the
    card in bfloat16): XE (2 warm-up + 5 timed steps) with K1 in bfloat16
    forward and backward, then the fused CST step (1 warm-up + 3 timed)
    with K2 in bfloat16 at 1344 rows.  Parameters and optimizer state stay
    float32, every kernel launch is a bfloat16 one.  -> {counter:
    launches}."""
    import numpy as np
    import torch

    from cst_captioning_tpu_torch import train
    from cst_captioning_tpu_torch.training.trainer import Trainer

    rows = TRAIN_BATCH * TRAIN_SEQ
    total = {}

    def teacher_forced(done, launches):
        n = launches["fused_additive_attention/bfloat16"]
        if n != MAX_LEN * len(done) or launches["fused_additive_attention"] \
                != n or launches["fused_decode_cell/float32"]:
            fail(f"bfloat16 training: launches {launches} in {len(done)} "
                 f"teacher-forced steps ({MAX_LEN} bfloat16 K1 a step)")

    def add(steps):
        for _, _, launches in steps:
            for key, n in launches.items():
                total[key] = total.get(key, 0) + n

    bf16_args = ("--use_bfloat16", "1", "--device_feats", "1")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xe = Trainer(train.parse_args(stage_args(
        *bf16_args, "--checkpoint_path",
        os.path.join(HERE, "checkpoints", "chip_smoke_bf16"))), splits)
    table_gb = sum(t.numel() * t.element_size() for t in xe.feat_tables) / 1e9
    print(f"train bf16: trainer built in {time.perf_counter() - t0:.1f} s; "
          f"compute {xe.model.dtype}, features {xe.feat_dtype} resident on "
          f"the card ({table_gb:.3f} GB); parameters "
          f"{sorted({str(p.dtype) for p in xe.model.parameters()})}")
    if xe.model.dtype != torch.bfloat16 or table_gb > 0.9 or any(
            p.dtype != torch.float32 for p in xe.model.parameters()):
        fail("bfloat16 training: model, parameters or feature table in "
             "the wrong dtype")
    add(timed_steps(xe, 2, teacher_forced))
    xe_steps = timed_steps(xe, 5, teacher_forced)
    add(xe_steps)
    xe_ms = report_stage("XE bf16", xe_steps, rows)
    first, last = (float(xe_steps[i][1][0][1]["loss"]) for i in (0, -1))
    if not last < first:
        fail("bfloat16 XE loss of the last timed step is not below the "
             "first")
    if any(st[k].dtype != torch.float32 for st in xe.optimizer.state
           for k in st):
        fail("bfloat16 training: optimizer state not float32")
    cst = Trainer(train.parse_args(stage_args(
        *bf16_args, "--use_rl", "1", "--rl_baseline", "greedy",
        "--learning_rate", "2e-5", "--checkpoint_path",
        os.path.join(HERE, "checkpoints", "chip_smoke_bf16_cst"))), splits)
    cst.model.load_state_dict(xe.model.state_dict())
    del xe

    def fused_step(done, launches):
        teacher_forced(done, launches)
        (_, m), = done
        if launches["fused_decode_cell/bfloat16"] != \
                2 * float(m["rollout_steps"]):
            fail(f"bfloat16 CST: K2 launched {launches} in a rollout of "
                 f"{float(m['rollout_steps'])} steps (2 bfloat16 a step)")
        if not np.isfinite(float(m["reward"])):
            fail(f"bfloat16 CST reward not finite: {float(m['reward'])}")

    before = [p.detach().clone() for p in cst.model.parameters()]
    add(timed_steps(cst, 1, fused_step))
    cst_steps = timed_steps(cst, 3, fused_step)
    add(cst_steps)
    cst_ms = report_stage("CST fused bf16", cst_steps, rows)
    metrics = [m for _, done, _ in cst_steps for _, m in done]
    changed = sum(not torch.equal(a, p.detach())
                  for a, p in zip(before, cst.model.parameters()))
    ms = phase_medians(cst_steps)
    print(f"train CST fused bf16 phases (median ms, CUDA events): rollout "
          f"{ms['rollout']:.3f} ({ROLLOUT_ROWS} rows, steps "
          f"{[float(m['rollout_steps']) for m in metrics]}"
          f"), on-device reward {ms['reward']:.3f}, grad {ms['grad']:.3f}; "
          f"step {cst_ms * 1e3:.3f} ms = {rows / cst_ms:.1f} captions/s "
          f"(XE {xe_ms * 1e3:.3f} ms = {rows / xe_ms:.1f} captions/s); "
          f"reward {[round(float(m['reward']), 6) for m in metrics]}; "
          f"{changed}/{len(before)} parameter tensors changed")
    if changed == 0:
        fail("bfloat16 CST steps left every parameter unchanged")
    prof = device_profile(cst.iteration, iters=1)
    print(f"train CST fused bf16: profiled step: device time "
          f"{prof['ms']:.3f} ms (summed), busy {prof['busy_ms']:.3f} ms of "
          f"{prof['wall_ms']:.3f} ms wall = busy share "
          f"{prof['busy_ms'] / prof['wall_ms']:.3f}; top kernels (name, ms, "
          "launches): " + "; ".join(f"{k} {ms_:.3f} {n:.0f}"
                                    for k, ms_, n in prof["top"]))
    print(f"train bf16 peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    del cst
    return total


def eval_phase(splits, res) -> int:
    """Phase 9: the beam-5 evaluation of phase 7's CST checkpoint (WXE's
    if CST wrote none) through ``python -m cst_captioning_tpu_torch.eval``
    at full width: K2 at the eval's 320 rows against its plain version
    (adds ``res["K2"][320]``); the offline decode of the 497 val videos
    (``--decode_kernel fused --eval_batch_size 64``) with K2 launched
    exactly twice per executed beam step; the seven scores, decode seconds
    and the host seconds of each scorer; ``--engine serving`` through the
    CLI's ``main`` (it raises unless every caption equals the offline
    decode's, and its result file must hold the same captions); and a
    few requests through ``serve.build_backend`` with
    ``--checkpoint_path``, equal to the eval's predictions.  -> K2's
    launches in the offline decode."""
    import shutil

    import torch

    from cst_captioning_tpu_torch import eval as port_eval
    from cst_captioning_tpu_torch import serve
    from cst_captioning_tpu_torch.metrics.coco_eval import language_eval
    from cst_captioning_tpu_torch.ops import (launch_counts,
                                              launch_counts_by_dtype,
                                              reset_launch_counts)
    from cst_captioning_tpu_torch.serving.buckets import parse_buckets
    from cst_captioning_tpu_torch.serving.engine import ServingEngine
    from cst_captioning_tpu_torch.serving.server import CaptionServer
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator().manual_seed(2468)
    res["K2"][EVAL_ROWS] = check_k2(
        EVAL_ROWS, attention_inputs(EVAL_ROWS, gen), gen, flush)
    report_check("K2", EVAL_ROWS, res["K2"][EVAL_ROWS],
                 " (beam-5 eval rows)")
    del flush

    stage = next((s for s in ("cst", "wxe") if os.path.exists(
        os.path.join(CKPT_ROOT, s, "infos.json"))), None)
    if stage is None:
        fail("phase 9: phase 7 wrote no CST or WXE checkpoint")
    ck = os.path.join(CKPT_ROOT, stage)
    argv = ["--checkpoint_path", ck, "--beam_size", str(EVAL_BEAM),
            "--eval_batch_size", str(EVAL_BATCH), "--max_length",
            str(MAX_LEN), "--decode_chunk", str(CHUNK), "--decode_kernel",
            "fused"]

    # The offline beam decode, launches counted around it alone.
    args = port_eval.parse_args(argv)
    t0 = time.perf_counter()
    reset_launch_counts()
    out = port_eval.evaluate(args)
    torch.cuda.synchronize()
    launches = {**launch_counts(), **launch_counts_by_dtype()}
    total_s = time.perf_counter() - t0
    scores, preds = out["scores"], out["predictions"]
    n = len(preds)
    print(f"eval {stage} beam {EVAL_BEAM}: {n} videos, K2 at "
          f"{EVAL_ROWS} rows; decode {out['decode_s']:.3f} s = "
          f"{n / out['decode_s']:.1f} videos/s ({out['decode_steps']} beam "
          f"steps); scoring {out['score_s']:.3f} s (host); whole call "
          f"{total_s:.3f} s (the data rebuilt from the checkpoint's spec "
          f"included); launches {launches}")
    print(f"eval {stage} scores: " + ", ".join(
        f"{k} {v:.6f}" for k, v in scores.items()))
    if n != splits[1].num_videos:
        fail(f"phase 9: {n} predictions for {splits[1].num_videos} videos")
    check_launches(f"eval {stage}", "K2", launches["fused_decode_cell"],
                   out["decode_steps"], 2)
    if launches["fused_additive_attention"] or launches[
            "fused_decode_cell/bfloat16"]:
        fail(f"phase 9: launches other than float32 K2: {launches}")
    if sorted(scores) != sorted(["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                                 "METEOR_approx", "ROUGE_L", "CIDEr"]) \
            or not all(0.0 <= v < 20.0 for v in scores.values()):
        fail(f"phase 9: scores {scores}")
    refs = splits[1].refs
    per = {}
    for scorer in ("Bleu", "METEOR", "ROUGE_L", "CIDEr"):
        t0 = time.perf_counter()
        part = language_eval(preds, refs, scorers=(scorer,))
        per[scorer] = time.perf_counter() - t0
        if any(part[k] != scores[k] for k in part):
            fail(f"phase 9: {scorer} alone gives {part}, the suite {scores}")
    print("eval scorers, host seconds each (tokenisation included): "
          + ", ".join(f"{k} {v:.3f}" for k, v in per.items()))

    # --engine serving through the CLI's main.
    result = os.path.join(ck, "eval_serving.json")
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = port_eval.main(argv + ["--engine", "serving",
                                    "--result_file", result])
    except RuntimeError as e:
        fail(f"phase 9: {e}")
    torch.cuda.synchronize()
    engine_launch = {**launch_counts(), **launch_counts_by_dtype()}
    with open(result) as f:
        served = json.load(f)
    same = sum(a == b for a, b in zip(served["predictions"], preds))
    print(f"eval --engine serving: rc {rc}, {same}/{n} captions equal to "
          f"the offline decode, {time.perf_counter() - t0:.3f} s; launches "
          f"{engine_launch}")
    if rc != 0 or same != n or len(served["predictions"]) != n:
        fail("phase 9: the serving engine's captions differ from the "
             "offline decode")
    if (engine_launch["fused_decode_cell"] == 0
            or engine_launch["fused_decode_cell"] % 2):
        fail(f"phase 9: serving engine launches {engine_launch}")

    # serve --checkpoint_path: a few requests.
    opt = serve.parse_args(["--checkpoint_path", ck, "--beam_size",
                            str(EVAL_BEAM), "--decode_kernel", "fused",
                            "--max_length", str(MAX_LEN),
                            "--decode_chunk", str(CHUNK)])
    model, vocab, feat_shapes, feats_for = serve.build_backend(opt)
    engine = ServingEngine(
        model, feat_shapes, max_len=opt.max_length, beam_size=opt.beam_size,
        decode_chunk=opt.decode_chunk,
        bucket_sizes=parse_buckets(opt.serve_buckets),
        queue_limit=opt.serve_queue_limit)
    want = {p["image_id"]: p["caption"] for p in preds[:12]}
    lines = [json.dumps({"id": i, "video_id": v}) + "\n"
             for i, v in enumerate(want)]
    sink = io.StringIO()
    reset_launch_counts()
    rc = CaptionServer(engine, vocab, feats_for, out=sink).run_stdin(
        lines=lines)
    torch.cuda.synchronize()
    launches_now = {**launch_counts(), **launch_counts_by_dtype()}
    got = {r["video_id"]: r.get("caption") for r in
           map(json.loads, sink.getvalue().splitlines())}
    stats = engine.stats()
    same = sum(got.get(v) == c for v, c in want.items())
    print(f"serve --checkpoint_path: {len(want)} requests, {same} captions "
          f"equal to the eval's; max_length {opt.max_length}; "
          f"decode_steps {stats['decode_steps']}; launches {launches_now}")
    if rc != 0 or same != len(want):
        fail("phase 9: served captions differ from the eval's predictions")
    check_launches("serve --checkpoint_path", "K2",
                   launches_now["fused_decode_cell"], stats["decode_steps"],
                   2)
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    return launches["fused_decode_cell"]


# Phase 10: a training split of 6 batches of 64 x 20 an epoch.  The
# synthetic generator draws at most 4 + 2 adjectives per 5 captions of a
# video, so 384 videos need 50 captions each (rich vocabulary 100000) to
# realise a vocabulary within 10% of phase 7's (7752 rows).
RESUME_ROOT = os.path.join(HERE, "checkpoints", "chip_smoke_resume")
RESUME_VIDEOS, RESUME_CAPTIONS, RESUME_RICH = 384, 50, 100000
RESUME_BPE = RESUME_VIDEOS // TRAIN_BATCH
RESUME_WEDGE_TIMEOUT = 8.0


def resume_args(*extra) -> list:
    """Train-CLI arguments of phase 10: phase 7's width, batch and
    kernels (``stage_args``) on the phase-10 split, one epoch, a train
    record every step and validation on CIDEr-D alone."""
    return stage_args(
        "--synthetic_videos", str(RESUME_VIDEOS), "--synthetic_val_videos",
        "64", "--synthetic_rich_vocab", str(RESUME_RICH),
        "--captions_per_video", str(RESUME_CAPTIONS), "--max_epochs", "1",
        "--max_patience", "0", "--log_every", "1", "--fast_val", "1",
        *extra)


def run_train(name: str, argv, expect: int):
    """One ``python -m cst_captioning_tpu_torch.train`` process; fails
    unless it exits ``expect``.  -> (the process, its seconds)."""
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("CST_FAULT_PLAN", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cst_captioning_tpu_torch.train", *argv],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    if proc.returncode != expect:
        print(proc.stderr[-6000:], file=sys.stderr)
        fail(f"phase 10 {name}: exit {proc.returncode}, {expect} expected")
    return proc, secs


def telemetry(ck: str) -> dict:
    with open(os.path.join(ck, "telemetry.json")) as f:
        return json.load(f)


def check_resume_launches(name: str, tel: dict, steps: int,
                          rollouts: bool, validated: bool) -> dict:
    """The launches a phase-10 process reported in its ``telemetry.json``
    (counted by the wrappers in that process, from 0): K1 ``MAX_LEN``
    times per teacher-forced step it trained, K2 an even count when it
    ran rollouts or validation, nothing in bfloat16.  -> {kernel:
    launches}."""
    g = tel["gauges"]
    k1 = g["launches/fused_additive_attention/float32"]
    k2 = g["launches/fused_decode_cell/float32"]
    bf16 = (g["launches/fused_additive_attention/bfloat16"]
            + g["launches/fused_decode_cell/bfloat16"])
    if (k1 != MAX_LEN * steps or bf16 or k2 % 2
            or (k2 > 0) != (rollouts or validated)):
        fail(f"phase 10 {name}: launches K1 {k1} in {steps} steps "
             f"({MAX_LEN} a step), K2 {k2}, bfloat16 {bf16}")
    return {"fused_additive_attention": k1, "fused_decode_cell": k2}


def same_state(a_dir: str, b_dir: str, step: int):
    """Step ``step`` of two stage directories: (every tensor and the run
    state bit-identical, the number of tensors compared)."""
    import torch

    from cst_captioning_tpu_torch.training.checkpoint import \
        CheckpointManager

    a = CheckpointManager(a_dir, readonly=True).load(step=step)
    b = CheckpointManager(b_dir, readonly=True).load(step=step)
    pairs = [(a["model"][k], b["model"][k]) for k in a["model"]]
    pairs.append((a["optimizer"]["count"], b["optimizer"]["count"]))
    pairs += [(x[k], y[k]) for x, y in zip(a["optimizer"]["state"],
                                          b["optimizer"]["state"],
                                          strict=True) for k in x]
    pairs += [(a["rng"][k], b["rng"][k]) for k in ("dropout", "noise")]
    same = (a["step"] == b["step"] == step and a["run"] == b["run"]
            and all(torch.equal(x, y) for x, y in pairs))
    return same, len(pairs)


def train_losses(ck: str) -> dict:
    with open(os.path.join(ck, "metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)
                if r["scope"] == "train"}


def resume_phase() -> dict:
    """Phase 10: resume on the card through ``python -m
    cst_captioning_tpu_torch.train`` at phase 7's width (E = H = A = 512,
    features 28 x 2048 + 1 x 4096, 64 x 20 a batch, the phase-10 split of
    6 batches an epoch).  For float32 XE (K1) and for fused CST (K1 and
    K2, the greedy baseline, from the XE twin's checkpoint): the
    uninterrupted twin, a ``--fault_plan preempt@step=N`` run (N mid-
    epoch; exit 75 with the summary line) and its resume (exit 0); then a
    ``wedge`` drill on XE with ``--wedge_timeout`` (exit 124) and its
    resume.  Every resumed run's last checkpoint must be bit-identical to
    its twin's (parameters, optimizer moments and count, generator
    states, run state), and its post-resume train losses equal.  Prints
    each run's seconds, the time from the signal to the exit
    (``preempt_exit_ms``), the checkpoint save and verify milliseconds
    and the phase's total.  -> {kernel: float32 launches in the phase}."""
    import shutil

    import numpy as np

    from cst_captioning_tpu_torch import train
    from cst_captioning_tpu_torch.training.trainer import build_splits

    t_phase = time.perf_counter()
    shutil.rmtree(RESUME_ROOT, ignore_errors=True)
    splits = build_splits(train.parse_args(resume_args()),
                          train_features=False)
    vocab = splits[0].vocab.size_with_pad
    print(f"resume data: {splits[0].num_videos} + {splits[1].num_videos} "
          f"videos x {RESUME_CAPTIONS} captions, {RESUME_BPE} batches of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} an epoch, vocabulary {vocab} rows "
          f"(--synthetic_rich_vocab {RESUME_RICH}; phase 7: {TRAIN_VOCAB})")
    if abs(vocab - TRAIN_VOCAB) > 0.1 * TRAIN_VOCAB:
        fail(f"phase 10: vocabulary {vocab} rows, not within 10% of "
             f"{TRAIN_VOCAB}")
    del splits
    total = {"fused_additive_attention": 0, "fused_decode_cell": 0}
    hists, last = {"ckpt_save_ms": [], "ckpt_verify_ms": []}, RESUME_BPE

    def account(name, ck, steps, rollouts, validated):
        tel = telemetry(ck)
        for key, n in check_resume_launches(name, tel, steps, rollouts,
                                            validated).items():
            total[key] += n
        for key, out in hists.items():
            if key in tel["histograms"]:
                out.append(tel["histograms"][key])
        return tel

    def drill(name, args, fault, at, rollouts, twin=None):
        ck = os.path.join(RESUME_ROOT, name)
        twin_ck = twin or os.path.join(RESUME_ROOT, f"{name}_twin")
        if twin is None:
            _, secs = run_train(f"{name} twin", resume_args(
                *args, "--checkpoint_path", twin_ck), 0)
            account(f"{name} twin", twin_ck, last, rollouts, True)
            print(f"resume {name}: uninterrupted twin {secs:.1f} s")
        argv = resume_args(*args, "--checkpoint_path", ck, "--fault_plan",
                           f"{fault}@step={at}", *(
                               ("--wedge_timeout", str(RESUME_WEDGE_TIMEOUT),
                                "--save_every_steps", "1")
                               if fault == "wedge" else ()))
        if fault == "preempt":
            proc, secs = run_train(f"{name} preempt", argv, 75)
            summary = json.loads(proc.stdout.strip().splitlines()[-1])
            if summary != {"preempted": "SIGTERM", "step": at + 1,
                           "saved": True, "checkpoint_path": ck}:
                fail(f"phase 10 {name}: summary line {summary}")
            tel = account(f"{name} preempt", ck, at + 1, rollouts, False)
            print(f"resume {name}: preempt@step={at} exited 75 in "
                  f"{secs:.1f} s, {summary}; preempt_exit_ms "
                  f"{tel['gauges']['preempt_exit_ms']:.3f}; save "
                  f"{tel['histograms']['ckpt_save_ms']['mean']:.1f} ms, "
                  f"verify {tel['histograms']['ckpt_verify_ms']['mean']:.1f}"
                  f" ms (state.pt "
                  f"{os.path.getsize(os.path.join(ck, 'recovery', str(at + 1), 'state.pt')) / 2 ** 20:.1f} MiB)")
        else:
            proc, secs = run_train(f"{name} wedge", argv, 124)
            if "WATCHDOG: no progress" not in proc.stderr:
                fail(f"phase 10 {name}: exit 124 without the watchdog")
            print(f"resume {name}: wedge@step={at} with --wedge_timeout "
                  f"{RESUME_WEDGE_TIMEOUT:g} exited 124 in {secs:.1f} s")
        start = at + 1 if fault == "preempt" else at
        proc, secs = run_train(f"{name} resume", argv, 0)
        if f"resumed from step {start}" not in proc.stderr:
            fail(f"phase 10 {name}: the rerun did not resume from step "
                 f"{start}")
        tel = account(f"{name} resume", ck, last - start, rollouts, True)
        same, n = same_state(ck, twin_ck, last)
        mine, theirs = train_losses(ck), train_losses(twin_ck)
        losses_same = all(mine[s] == theirs[s]
                          for s in range(start + 1, last + 1))
        print(f"resume {name}: rerun resumed from step {start} and ran to "
              f"{last} in {secs:.1f} s (restore verify "
              f"{tel['histograms']['ckpt_verify_ms']['mean']:.1f} ms); step "
              f"{last} bit-identical to the twin on {n} tensors and the run "
              f"state: {same}; train losses of steps {start + 1}-{last} "
              f"equal: {losses_same} (last {mine[last]:.6f})")
        if not (same and losses_same):
            fail(f"phase 10 {name}: the resumed run differs from its "
                 "uninterrupted twin")
        if not np.isfinite(mine[last]):
            fail(f"phase 10 {name}: loss not finite")
        return twin_ck

    xe_twin = drill("xe", (), "preempt", 1, rollouts=False)
    drill("cst", ("--use_rl", "1", "--rl_baseline", "greedy",
                  "--learning_rate", "2e-5", "--start_from", xe_twin),
          "preempt", 2, rollouts=True)
    drill("xe_wedge", (), "wedge", 3, rollouts=False, twin=xe_twin)
    summary = {}
    for key, hs in hists.items():
        n = sum(h["count"] for h in hs)
        summary[key] = (n, sum(h["sum"] for h in hs) / n,
                        max(h["max"] for h in hs))
    print("resume checkpoints: " + "; ".join(
        f"{key} mean {mean:.1f} max {top:.1f} over {n}"
        for key, (n, mean, top) in summary.items())
        + f"; launches {total}")
    print(f"resume phase: {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(RESUME_ROOT, ignore_errors=True)
    return total


# Phase 11: the port's bench at its defaults (32 videos x 20 captions,
# bfloat16, K1 and K2), its serving stage (greedy and beam 5) and its data
# stage with 4 prefetch workers, each one ``python -m
# cst_captioning_tpu_torch.bench`` process.
BENCH_KERNELS = ("fused_additive_attention", "fused_decode_cell")
# The rows each kernel runs at there: K1 at the bench's 32 x 20 captions
# (XE and the CST gradient), K2 at its rollout's 32 x 20 + 32 greedy rows
# and at the serving stage's buckets (1, 4, 8) times the beam (1, 5).
BENCH_BATCH, BENCH_SEQ, BENCH_BUCKETS, BENCH_BEAM = 32, 20, (1, 4, 8), 5
BENCH_K1_ROWS = (BENCH_BATCH * BENCH_SEQ,)
BENCH_K2_ROWS = tuple(sorted(
    {BENCH_BATCH * (BENCH_SEQ + 1)}
    | {b * k for b in BENCH_BUCKETS for k in (1, BENCH_BEAM)}))


def bench_kernel_checks(bf16_measured) -> None:
    """Phase 11a: K1 and K2 in bfloat16 storage at every row count of the
    bench's processes that phase 8 has not checked (K1 with its
    gradients), against their plain versions at phase 8's tolerances (one
    and two bfloat16 ulps); added to ``bf16_measured``."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator().manual_seed(6789)
    for key, rows, check in (("K1", BENCH_K1_ROWS, check_k1_bf16),
                             ("K2", BENCH_K2_ROWS, check_k2_bf16)):
        for b in rows:
            if b in bf16_measured[key]:
                continue
            kw = {"backward": True} if key == "K1" else {}
            bf16_measured[key][b] = check(b, attention_inputs(b, gen), gen,
                                          flush, **kw)
            report_bf16(key, b, bf16_measured[key][b])
    del flush


def native_scorer_check(scored) -> None:
    """The native libraries this process loaded (phase 7's host path
    loaded the CIDEr-D one): each must be the build of the checkout's
    source by this machine's g++ (the path ``library_path`` gives); then
    the host path's scorer against the Python scorer on phase 7's rollout
    (1280 samples and 64 greedy rows) through ``RewardComputer._reward``:
    within rtol 1e-9, with each scorer's host seconds."""
    from pathlib import Path

    import numpy as np

    from cst_captioning_tpu_torch import native
    from cst_captioning_tpu_torch.metrics.ciderd import (CiderD,
                                                         build_corpus_df)
    from cst_captioning_tpu_torch.training.rewards import RewardComputer

    print(f"native: toolchain {native.toolchain_id()}")
    for src, load in ((native.CIDERD_SRC, native.load_library),
                      (native.TOKENIZER_SRC, native.load_tokenizer_library)):
        loaded, want = Path(load()._name), native.library_path(src)
        built = native.BUILD_SECONDS.get(src.stem)
        print(f"native: {src.name} loaded from {os.path.relpath(loaded, HERE)}"
              + (f", built by g++ in this run in {built:.2f} s"
                 if built is not None else ", found built"))
        if loaded != want:
            fail(f"native: loaded {loaded}, the build of {src.name} by "
                 f"this machine's g++ is {want}")
    refs, vocab = scored["refs"], scored["vocab"]
    t0 = time.perf_counter()
    nat = RewardComputer(vocab, native.NativeCiderD(refs, vocab.word_to_ix),
                         refs, seq_per_img=TRAIN_SEQ)
    nat_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    df, ndocs = build_corpus_df(refs)
    py = RewardComputer(vocab, CiderD(df_mode="corpus", df=df,
                                      ref_len=float(ndocs)),
                        refs, seq_per_img=TRAIN_SEQ)
    py_setup = time.perf_counter() - t0
    times = {}
    out = {}
    for name, rc in (("native", nat), ("python", py)):
        t0 = time.perf_counter()
        out[name] = rc._reward(scored["vids"], scored["rows"])
        times[name] = time.perf_counter() - t0
    err = np.abs(out["native"] - out["python"])
    ok = np.allclose(out["native"], out["python"], rtol=1e-9, atol=1e-12)
    print(f"native CIDEr-D vs Python on phase 7's rollout "
          f"({len(scored['rows'])} captions): max abs error {err.max():.3e}, "
          f"mean {out['native'].mean():.6f}; scoring native "
          f"{times['native'] * 1e3:.3f} ms, Python "
          f"{times['python'] * 1e3:.3f} ms "
          f"({times['python'] / times['native']:.1f}x); set-up native "
          f"{nat_setup:.2f} s, Python {py_setup:.2f} s "
          f"({len(refs)} videos)")
    if not ok:
        fail("the native CIDEr-D disagrees with the Python scorer beyond "
             "rtol 1e-9")


def run_bench(name: str, *argv) -> dict:
    """One bench process; fails unless it exits 0 with one JSON line.
    Prints that line.  -> the record."""
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cst_captioning_tpu_torch.bench", *argv],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=400)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        print(proc.stderr[-6000:], file=sys.stderr)
        fail(f"phase 11 bench {name}: exit {proc.returncode}, "
             f"{len(lines)} lines of output")
    print(f"bench {name}: {secs:.1f} s")
    print(lines[0])
    return json.loads(lines[0])


def check_rates(name: str, rec: dict, keys) -> None:
    import math

    for key in keys:
        v = rec.get(key)
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
            fail(f"phase 11 bench {name}: {key} = {v!r}")


def bench_phase(scored, bf16_measured) -> dict:
    """Phase 11.  -> {kernel: bfloat16 launches in the bench processes}
    (the bench's default ``--bfloat16 1``)."""
    import torch

    t_phase = time.perf_counter()
    bench_kernel_checks(bf16_measured)
    native_scorer_check(scored)
    kind = torch.cuda.get_device_name(0)
    total = dict.fromkeys(BENCH_KERNELS, 0)

    both = run_bench("both")
    check_rates("both", both, (
        "value", "xe_captions_per_sec", "cst_captions_per_sec",
        "cst_host_pipeline_captions_per_sec", "cst_serial_captions_per_sec",
        "cst_fused_captions_per_sec", "xe_achieved_tflops",
        "cst_achieved_tflops"))
    if (both["cst_scorer"] != "native" or both["cst_path"] != "device_fused"
            or both["device"] != kind or both["platform"] != "cuda"):
        fail(f"phase 11 bench both: scorer {both['cst_scorer']}, path "
             f"{both['cst_path']}, device {both['device']}")
    for stage in ("xe", "cst"):
        got = both[f"{stage}_launches"]
        if not all(got[k] > 0 for k in
                   (BENCH_KERNELS if stage == "cst"
                    else BENCH_KERNELS[:1])):
            fail(f"phase 11 bench both: {stage} launches {got}")
        for k in BENCH_KERNELS:
            total[k] += got[k]

    cfg = both["config"]
    if (cfg["batch_size"], cfg["seq_per_img"]) != (BENCH_BATCH, BENCH_SEQ):
        fail(f"phase 11 bench both: {cfg['batch_size']} x "
             f"{cfg['seq_per_img']}, the kernels were checked at "
             f"{BENCH_BATCH} x {BENCH_SEQ}")

    buckets = ",".join(map(str, BENCH_BUCKETS))
    for name, argv, n in (
            ("serving greedy", ["--serve_requests", "24", "--serve_rate",
                                "8", "--serve_buckets", buckets], 24),
            ("serving beam 5", ["--serve_beam", str(BENCH_BEAM),
                                "--serve_requests", "8", "--serve_buckets",
                                buckets], 8)):
        rec = run_bench(name, "--stage", "serving", *argv)
        check_rates(name, rec, ("value", "latency_p50_ms",
                                "latency_p99_ms"))
        if (rec["completed"] != n or rec["answered"] != n
                or rec["launches"]["fused_decode_cell"] == 0):
            fail(f"phase 11 bench {name}: {rec['completed']} of {n} "
                 f"answered, launches {rec['launches']}")
        for k in BENCH_KERNELS:
            total[k] += rec["launches"][k]

    # The paced phase at the step time of this run's XE rate.
    consumer_ms = (cfg["batch_size"] * cfg["seq_per_img"]
                   / both["xe_captions_per_sec"] * 1e3)
    data = run_bench("data", "--stage", "data", "--loader_workers", "4",
                     "--data_consumer_ms", f"{consumer_ms:.3f}")
    check_rates("data", data, ("value", "single_worker_captions_per_sec",
                               "workers_speedup"))
    if data["retries"] != 0 or data["data_wait_share"] is None:
        fail(f"phase 11 bench data: {data}")
    print(f"bench phase: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{total}")
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
    free, total = torch.cuda.mem_get_info()
    print(f"device memory: {free / 2 ** 30:.2f} GiB free of "
          f"{total / 2 ** 30:.2f} GiB at start")

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
    model, vocab, feats_for, beam_caps, b_stats, beam_launch, _ = \
        serve_phase("beam5-fused", ["--decode_kernel", "fused",
                                    "--beam_size", "5"], 8)
    check_launches("beam5-fused", "K2", beam_launch["fused_decode_cell"],
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
    splits = train_splits()
    training_kernel_checks(measured)
    t_launch, scored = train_phase(splits)

    # Phase 8: bfloat16 storage and compute.
    bf16_measured = bf16_kernel_checks()
    s_launch = bf16_serve_phases()
    bt_launch = bf16_train_phase(splits)

    # Phase 9: beam-5 evaluation of phase 7's checkpoint, K2 at 320 rows.
    e_launch = eval_phase(splits, measured)
    del splits

    # Phase 10: preemption, the wedge watchdog and resume through the
    # train CLI, each resumed run bit-identical to its twin.
    resume_launch = resume_phase()

    # Phase 11: the port's bench, its serving and data stages.
    bench_launch = bench_phase(scored, bf16_measured)
    del scored

    # The kernels line: one entry per kernel and storage dtype.  Launches:
    # float32 from phases 4-7, 9 and 10, bfloat16 from phases 8 and 11;
    # times at B=8, the
    # greedy serving batch (8-slot bucket), every measured batch under
    # ``by_batch``.
    launches = {
        ("K1", "float32"): r_launch["fused_additive_attention"]
        + t_launch["fused_additive_attention"]
        + resume_launch["fused_additive_attention"],
        ("K2", "float32"): g_launch["fused_decode_cell"]
        + beam_launch["fused_decode_cell"]
        + t_launch["fused_decode_cell"] + e_launch
        + resume_launch["fused_decode_cell"],
        ("K1", "bfloat16"): s_launch["fused_additive_attention/bfloat16"]
        + bt_launch["fused_additive_attention/bfloat16"]
        + bench_launch["fused_additive_attention"],
        ("K2", "bfloat16"): s_launch["fused_decode_cell/bfloat16"]
        + bt_launch["fused_decode_cell/bfloat16"]
        + bench_launch["fused_decode_cell"],
    }
    meta = {
        "K1": ("fused_additive_attention", "cst_captioning_tpu_torch/csrc/"
               "attention.cu", "cst_captioning_tpu/ops/pallas_attention.py:86"),
        "K2": ("fused_decode_cell", "cst_captioning_tpu_torch/csrc/"
               "decode_cell.cu",
               "cst_captioning_tpu/ops/pallas_decode_cell.py:139"),
    }
    kernels = []
    for (key, dtype), n in launches.items():
        name, source, replaces = meta[key]
        res = measured if dtype == "float32" else bf16_measured
        m = res[key][8]
        kernels.append({
            "name": name if dtype == "float32" else f"{name}_bf16",
            "route": "cuda", "source": source, "replaces": replaces,
            "storage": dtype, "launches": n,
            "max_abs_err": max(res[key][b]["max_abs_err"] for b in res[key]),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "batch": 8, "ms_is": m["ms_is"],
            "graph_ms": m["kernel"]["graph_ms"],
            "cold_ms": m["kernel"]["cold_ms"],
            "call_ms": m["kernel"]["call_ms"],
            "host_us": m["kernel"]["host_us"],
            "by_batch": {str(b): res[key][b] for b in res[key]}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
