#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit); the port's lint,
   ``python -m cst_captioning_tpu_torch.lint --json``, under this
   machine's Python, beside the build: one ``lint`` line (files, rules,
   suppressions, violations, its seconds and those the run waited for it
   after the build), and any violation fails the run;
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
   ``--wedge_timeout`` (exit 124) and its resume.  Runs that do not wait
   on each other share the card, in four waves.  Each resumed run's
   last checkpoint must be bit-identical to its twin's (parameters,
   Adam's moments and count, generator states, run state) and its
   post-resume train losses equal; each process reports its kernel
   launches in its ``telemetry.json``.  Prints each run's seconds,
   ``preempt_exit_ms``, the checkpoint save and verify milliseconds
   (taken beside the wave's other runs) and the phase's total;
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
   record is printed as its own line;
12. files: phase 7's splits written as the port's split files
   (``synthetic.write_split``: ``.npy`` features, the label ``.npz``, the
   json files and the df and consensus pickles of the port's prepro;
   seconds and bytes printed); XE at 64 x 20 with K1 through ``Trainer``
   from the memory map (``--loader_workers 4``), from preloaded features
   (``--preload_feats 1``) and from the in-memory split, each 2 + 6 steps,
   losses bit-identical across the three, ms/step and the data-wait share
   of each; fused CST with the scb-gt baseline on K2 from the files with
   ``--train_cached_tokens`` and ``--train_bcmrscores_pkl`` against the
   in-memory split's own df and scores, 2 steps each, rewards, advantages
   and losses bit-identical; phase 7's CST checkpoint evaluated at beam 5
   through the eval CLI's ``main`` on the written val files
   (``--test_*``), scores and captions equal to phase 9's; and an
   exported checkpoint of those weights (``weights.to_flax``) served by a
   ``python -m cst_captioning_tpu_torch.serve --checkpoint_path`` process
   on the val files, 12 captions equal to phase 9's.  The phase's seconds
   are printed (budget 120 s);
13. serving, the rest, at phase 4's width and model on K2: (a) K2 called
   twice on the same inputs at B = 1, 8, 40 in float32 and bfloat16
   storage, bitwise equal (what the ladder's re-runs rely on); (b) 16
   greedy ``stream`` requests through ``CaptionServer``, each stream's
   text equal to its final caption and to phase 4's, TTFT and chunk-gap
   p50/p99 printed; (c) 8 beam-5 streams, one terminal chunk each,
   captions equal to phase 5's; (d) a result cache of 64 over 32 requests
   of 8 videos: 24 hits, K2 launches equal to those of the 8 alone, the
   hit path's milliseconds; (e) a chaos plan (``serve_wedge``,
   ``serve_garble``, ``admit_err``) and a forced rebuild, captions
   bit-identical to a clean run with no kernel library built or loaded,
   then a plan past the ladder raising ``ServingUnrecoverable``; (f) a
   deadline under one chunk answered ``expired``, the other 15 captions
   equal to phase 4's; (g) ``python -m cst_captioning_tpu_torch.serve``
   on ``--serve_port -1`` (2 connections x 8 requests equal to phase 4's,
   a ``health`` op, SIGTERM with 16 more in flight: exit 75, every
   request answered), a second process drained and aborted by a second
   signal (exit 143) and a third given a plan past the ladder (exit 124).
   The phase's seconds are printed (budget 90 s);
14. the fleet, at phase 4's width and model: (a) float32 K2 gives a row
   the same bits alone, in a batch of 4 and of 8, and at another index;
   (b) 3 replicas sharing the card serve 32 greedy requests through
   ``CaptionServer`` (every caption equal to phase 4's, routed counts and
   captions/s printed), and 2 replicas on the reference cell with K1
   serve 16 (equal to phase 6's); (c) ``kill_replica(1)`` with residents
   aboard: captions bit-identical, 1 kill and 1 restart, no kernel-library
   event, killed -> requeued -> responded in the lifecycle stream; (d)
   ``serve_wedge@replica=0`` past a 0/0 ladder restarts the replica,
   captions bit-identical; (b)-(d) with ``CST_LOCK_SANITIZER=1`` and zero
   violations; (e) ``python -m cst_captioning_tpu_torch.serve_fleet``
   with both replicas wedged at restart limit 0: exit 124 and a blackbox
   (started first, so its start-up overlaps (a)-(d)); (f) 16 greedy
   requests with the lifecycle tracer off and on, twice, req/s and
   p50/p99 of each, the dump op's event count and the trace parts; (g)
   the bench's ``--replicas 3 --serve_kill_replica 1 --serve_trace 1``
   record, ``fleet.parity_ok`` and the accounting true.  The phase's
   seconds are printed (budget 90 s);
15. the process fleet, ``python -m cst_captioning_tpu_torch.serve_supervisor``
   at phase 4's width and model, every process with
   ``CST_LOCK_SANITIZER=1``: (a) 3 serve-CLI children sharing the card
   serve 32 greedy requests over 2 socket connections, timed with nothing
   else on the card (captions equal to phase 4's, each child's exit stats
   K2 twice a decode step, routed counts, captions/s and p50/p99, and the
   supervisor process without a CUDA context); (a') 2 children on the
   reference cell with K1 serve 16 (equal to phase 6's, K1 once a step);
   then at once: (b) ``--supervise_probe 1`` (``proc_kill@replica=1``
   after a ``dump``: every request answered once, captions equal to the
   single-engine child's and phase 4's, ``incidents/<NNN>_replica1_rc137/``
   with the blackbox, no post-warm-up compile and no ``nvcc`` build in a
   live child); (c) ``proc_wedge@replica=0`` (SIGSTOP, killed from outside
   as 124) and ``proc_preempt@replica=2`` (drain, exit 75, its queue
   requeued) under 24 streams, each equal to phase 4's; (d)
   ``--journal_probe 1`` (the supervisor's process group SIGKILLed
   mid-storm, relaunched on its journal); (e) ``--autoscale_probe 1``
   (1 -> more -> 1 replica, answers equal to phase 4's); (g) every child
   given a fatal fault at ``--supervise_restart_limit 0``: exit 124, one
   incident per replica, the blackbox naming every replica dead; (f) over
   (b): ``fleet_metrics.jsonl`` with every replica slot in every row and no
   gap over 3 intervals, ``clock_sync.json`` one entry per child pid, the
   supervisor's and each child's trace parts, no SLO alert.  No process
   of the phase is left running.  The phase's seconds are printed
   (budget 150 s);
16. the model variants on phase 7's split and width, run after phase 12:
   K1 (B = 1, 8, 1280) and K2 (B = 1, 8, 1344) against their plain
   versions at T = 1, 2 and 3 in both storages, timed and bounded at
   manet's T = 2, batch-invariant at B = 40; (a) the transformer (8
   heads, 2 layers): XE, its profiled step, the prefix decode against
   the full buffer on 16 greedy rows (logits within 1e-4 of max(1,
   max|logit|), tokens equal), fused CST (scb-sample), the beam-5 eval
   of the result, bfloat16 XE and the serve CLI's refusal, no kernel
   launched; (b) manet: XE on K1, fused CST on K2 at T = 2 and 16
   requests through the serve CLI's backend equal to the offline
   decode; (c) the 2-layer LSTM: the fused cell refused, XE on K1, 16
   requests on the reference cell with K1; (d) the pooled LSTM: XE, no
   launch; (e) ``--remat_cell`` 0 against 1: XE ms/step and peak memory
   with and without K1, and one step's gradients within 1e-6.  Phases
   7-12 run ``--remat_cell 0`` (``stage_args``); phase 16 counts K1
   twice a teacher-forced step under ``--remat_cell 1`` (the recompute).
   The phase's seconds are printed (budget 150 s).

17. training telemetry and the autotuner on phase 10's split at phase
   7's width: (e) ``python -m cst_captioning_tpu_torch.tune --fast``
   into a record of its own (the ``cuda`` entry with this card's name,
   both points measured) with, beside it, (d) ``--debug_nans 1`` with
   ``nan_grad@step=1`` (exits non-zero, anomaly mode naming the
   operation) and (f) ``tools/stage_chain.probe_device`` (``ok``), and
   later its rerun (reused with 0 measurements) beside the start of
   (a)'s traced run, which prints how long before its first step the
   rerun ended; (c) XE and fused CST
   (K1, K2) disarmed and armed (``--trace_dir``, ``--step_timing 1``) in
   turns in this process, through the train CLI's parser and
   ``Trainer``; (a) XE and (b) fused CST traced through the train CLI
   (the same, ``--profile_dir`` over loop steps [2, 4),
   ``--tensorboard 1``): the span trace, the four phase gauges and a
   non-null ``mfu_pct`` in ``metrics.jsonl``, the ``torch.profiler``
   trace naming K1's and K2's CUDA symbols as often as the wrappers
   counted over the window (K1 ``max_length`` times a step, K2's gate
   kernel once per executed rollout step; a trace without them fails),
   and ``profile_top``'s summary (``python -m
   cst_captioning_tpu_torch.tools.profile_top``, here its ``summarize``
   on the events read once for both) counting the same (its top 10
   kernels, the window and its device-busy share printed beside the
   card, with the seconds the trace's read and summary took).  Printed: ms/step
   disarmed, armed and profiled, and the steps that
   open and close the window.  All under the record: ``tuned_provenance``
   shows the record's ``--decode_chunk`` where the command line leaves
   it and the explicit one where it sets it.  The phase's seconds are
   printed (budget 90 s).  Phases 1-16 and their children run with
   ``CST_TUNED_CONFIGS_TORCH=''``.

18. data and context parallelism (``parallel/``), run after phase 16 on
   phase 7's split and width: (a) the train CLI's parser,
   ``distributed_init`` and ``Trainer`` with ``--num_processes 1
   --process_id 0 --coordinator_address 127.0.0.1:<free port>`` (a
   one-rank NCCL group, K1 and K2 on): 3 XE steps, then 2 fused CST
   steps from the XE state; per-step losses and the final parameters
   and optimizer state bit for bit those of the same run without the
   flags, launches checked as in phase 7; (b) ``run_dp_pipeline(2)``,
   two gloo ranks sharing the card, against ``run_dp_pipeline(1)`` at
   full width (8 videos x 20 captions, K1 and K2): sampled and greedy
   tokens bitwise, the XE, RL and fused losses and the fused reward
   within 1e-5 relative, the ranks' states bitwise equal, each
   kernel's launches exactly its count per teacher-forced and decode
   step at each rank count; the parameters after 4 SGD updates within
   the reference test's bound (rtol 1e-4, atol 1e-6), after 4 Adam
   updates within it but for at most 1e-4 of the elements, every element
   within 5% of one step, and Adam replayed at those elements from each
   run's reduced gradients reproducing their gap (``PARAM_RTOL`` and the
   constants beside it say why); (c) over 2 ranks: ``sp_additive_attention`` at B
   = 64 over T = 29 split ragged (padded to 30, masked) against K1 on
   the whole T, ``sp_dot_attention`` and the ring at T = 4096 against
   one rank's full attention (with and without a mask), within 1e-5,
   and the CP transformer XE step (8 heads, 2 layers; a time-sharded
   254 x 2048 stream beside 2 x 4096 clip vectors) against the
   unsharded step, loss within 1e-5 and parameters within 2e-5; (d) the
   ms/step of (a) with and without the group and of (b) at 1 and 2
   ranks (the SGD pair), each beside the card's name and power limit.
   No child process of the phase may still run after it.  The phase's
   seconds are printed (budget 90 s).

Each serving phase sets every kernel's launch count to 0 just before it
and reads the counts just after; a kernel of the path launched other
than its count per decode step (K2 twice, K1 once) fails the run.  The
training phase does the same around each timed step: K1 exactly
``max_length`` launches per teacher-forced forward (one per step the
iteration completed), K2 exactly 2 per executed step of the rollout it
dispatched; the fused path builds no host reward.

Output: phase lines as they run; then a JSON object with one entry per
kernel and storage dtype (``storage``; times at the serving batch B = 8,
every measured batch under ``by_batch``, phase 16's under ``T2/<B>``;
launches of phases 4-7, 9, 10 and 12-18 for float32, of phases 8, 11,
14g and 17 for bfloat16); then
the card line (``nvidia-smi``
name and power limit); and last ``{"ok": true, "device": ...}``.
Without a CUDA device, or run outside a checkout of the repository, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys
import threading
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


#: The port's lint: its rules, all of which must run.
LINT_RULES = 12


def lint_start() -> tuple:
    """The port's lint over this checkout, as a process (it runs beside
    the build).  -> (the process, its start on ``time.perf_counter``)."""
    return subprocess.Popen(
        [sys.executable, "-m", "cst_captioning_tpu_torch.lint", "--json"],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True), time.perf_counter()


def lint_check(lint: tuple) -> None:
    """Print the lint's one line, with its seconds from start to reading
    and the seconds the smoke waited for it after the build (its cost to
    the run); fail on any violation."""
    proc, t_start = lint
    t_wait = time.perf_counter()
    out, err = proc.communicate(timeout=300)
    t_read = time.perf_counter()
    try:
        doc = json.loads(out)
    except ValueError:
        fail(f"lint: exit {proc.returncode} without a JSON report:\n"
             + err[-3000:])
    print("lint: " + json.dumps({
        "tool": doc.get("tool"), "python": sys.version.split()[0],
        "seconds": round(t_read - t_start, 2),
        "waited_after_build_s": round(t_read - t_wait, 2),
        "exit": proc.returncode, "files": doc["files_scanned"],
        "rules": len(doc["rules_ran"]),
        "suppressions": len(doc["suppressed"]),
        "violations": len(doc["violations"]), "by_rule": doc["summary"]}))
    if (proc.returncode != 0 or doc["violations"]
            or len(doc["rules_ran"]) != LINT_RULES):
        fail("lint: " + "; ".join(
            f"{v['path']}:{v['line']}: {v['rule']}: {v['message']}"
            for v in doc["violations"][:20]))


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


def k1_bound(b: int, elem: int = 4, t: int = T_MEM):
    """K1's bound with q, proj_mem, memory, ctx and w in ``elem``-byte
    storage (score_v float32), over a memory of ``t`` steps."""
    n_bytes = (elem * (b * A + b * t * A + b * t * H + b * H + b * t)
               + 4 * A)
    return bound_ms(n_bytes, b * (4 * t * A + 5 * t + 2 * t * H),
                    FP32_OPS_PER_S if elem == 4 else BF16_OPS_PER_S)


def k2_bound(b: int, elem: int = 4, t: int = T_MEM):
    """K2's bound with every operand but score_v in ``elem``-byte storage
    (the gate weights 12.6 MB in float32, 6.3 MB in bfloat16), over a
    memory of ``t`` steps."""
    n_bytes = (elem * (b * (E + 2 * H + A) + b * t * (A + H)
                       + (E + 2 * H) * 4 * H + 4 * H + 2 * b * H) + 4 * A)
    n_ops = (b * (4 * t * A + 5 * t + 2 * t * H)
             + 2 * b * (E + 2 * H) * 4 * H + 10 * b * H)
    return bound_ms(n_bytes, n_ops,
                    FP32_OPS_PER_S if elem == 4 else BF16_OPS_PER_S)


def attention_inputs(b: int, gen, t: int = T_MEM):
    import torch

    def r(*shape):
        return torch.randn(*shape, generator=gen).cuda()

    return r(b, A), r(b, t, A), r(b, t, H), r(A) / A ** 0.5


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
        g_w = torch.randn(b, pm.shape[1], generator=gen).cuda()
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
    bound, by = k1_bound(b, t=pm.shape[1])
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
    bound, by = k2_bound(b, t=pm.shape[1])
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
            "gate_kernel": k2.gate_geometry(b, E, H)["kernel"],
            "kernel": k, "plain": p, "library": lib}


def report_check(name: str, b: int, m: dict, label: str = "") -> None:
    """Print one kernel check; fail if it disagrees with its plain version
    (or, where its gradients were checked, with their plain version's)."""
    extra = "".join(f" {key}={m[key]:.6f}" for key in
                    ("backward_ms", "backward_graph_ms") if key in m)
    grad = (f" grad_rel_err={m['grad_rel_err']:.3e}"
            if "grad_rel_err" in m else "")
    gate = f" gate={m['gate_kernel']}" if "gate_kernel" in m else ""
    print(f"kernel {name} B={b}{label}: max_abs_err={m['max_abs_err']:.3e}"
          f"{grad}{gate} ms={m['ms']:.6f} ({m['ms_is']}) "
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
        gate = k2.gate_geometry(8, E, H, elem)
        rc = _cuda.load("decode_cell", "decode_cell_gate_max_clusters")(
            E, H, elem, gate["variant"], ctypes.byref(clusters))
        _cuda.check(rc, "decode_cell_gate_max_clusters")
        tiles = gate["column_tiles"]
        print(f"K2 gate stage ({dtype}, {gate['kernel']}): the card holds "
              f"{clusters.value} clusters of {gate['cluster']} blocks at "
              f"once; the serving width has {tiles} (one wave: "
              f"{clusters.value >= tiles})")
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
    batch (64 videos x 20 captions) and optimiser, with ``--remat_cell
    0`` (the step phases 7-12 have always measured: K1 once a
    teacher-forced step; phase 16 measures the CLI's default of 1)."""
    return ["--synthetic_videos", "6513", "--synthetic_val_videos", "497",
            "--synthetic_rich_vocab", "8000", "--captions_per_video", "20",
            "--feat_shapes", "28x2048,1x4096", "--synthetic_seed", "0",
            "--max_length", str(MAX_LEN), "--rnn_size", "512",
            "--input_encoding_size", "512", "--att_size", "512",
            "--drop_prob", "0.5", "--pallas_attention", "1",
            "--decode_kernel", "fused", "--batch_size", "64",
            "--seq_per_img", "20", "--optim", "adam",
            "--learning_rate", "2e-4", "--grad_clip", "10",
            "--decode_chunk", str(CHUNK), "--seed", "0",
            "--remat_cell", "0", *extra]


def timed_steps(trainer, n: int, check) -> list:
    """``n`` iterations of ``trainer``, each synchronised and timed, with
    the launch counts set to 0 before and checked by ``check(completed,
    launches)`` after each (``completed``: the (step, metrics) pairs the
    iteration completed).  -> [(seconds, completed, launches)]."""
    import torch

    from cst_captioning_tpu_torch.ops import (gate_launch_counts,
                                              launch_counts,
                                              launch_counts_by_dtype,
                                              reset_launch_counts)

    out = []
    for _ in range(n):
        reset_launch_counts()
        t0 = time.perf_counter()
        done = trainer.iteration()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {**launch_counts(), **launch_counts_by_dtype(),
                    **gate_launch_counts()}
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


#: The device CIDEr-D tables that the CST trainers of this process share
#: (``Trainer(device_tables=)``), so that phases 8, 16 and 18 build none
#: of their own on phase 7's split: several host seconds a trainer.
REWARD_TABLES: dict = {}


def smoke_trainer(opt, splits):
    """A ``Trainer`` of this process over ``splits``, sharing
    ``REWARD_TABLES``."""
    from cst_captioning_tpu_torch.training.trainer import Trainer

    return Trainer(opt, splits, device_tables=REWARD_TABLES)


def check_rollout_gate(name: str, launches: dict, steps: float,
                       elem: int) -> None:
    """The rollout's K2 gate launches in a fused CST step all went to the
    kernel ``gate_geometry`` picks for ``ROLLOUT_ROWS`` rows in storage of
    ``elem`` bytes: one a rollout step."""
    from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2

    gate = k2.gate_geometry(ROLLOUT_ROWS, E, H, elem)["kernel"]
    gates = {g: launches.get(f"fused_decode_cell/{g}", 0)
             for g in k2.GATE_KERNELS}
    if gates[gate] != steps or sum(gates.values()) != steps:
        fail(f"{name}: K2's gate launches {gates} in a rollout of {steps} "
             f"steps at {ROLLOUT_ROWS} rows; {gate} once a step expected")


def gate_totals(launches: dict) -> dict:
    """``{gate kernel: launches}`` out of a phase's summed counters."""
    from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2

    return {g: launches.get(f"fused_decode_cell/{g}", 0)
            for g in k2.GATE_KERNELS}


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

    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2

    rows = TRAIN_BATCH * TRAIN_SEQ
    total = {"fused_additive_attention": 0, "fused_decode_cell": 0,
             **{f"fused_decode_cell/{g}": 0 for g in k2.GATE_KERNELS}}

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
    xe = smoke_trainer(train.parse_args(stage_args(
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

    wxe = smoke_trainer(train.parse_args(stage_args(
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
    cst = smoke_trainer(train.parse_args(stage_args(
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
        check_rollout_gate("train CST fused", launches,
                           float(m["rollout_steps"]), 4)
        if not np.isfinite(float(m["reward"])):
            fail(f"CST reward not finite: {float(m['reward'])}")

    before = [p.detach().clone() for p in cst.model.parameters()]
    add(timed_steps(cst, 1, fused_step))
    cst_steps = timed_steps(cst, 3, fused_step)
    add(cst_steps)
    fused_ms = report_stage("CST fused", cst_steps, rows)
    print(f"train CST fused: K2's gate launches in the 4 rollouts at "
          f"{ROLLOUT_ROWS} rows, by kernel: {gate_totals(total)}")
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

    from cst_captioning_tpu_torch.ops import (gate_launch_counts,
                                              launch_counts,
                                              launch_counts_by_dtype,
                                              reset_launch_counts)

    reset_launch_counts()
    t0 = time.perf_counter()
    scores = cst.validate()
    torch.cuda.synchronize()
    launches = {**launch_counts(), **launch_counts_by_dtype(),
                **gate_launch_counts()}
    for key in total:
        if key.startswith("fused_decode_cell"):
            total[key] += launches[key]
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
    host = smoke_trainer(train.parse_args(stage_args(
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
    launches = {**launch_counts(), **launch_counts_by_dtype(),
                **gate_launch_counts()}
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


def bf16_batch_invariant(fn, args, per_row: int, sizes=()) -> bool:
    """A row's outputs have the same bits in a batch, alone, at another
    index of the batch, and inside contiguous sub-batches of each of
    ``sizes`` rows (K2: each size may take another gate kernel)."""
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
    for n in sizes:
        for lo in (0, (b - n) // 2, b - n):
            same &= all(torch.equal(o[lo:lo + n], a) for o, a in
                        zip(full, fn(*rows(slice(lo, lo + n)))))
    return same


#: Sub-batches a 1344-row K2 batch is held against bit for bit: the
#: serving buckets and the beam-5 batches (the weight stream) and the
#: beam-5 eval's 320 rows (the large-batch tiles).
K2_INVARIANCE_SIZES = (8, 40, 320)


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
    bound, by = k1_bound(b, 2, pm.shape[1])
    k, p = (timed(lambda: k1.fused_additive_attention(*args), flush),
            timed(lambda: k1.additive_attention_plain(*args), flush))
    m = {"max_abs_err": err, "tol": tol, "ok": ok, "differ": differ,
         "ms": k["ms"],
         "ms_is": "profiler", "plain_ms": p["ms"], "bound_ms": bound,
         "bound_by": by, "library_ms": None, "kernel": k, "plain": p}
    if backward:
        g_ctx = torch.randn(b, H, generator=gen).cuda().to(torch.bfloat16)
        g_w = torch.randn(b, pm.shape[1],
                          generator=gen).cuda().to(torch.bfloat16)
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
    bound, by = k2_bound(b, 2, pm.shape[1])
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
            "gate_kernel": k2.gate_geometry(b, E, H, 2)["kernel"],
            "kernel": k, "plain": p, "library": lib,
            "batch_invariant": (bf16_batch_invariant(
                k2.fused_decode_cell, args, 6,
                K2_INVARIANCE_SIZES if b == ROLLOUT_ROWS else ())
                if b in (40, ROLLOUT_ROWS) else None)}


def report_bf16(name: str, b: int, m: dict, label: str = "") -> None:
    """Print one bfloat16 kernel check; fail on any disagreement."""
    extra = "".join(f" {key}={m[key]}" for key in
                    ("grad_bitwise", "batch_invariant", "backward_ms",
                     "backward_graph_ms") if m.get(key) is not None)
    gate = f" gate={m['gate_kernel']}" if "gate_kernel" in m else ""
    print(f"kernel {name} bfloat16 B={b}{label}:{gate} "
          f"max_abs_err={m['max_abs_err']:.3e}"
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
    both bitwise batch-invariant at B = 40, K2 also at 1344 (its rows
    alone and in sub-batches of 8, 40 and 320: every gate kernel).  ->
    {kernel: {batch: dict}}."""
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
    xe = smoke_trainer(train.parse_args(stage_args(
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
    cst = smoke_trainer(train.parse_args(stage_args(
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
        check_rollout_gate("train CST fused bf16", launches,
                           float(m["rollout_steps"]), 2)
        if not np.isfinite(float(m["reward"])):
            fail(f"bfloat16 CST reward not finite: {float(m['reward'])}")

    before = [p.detach().clone() for p in cst.model.parameters()]
    add(timed_steps(cst, 1, fused_step))
    cst_steps = timed_steps(cst, 3, fused_step)
    add(cst_steps)
    cst_ms = report_stage("CST fused bf16", cst_steps, rows)
    print(f"train CST fused bf16: K2's gate launches in phase 8's 4 "
          f"rollouts at {ROLLOUT_ROWS} rows, by kernel: {gate_totals(total)}")
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
    ``--checkpoint_path``, equal to the eval's predictions.  -> (K2's
    launches in the offline decode, the scores, the predictions); phase
    12 removes the checkpoints."""
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
    return launches["fused_decode_cell"], scores, preds


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


def run_trains(jobs) -> list:
    """``run_train`` of every ``(name, argv, expect)`` in ``jobs`` at
    once: runs that do not wait on each other share the card.  Fails
    when any fails, after all have ended.  -> [(the process, its
    seconds)] in ``jobs``' order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = [pool.submit(run_train, *job) for job in jobs]
        return [f.result() for f in futures]


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
    resume.  The 8 processes run in four waves of runs that do not wait
    on each other: (1) the XE twin and XE's preempt run; (2) the CST
    twin, CST's preempt run and XE's resume; (3) CST's resume and the
    wedge run, the one beside it that has a watchdog; (4) the wedge
    run's resume alone.  Every resumed run's last checkpoint must be
    bit-identical to its twin's (parameters, optimizer moments and count,
    generator states, run state), and its post-resume train losses equal.
    Prints each run's seconds, the time from the signal to the exit
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

    def drill_argv(name, args, fault, at):
        ck = os.path.join(RESUME_ROOT, name)
        return ck, resume_args(
            *args, "--checkpoint_path", ck, "--fault_plan",
            f"{fault}@step={at}", *(
                ("--wedge_timeout", str(RESUME_WEDGE_TIMEOUT),
                 "--save_every_steps", "1") if fault == "wedge" else ()))

    def check_twin(name, ck, rollouts, secs):
        account(f"{name} twin", ck, last, rollouts, True)
        print(f"resume {name}: uninterrupted twin {secs:.1f} s")

    def check_fault(name, ck, fault, at, rollouts, proc, secs):
        if fault == "preempt":
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
            if "WATCHDOG: no progress" not in proc.stderr:
                fail(f"phase 10 {name}: exit 124 without the watchdog")
            print(f"resume {name}: wedge@step={at} with --wedge_timeout "
                  f"{RESUME_WEDGE_TIMEOUT:g} exited 124 in {secs:.1f} s")

    def check_resume(name, ck, twin_ck, fault, at, rollouts, proc, secs):
        start = at + 1 if fault == "preempt" else at
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

    xe_twin = os.path.join(RESUME_ROOT, "xe_twin")
    cst_twin = os.path.join(RESUME_ROOT, "cst_twin")
    cst_args = ("--use_rl", "1", "--rl_baseline", "greedy",
                "--learning_rate", "2e-5", "--start_from", xe_twin)
    xe_ck, xe_argv = drill_argv("xe", (), "preempt", 1)
    cst_ck, cst_argv = drill_argv("cst", cst_args, "preempt", 2)
    wedge_ck, wedge_argv = drill_argv("xe_wedge", (), "wedge", 3)
    # Wave 1: the XE twin and XE's preempt run.
    (_, twin_s), (proc, secs) = run_trains([
        ("xe twin", resume_args("--checkpoint_path", xe_twin), 0),
        ("xe preempt", xe_argv, 75)])
    check_twin("xe", xe_twin, False, twin_s)
    check_fault("xe", xe_ck, "preempt", 1, False, proc, secs)
    # Wave 2: CST from the XE twin (twin and preempt run), XE's resume.
    (_, twin_s), (proc, secs), (rproc, rsecs) = run_trains([
        ("cst twin", resume_args(*cst_args, "--checkpoint_path", cst_twin),
         0),
        ("cst preempt", cst_argv, 75), ("xe resume", xe_argv, 0)])
    check_resume("xe", xe_ck, xe_twin, "preempt", 1, False, rproc, rsecs)
    check_twin("cst", cst_twin, True, twin_s)
    check_fault("cst", cst_ck, "preempt", 2, True, proc, secs)
    # Wave 3: CST's resume and the wedge run; wave 4: the wedge's resume.
    (rproc, rsecs), (proc, secs) = run_trains([
        ("cst resume", cst_argv, 0), ("xe_wedge wedge", wedge_argv, 124)])
    check_resume("cst", cst_ck, cst_twin, "preempt", 2, True, rproc, rsecs)
    check_fault("xe_wedge", wedge_ck, "wedge", 3, False, proc, secs)
    proc, secs = run_train("xe_wedge resume", wedge_argv, 0)
    check_resume("xe_wedge", wedge_ck, xe_twin, "wedge", 3, False, proc,
                 secs)
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


def run_bench(name: str, *argv, phase: str = "phase 11") -> dict:
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
        fail(f"{phase} bench {name}: exit {proc.returncode}, "
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


# Phase 12: phase 7's splits written as files, under the checkpoints
# directory (ignored by git), removed at the phase's end.
FILES_ROOT = os.path.join(HERE, "checkpoints", "chip_smoke_files")
FILES_STEPS = (2, 6)            # XE warm-up and timed steps per data source
FILES_SERVE_REQUESTS = 12


def xe_from(name: str, opt, splits, losses_of) -> dict:
    """Phase 12's XE run of one data source: 2 warm-up and 6 timed steps
    (K1 30 a step), with the time the loop waited in ``next_batch``.
    -> {"ms": median ms/step, "wait_share", "losses"}."""
    import numpy as np


    t0 = time.perf_counter()
    trainer = smoke_trainer(opt, splits)
    build_s = time.perf_counter() - t0
    wait = [0.0]
    fetch = trainer.next_batch

    def timed_fetch():
        t = time.perf_counter()
        batch = fetch()
        wait[0] += time.perf_counter() - t
        return batch

    trainer.next_batch = timed_fetch
    try:
        warm = timed_steps(trainer, FILES_STEPS[0], losses_of)
        wait[0] = 0.0
        steps = timed_steps(trainer, FILES_STEPS[1], losses_of)
    finally:
        trainer.close()
    secs = np.array([sec for sec, _, _ in steps])
    out = {"ms": float(np.median(secs)) * 1e3,
           "wait_share": wait[0] / float(secs.sum()),
           "losses": [float(m["loss"]) for _, done, _ in warm + steps
                      for _, m in done],
           "launches": sum(l["fused_additive_attention"]
                           for _, _, l in warm + steps)}
    print(f"files XE {name}: trainer built in {build_s:.3f} s; "
          f"{FILES_STEPS[1]} timed steps, median {out['ms']:.3f} ms/step "
          f"(min {secs.min() * 1e3:.3f}, max {secs.max() * 1e3:.3f}) = "
          f"{TRAIN_ROWS / out['ms'] * 1e3:.1f} captions/s; data wait "
          f"{wait[0] * 1e3:.3f} ms = data_wait_share {out['wait_share']:.6f}")
    return out


def files_phase(splits, eval_scores, eval_preds) -> dict:
    """Phase 12: train, evaluate and serve from split files.  ->
    {kernel: float32 launches in the phase}."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from cst_captioning_tpu_torch import eval as port_eval
    from cst_captioning_tpu_torch import train
    from cst_captioning_tpu_torch.data import synthetic
    from cst_captioning_tpu_torch.data.dataset import split_files
    from cst_captioning_tpu_torch.ops import (launch_counts,
                                              launch_counts_by_dtype,
                                              reset_launch_counts)
    from cst_captioning_tpu_torch.tools.stage_chain import data_argv
    from cst_captioning_tpu_torch.training import checkpoint
    from cst_captioning_tpu_torch.weights import (save_exported_checkpoint,
                                                  to_flax)

    t_phase = time.perf_counter()
    total = {"fused_additive_attention": 0, "fused_decode_cell": 0}
    os.makedirs(FILES_ROOT, exist_ok=True)
    root = tempfile.mkdtemp(dir=FILES_ROOT)
    data = os.path.join(root, "data")
    t0 = time.perf_counter()
    spec = synthetic.SyntheticSpec(max_len=MAX_LEN)
    written = {name: synthetic.write_split(data, name, spec, data=split)
               for name, split in zip(("train", "val"), splits)}
    write_s = time.perf_counter() - t0
    sizes = {name: sum(os.path.getsize(os.path.join(data, f))
                       for f in os.listdir(data) if f.startswith(name + "_"))
             for name in written}
    print(f"files: train and val splits written in {write_s:.3f} s (host): "
          f"train {sizes['train']} bytes "
          f"({sum(os.path.getsize(p) for p in written['train']['feat_npy'])}"
          f" of .npy features), val {sizes['val']} bytes; "
          + ", ".join(sorted(os.listdir(data))))
    files = data_argv(data, "train") + data_argv(data, "val")
    for key in ("cached_tokens", "consensus_pkl"):
        if key not in split_files(data, "train"):
            fail(f"phase 12: write_split wrote no {key}")

    def losses_of(done, launches):
        if launches["fused_additive_attention"] != MAX_LEN * len(done):
            fail(f"phase 12: K1 launched "
                 f"{launches['fused_additive_attention']} times in "
                 f"{len(done)} teacher-forced steps")

    ck = os.path.join(root, "ck")
    runs = {}
    for name, extra, given in (
            ("memory-mapped", files, None),
            ("preloaded", files + ["--preload_feats", "1"], None),
            ("in-memory split", [], splits)):
        opt = train.parse_args(stage_args(
            *extra, "--loader_workers", "4", "--checkpoint_path",
            os.path.join(ck, "xe_" + name.split()[0])))
        runs[name] = xe_from(name, opt, given, losses_of)
        total["fused_additive_attention"] += runs[name]["launches"]
    want = runs["in-memory split"]["losses"]
    for name, run in runs.items():
        if run["losses"] != want:
            fail(f"phase 12: XE losses {name} {run['losses']} differ from "
                 f"the in-memory split's {want}")
    print(f"files XE: the {len(want)} losses of the three runs bit-identical"
          f" (first {want[0]:.6f}, last {want[-1]:.6f})")

    # Fused CST, scb-gt baseline, from phase 7's WXE weights: the written
    # pickles against the in-memory split's own df and consensus scores.
    cst = {}
    for name, extra, given in (
            ("files", files, None), ("in-memory split", [], splits)):
        t0 = time.perf_counter()
        trainer = smoke_trainer(train.parse_args(stage_args(
            *extra, "--use_rl", "1", "--rl_baseline", "scb-gt",
            "--learning_rate", "2e-5",
            "--start_from", os.path.join(CKPT_ROOT, "wxe"),
            "--checkpoint_path", os.path.join(ck, "cst_" + name.split()[0]))),
            given)
        build_s = time.perf_counter() - t0

        def fused(done, launches):
            losses_of(done, launches)
            (_, m), = done
            if launches["fused_decode_cell"] != 2 * float(
                    m["rollout_steps"]):
                fail(f"phase 12: K2 launched "
                     f"{launches['fused_decode_cell']} times in a rollout "
                     f"of {float(m['rollout_steps'])} steps")

        try:
            steps = timed_steps(trainer, 2, fused)
        finally:
            trainer.close()
        for _, _, launches in steps:
            for key in total:
                total[key] += launches[key]
        cst[name] = [{k: float(m[k]) for k in ("loss", "reward", "baseline",
                                               "advantage")}
                     for _, done, _ in steps for _, m in done]
        print(f"files CST fused scb-gt, {name}: trainer and reward tables "
              f"built in {build_s:.3f} s ({trainer.reward_setup['slots']} df "
              f"slots); steps {[round(s * 1e3, 3) for s, _, _ in steps]} ms;"
              f" {cst[name]}")
    if cst["files"] != cst["in-memory split"]:
        fail("phase 12: CST from the df and consensus pickles differs from "
             "the in-memory split's own df and scores")
    print("files CST: rewards, baselines, advantages and losses of "
          "--train_cached_tokens/--train_bcmrscores_pkl bit-identical to "
          "the in-process df and scores")

    # Beam-5 eval of phase 7's CST checkpoint on the written val files.
    cst_dir = os.path.join(CKPT_ROOT, "cst")
    test = data_argv(data, "val", "test")
    result = os.path.join(root, "eval_files.json")
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = port_eval.main(["--checkpoint_path", cst_dir, "--beam_size",
                         str(EVAL_BEAM), "--eval_batch_size",
                         str(EVAL_BATCH), "--max_length", str(MAX_LEN),
                         "--decode_chunk", str(CHUNK), "--decode_kernel",
                         "fused", "--result_file", result, *test])
    torch.cuda.synchronize()
    launches = {**launch_counts(), **launch_counts_by_dtype()}
    total["fused_decode_cell"] += launches["fused_decode_cell"]
    with open(result) as f:
        out = json.load(f)
    same = sum(a == b for a, b in zip(out["predictions"], eval_preds))
    print(f"files eval --test_* beam {EVAL_BEAM}: rc {rc}, "
          f"{time.perf_counter() - t0:.3f} s, {same}/{len(eval_preds)} "
          f"captions and the scores equal to phase 9's: "
          f"{out['scores'] == eval_scores}; launches {launches}")
    if (rc != 0 or out["scores"] != eval_scores or same != len(eval_preds)
            or len(out["predictions"]) != len(eval_preds)):
        fail("phase 12: the eval on the val files differs from phase 9's")
    if launches["fused_decode_cell"] == 0 or launches["fused_decode_cell"] % 2:
        fail(f"phase 12: eval launches {launches}")

    # An exported checkpoint of the CST weights, served by the CLI.
    saved = checkpoint.load(cst_dir)
    exported = os.path.join(root, "exported_cst")
    save_exported_checkpoint(exported, to_flax(saved["model"]), saved["opt"],
                             splits[0].vocab, source=cst_dir,
                             step=saved["step"])
    want = {p["image_id"]: p["caption"]
            for p in eval_preds[:FILES_SERVE_REQUESTS]}
    lines = "".join(json.dumps({"id": i, "video_id": v}) + "\n"
                    for i, v in enumerate(want))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cst_captioning_tpu_torch.serve",
         "--checkpoint_path", exported, "--beam_size", str(EVAL_BEAM),
         "--decode_kernel", "fused", "--max_length", str(MAX_LEN),
         "--decode_chunk", str(CHUNK), *test],
        input=lines, cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
        capture_output=True, text=True, timeout=300)
    got = {r["video_id"]: r.get("caption") for r in
           map(json.loads, proc.stdout.splitlines()) if "video_id" in r}
    same = sum(got.get(v) == c for v, c in want.items())
    stats = [ln for ln in proc.stderr.splitlines() if ln.startswith("serve:")]
    print(f"files serve --checkpoint_path <exported>: exit "
          f"{proc.returncode}, {time.perf_counter() - t0:.3f} s (process), "
          f"{same}/{len(want)} captions equal to phase 9's; {stats[-1:]}")
    if proc.returncode != 0 or same != len(want):
        print(proc.stderr[-4000:], file=sys.stderr)
        fail("phase 12: the exported checkpoint's served captions differ "
             "from the offline decode")
    shutil.rmtree(FILES_ROOT, ignore_errors=True)
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    print(f"files phase: {time.perf_counter() - t_phase:.1f} s (budget "
          f"120 s); XE ms/step memory-mapped "
          f"{runs['memory-mapped']['ms']:.3f}, preloaded "
          f"{runs['preloaded']['ms']:.3f}, in-memory "
          f"{runs['in-memory split']['ms']:.3f}; launches {total}")
    return total


# Phase 13: serving, the rest.  The CLI processes of (e) and (g) start
# after the measured in-process parts, so their start-up does not share
# the card and the host with the measurements.
REST_BUDGET_S = 90.0
REST_CACHE_VIDEOS, REST_CACHE_REQUESTS = 8, 32


def k2_rerun_determinism() -> None:
    """Phase 13a: the same K2 call twice at B = 1, 8, 40 and 1344, in
    float32 and bfloat16 storage, bitwise equal: what the ladder's re-runs
    rely on.  Comparison launches: not counted."""
    import torch

    from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2

    gen = torch.Generator().manual_seed(4321)
    for dtype in ("float32", "bfloat16"):
        for b in (1, 8, 40, ROLLOUT_ROWS):
            q, pm, mem, v = attention_inputs(b, gen)
            x = torch.randn(b, E, generator=gen).cuda()
            c = torch.randn(b, H, generator=gen).cuda()
            h = torch.tanh(torch.randn(b, H, generator=gen)).cuda()
            wg = (torch.randn(E + 2 * H, 4 * H, generator=gen)
                  / (E + H) ** 0.5).cuda()
            bias = (0.1 * torch.randn(4 * H, generator=gen)).cuda()
            args = (x, c, h, q, pm, mem, v, wg, bias)
            if dtype == "bfloat16":
                args = to_bf16(x, c, h, q, pm, mem) + (v,) + to_bf16(wg,
                                                                     bias)
            first = k2.fused_decode_cell(*args)
            second = k2.fused_decode_cell(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b_) for a, b_ in zip(first, second))
            print(f"serving-rest K2 re-run {dtype} B={b}: bitwise equal "
                  f"{same}")
            if not same:
                fail(f"phase 13: K2 {dtype} at B={b} gave other bits on "
                     "a re-run")


def rest_serve(model, vocab, feats_for, engine, lines):
    """Serve ``lines`` through ``CaptionServer`` on ``engine``.  -> (the
    replies, K2 launches, seconds)."""
    import torch

    from cst_captioning_tpu_torch.ops import launch_counts, \
        reset_launch_counts
    from cst_captioning_tpu_torch.serving.server import CaptionServer

    out = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = CaptionServer(engine, vocab, feats_for, out=out).run_stdin(
        lines=lines)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        fail(f"phase 13: server exited {rc}")
    return ([json.loads(ln) for ln in out.getvalue().splitlines()],
            launch_counts()["fused_decode_cell"], seconds)


def check_streams(name: str, replies, want, beam: bool) -> int:
    """Every request's stream lines concatenate to its final caption,
    which equals ``want``; beam streams one terminal chunk.  -> the
    number of stream lines."""
    finals = {r["video_id"]: r for r in replies if r.get("final")}
    if sorted(finals) != sorted(want):
        fail(f"{name}: finals for {sorted(finals)}, not {sorted(want)}")
    lines = 0
    for vid, final in finals.items():
        parts = [r for r in replies if r.get("video_id") == vid
                 and r.get("stream") and r.get("final") is False]
        lines += len(parts)
        if [r["seq"] for r in parts] != list(range(len(parts))):
            fail(f"{name}: {vid} stream seq {[r['seq'] for r in parts]}")
        text = " ".join(r["text"] for r in parts)
        if text != final["caption"] or final["caption"] != want[vid]:
            fail(f"{name}: {vid} streamed {text!r}, final "
                 f"{final['caption']!r}, expected {want[vid]!r}")
        if beam and len(parts) != (1 if final["caption"] else 0):
            fail(f"{name}: beam {vid} streamed {len(parts)} chunks")
        if final["chunks"] != len(parts):
            fail(f"{name}: {vid} final says {final['chunks']} chunks, "
                 f"{len(parts)} came")
    return lines


class _AlwaysWedge:
    """A plan that wedges every chunk: past any ladder."""

    def fire(self, kind, index):
        return kind == "serve_wedge"


def rest_cli(*extra):
    """The serve CLI at phase 4's width and model, as a process."""
    return subprocess.Popen(
        [sys.executable, "-m", "cst_captioning_tpu_torch.serve",
         "--serve_demo", "1", "--serve_demo_eos_bias", EOS_BIAS,
         *WIDTH_ARGS, "--decode_kernel", "fused", "--beam_size", "1",
         *extra],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE))


def cli_stats(err_lines) -> dict:
    """The engine stats a serve process printed last on stderr."""
    got = [ln for ln in err_lines if ln and ln.startswith("serve: {")]
    return json.loads(got[-1][len("serve: "):]) if got else {}


def watch_stderr(proc):
    """Collect ``proc``'s stderr lines in a thread -> (lines, wait(text,
    seconds) that returns the first line containing ``text``)."""
    import threading

    lines, cond = [], threading.Condition()

    def read():
        for line in proc.stderr:
            with cond:
                lines.append(line.rstrip())
                cond.notify_all()
        with cond:
            lines.append(None)
            cond.notify_all()

    threading.Thread(target=read, name="chip-smoke-stderr",
                     daemon=True).start()

    def wait(text: str, seconds: float):
        end = time.monotonic() + seconds
        with cond:
            while True:
                for ln in lines:
                    if ln is not None and text in ln:
                        return ln
                left = end - time.monotonic()
                if left <= 0 or (lines and lines[-1] is None):
                    return None
                cond.wait(left)

    return lines, wait


#: Phase 13's drain-abort CLI: 20000 one-step chunks (~10 s) leave the
#: second signal a wide window to land in the drain; 1000 (~0.5 s) once
#: closed before it landed.
DRAIN_ABORT_ARGS = ("--serve_demo_eos_bias", "-50", "--max_length", "20000",
                    "--decode_chunk", "1", "--serve_cache", "0")


def drain_abort(proc, lines) -> dict:
    """Phase 13's two signals on a serve CLI started with
    ``DRAIN_ABORT_ARGS``: ``lines`` and a health request in, SIGTERM
    starts the drain, a second SIGTERM (sent while the process is stopped,
    so that it lands in the drain) aborts it: exit 143, every request
    answered ``rejected_draining``.  -> {"rc", "out" (the answers),
    "aborted" (the stderr line), "err" (stderr lines), "why" (None, or
    what went wrong)}."""
    import signal

    err, wait = watch_stderr(proc)
    res = {"rc": None, "out": [], "aborted": None, "err": err, "why": None}
    if wait("serve: ready", 120) is None:
        res["why"] = "the drain-abort CLI never started"
        return res
    proc.stdin.write("".join(lines) + '{"op": "health"}\n')
    proc.stdin.flush()
    first = proc.stdout.readline()
    if not first.strip() or json.loads(first).get("op") != "health":
        res["why"] = f"the drain-abort CLI's first reply is not health: " \
                     f"{first!r}"
        return res
    proc.send_signal(signal.SIGTERM)
    if wait("serve: draining", 60) is None:
        res["why"] = "the drain never started"
        return res
    proc.send_signal(signal.SIGSTOP)
    proc.send_signal(signal.SIGTERM)
    proc.send_signal(signal.SIGCONT)
    try:
        res["rc"] = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        res["why"] = ("the drain-abort CLI still ran 120 s after its second "
                      "signal; the tail of its stderr:\n"
                      + "\n".join(ln for ln in err[-40:] if ln))
        return res
    out = res["out"] = [json.loads(ln) for ln in
                        proc.stdout.read().splitlines() if ln.strip()]
    res["aborted"] = wait("drain aborted", 5)
    if (res["rc"] != 143 or res["aborted"] is None
            or sorted(r["id"] for r in out) != list(range(len(lines)))
            or any(r.get("error") != "rejected_draining" for r in out)):
        res["why"] = f"two signals gave exit {res['rc']}: {out}"
    return res


def rest_phase(greedy_caps, beam_caps) -> int:
    """Phase 13, serving the rest, at phase 4's width and model on K2:
    (a) K2's re-run determinism; (b) 16 greedy streams; (c) 8 beam-5
    streams; (d) the result cache; (e) a chaos plan, a forced rebuild and
    the ladder's end; (f) a deadline under one chunk; (g) the CLI on a
    socket with SIGTERM (75), two signals (143) and a plan past the
    ladder (124).  -> K2 launches of the phase (its own processes' too;
    not (a)'s)."""
    import signal
    import socket

    import numpy as np
    import torch

    from cst_captioning_tpu_torch import serve
    from cst_captioning_tpu_torch.ops import _cuda, launch_counts, \
        reset_launch_counts
    from cst_captioning_tpu_torch.resilience.faults import FaultPlan
    from cst_captioning_tpu_torch.serving.buckets import parse_buckets
    from cst_captioning_tpu_torch.serving.cache import ResultCache
    from cst_captioning_tpu_torch.serving.engine import (
        ServingEngine, ServingUnrecoverable)

    t_phase = time.perf_counter()
    k2_rerun_determinism()
    opt = serve.parse_args(["--serve_demo", "1", "--serve_demo_eos_bias",
                            EOS_BIAS] + WIDTH_ARGS
                           + ["--decode_kernel", "fused"])
    model, vocab, feat_shapes, feats_for = serve.build_backend(opt)

    def engine(beam_size=1, **kw):
        return ServingEngine(
            model, feat_shapes, max_len=opt.max_length, beam_size=beam_size,
            decode_chunk=opt.decode_chunk,
            bucket_sizes=parse_buckets(opt.serve_buckets), queue_limit=0,
            **kw)

    def line(i, **kw):
        return json.dumps({"id": i, "video_id": f"v{i}", **kw}) + "\n"

    total = 0

    # (b) 16 greedy streams.
    eng = engine()
    replies, k2n, seconds = rest_serve(
        model, vocab, feats_for, eng, [line(i, op="stream")
                                       for i in range(16)])
    st = eng.stats()
    check_launches("serving-rest stream", "K2", k2n, st["decode_steps"], 2)
    total += k2n
    n_lines = check_streams("serving-rest stream", replies, greedy_caps,
                            beam=False)
    print(f"serving-rest stream greedy: 16 requests in {seconds:.4f} s, "
          f"{n_lines} stream lines, each stream equal to its final caption "
          f"and to phase 4's; ttft p50={st['ttft_p50_ms']} ms "
          f"p99={st['ttft_p99_ms']} ms; chunk gap p50="
          f"{st['chunk_gap_p50_ms']} ms p99={st['chunk_gap_p99_ms']} ms; "
          f"latency p50={st['latency_p50_ms']:.3f} ms "
          f"p99={st['latency_p99_ms']:.3f} ms; K2 launches {k2n}")

    # (c) beam 5, streamed: one terminal chunk each.
    eng = engine(beam_size=5)
    replies, k2n, seconds = rest_serve(
        model, vocab, feats_for, eng, [line(i, op="stream")
                                       for i in range(8)])
    check_launches("serving-rest beam stream", "K2", k2n,
                   eng.stats()["decode_steps"], 2)
    total += k2n
    n_lines = check_streams("serving-rest beam stream", replies, beam_caps,
                            beam=True)
    print(f"serving-rest stream beam 5: 8 requests in {seconds:.4f} s, "
          f"{n_lines} terminal chunks, captions equal to phase 5's; "
          f"K2 launches {k2n}")

    # (d) the cache: 8 videos alone, then the same 8 and 24 repeats.
    def decode_videos(eng, ids):
        for i in ids:
            eng.submit(i, feats_for(f"v{i % REST_CACHE_VIDEOS}"))
        return {c.request_id: c for c in eng.run_until_idle()}

    reset_launch_counts()
    alone = decode_videos(engine(), range(REST_CACHE_VIDEOS))
    torch.cuda.synchronize()
    k2_alone = launch_counts()["fused_decode_cell"]
    eng = engine(result_cache=ResultCache(64))
    reset_launch_counts()
    first = decode_videos(eng, range(REST_CACHE_VIDEOS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits = decode_videos(eng, range(REST_CACHE_VIDEOS,
                                    REST_CACHE_REQUESTS))
    hit_s = time.perf_counter() - t0
    k2_cache = launch_counts()["fused_decode_cell"]
    total += k2_alone + k2_cache
    st = eng.stats()
    same = all(np.array_equal(c.tokens,
                              alone[c.request_id % REST_CACHE_VIDEOS].tokens)
               for c in list(first.values()) + list(hits.values()))
    print(f"serving-rest cache 64: {REST_CACHE_REQUESTS} requests of "
          f"{REST_CACHE_VIDEOS} videos: hits {st['cache_hits']}, misses "
          f"{st['cache_misses']}; K2 launches {k2_cache} (the "
          f"{REST_CACHE_VIDEOS} alone: {k2_alone}); captions equal: {same};"
          f" hit path {hit_s * 1e3 / len(hits):.4f} ms a request (host "
          f"clock, {len(hits)} hits submitted and returned)")
    if (st["cache_hits"] != REST_CACHE_REQUESTS - REST_CACHE_VIDEOS
            or k2_cache != k2_alone or not same
            or not all(c.cache_hit for c in hits.values())):
        fail(f"phase 13: cache {st} K2 {k2_cache} vs {k2_alone}")

    # Start the CLI processes now: their start-up overlaps (e) and (f).
    lines_n = 8
    p_sock = rest_cli("--serve_port", "-1", "--serve_cache", "0")
    p_abort = rest_cli(*DRAIN_ABORT_ARGS)
    p_wedge = rest_cli("--serve_retry_limit", "0", "--serve_rebuild_limit",
                       "0", "--fault_plan", "serve_wedge@req=0")
    procs = (p_sock, p_abort, p_wedge)
    try:
        # (e) chaos plan: captions bit-identical to a clean run.
        clean = decode_videos(engine(recover=True), range(16))
        runs = {}
        for name, plan, kw in (
                ("chaos", "serve_wedge@req=1,serve_garble@req=3,"
                          "admit_err@req=5", {}),
                ("rebuild", "serve_garble@req=2", {"retry_limit": 0})):
            eng = engine(recover=True, fault_plan=FaultPlan.parse(plan),
                         **kw)
            events0 = _cuda.library_events()
            reset_launch_counts()
            got = decode_videos(eng, range(16))
            torch.cuda.synchronize()
            total += launch_counts()["fused_decode_cell"]
            st = eng.stats()
            runs[name] = st
            same = all(np.array_equal(got[i].tokens, clean[i].tokens)
                       for i in range(16))
            loads = _cuda.library_events() - events0
            print(f"serving-rest {name} ({plan}): 16 captions bit-identical "
                  f"to the clean run: {same}; retries "
                  f"{st['chunk_retries']}, rebuilds {st['rebuilds']}, "
                  f"wedges {st['wedge_detected']}, garbles "
                  f"{st['garble_detected']}, admit errors "
                  f"{st['admit_errors']}, replay divergence "
                  f"{st['replay_divergence']}, library events {loads}")
            if not same or loads or st["rebuild_recompiles"] \
                    or st["replay_divergence"]:
                fail(f"phase 13 {name}: {st}")
        if (runs["chaos"]["chunk_retries"], runs["chaos"]["admit_errors"],
                runs["rebuild"]["rebuilds"]) != (2, 1, 1):
            fail(f"phase 13: the plans did not fire as planned: {runs}")
        eng = engine(recover=True, fault_plan=_AlwaysWedge(),
                     retry_limit=1, rebuild_limit=1)
        eng.submit(0, feats_for("v0"))
        try:
            eng.run_until_idle()
            fail("phase 13: a plan past the ladder did not raise")
        except ServingUnrecoverable as e:
            print(f"serving-rest ladder: ServingUnrecoverable after "
                  f"{eng.stats()['rebuilds']} rebuild(s): {e}")

        # (f) a deadline under one chunk; the other requests unaffected.
        eng = engine()
        replies, k2n, _ = rest_serve(
            model, vocab, feats_for, eng,
            [line(i, **({"deadline_ms": 0.5} if i == 5 else {}))
             for i in range(16)])
        total += k2n
        late = [r for r in replies if r["id"] == 5]
        rest = {r["video_id"]: r["caption"] for r in replies
                if r["id"] != 5 and "caption" in r}
        print(f"serving-rest deadline 0.5 ms: {late}; "
              f"{sum(rest[v] == greedy_caps[v] for v in rest)}/15 others "
              "equal to phase 4's")
        if (len(late) != 1 or late[0].get("error") != "expired"
                or len(rest) != 15
                or any(rest[v] != greedy_caps[v] for v in rest)):
            fail(f"phase 13: deadline {late}, others {len(rest)}")

        # (g) the CLI on an ephemeral port: 2 connections x 8 requests,
        # a health op, then SIGTERM under load.
        t_cli = time.perf_counter()
        sock_err, sock_wait = watch_stderr(p_sock)
        ready = sock_wait("listening on 127.0.0.1:", 120)
        if ready is None:
            fail("phase 13: the socket CLI never listened:\n"
                 + "\n".join(str(x) for x in sock_err[-20:]))
        port = int(ready.rsplit(":", 1)[1])
        conns = [socket.create_connection(("127.0.0.1", port), timeout=120)
                 for _ in range(2)]
        files = [c.makefile("r") for c in conns]
        for k, c in enumerate(conns):
            c.sendall("".join(line(i) for i in range(k * lines_n,
                                                     (k + 1) * lines_n))
                      .encode())
        got = {}
        for f in files:
            for _ in range(lines_n):
                r = json.loads(f.readline())
                got[r["video_id"]] = r.get("caption")
        conns[0].sendall(b'{"op": "health"}\n')
        health = json.loads(files[0].readline())
        # Under load: 16 more requests, each connection's followed by a
        # health op, whose reply says they were submitted; then the
        # signal.
        tail = []
        for k, c in enumerate(conns):
            c.sendall(("".join(line(100 + i, video_id=f"v{i}")
                               for i in range(k * lines_n,
                                              (k + 1) * lines_n))
                       + '{"op": "health"}\n').encode())
        for f in files:
            while True:
                r = json.loads(f.readline())
                if r.get("op") == "health":
                    break
                tail.append(r)
        p_sock.send_signal(signal.SIGTERM)
        tail += [json.loads(ln) for f in files for ln in f if ln.strip()]
        rc_sock = p_sock.wait(timeout=120)
        for c in conns:
            c.close()
        same = sum(got.get(v) == greedy_caps[v] for v in greedy_caps)
        answered = sorted(r["id"] for r in tail)
        print(f"serving-rest CLI socket: {same}/16 captions equal to phase "
              f"4's over 2 connections; health {health.get('status')}; "
              f"SIGTERM with 16 more sent: exit {rc_sock}, "
              f"{sum('caption' in r for r in tail)} completed and "
              f"{sum(r.get('error') == 'rejected_draining' for r in tail)} "
              f"rejected of {len(tail)}")
        if (same != 16 or health.get("op") != "health" or rc_sock != 75
                or answered != list(range(100, 116))
                or not all("caption" in r
                           or r.get("error") == "rejected_draining"
                           for r in tail)):
            fail(f"phase 13: socket CLI rc {rc_sock}, health {health}, "
                 f"answers {answered}\n" + "\n".join(
                     str(x) for x in sock_err[-20:]))
        total += cli_stats(sock_err).get("kernel_launches", {}).get(
            "fused_decode_cell", 0)

        # Two signals: the second aborts the drain, exit 143.
        d = drain_abort(p_abort, [line(i) for i in range(8)])
        if d["rc"] is not None:
            print(f"serving-rest CLI two signals: exit {d['rc']}; "
                  f"{d['aborted']}; {len(d['out'])} requests answered "
                  "rejected_draining")
        if d["why"] is not None:
            fail(f"phase 13: {d['why']}")
        total += cli_stats(d["err"]).get("kernel_launches", {}).get(
            "fused_decode_cell", 0)

        # A plan past the ladder: exit 124.
        wedge_out, wedge_err = p_wedge.communicate(
            "".join(line(i) for i in range(2)), timeout=120)
        stats = cli_stats(wedge_err.splitlines())
        print(f"serving-rest CLI past the ladder: exit {p_wedge.returncode};"
              f" wedges {stats.get('wedge_detected')}; " + "; ".join(
                  ln for ln in wedge_err.splitlines()
                  if "UNRECOVERABLE" in ln))
        if p_wedge.returncode != 124 or "UNRECOVERABLE" not in wedge_err:
            fail(f"phase 13: past the ladder exit {p_wedge.returncode}")
        total += stats.get("kernel_launches", {}).get("fused_decode_cell", 0)
        print(f"serving-rest CLI processes: "
              f"{time.perf_counter() - t_cli:.1f} s after (f)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t_phase
    print(f"serving-rest phase: {seconds:.1f} s (budget {REST_BUDGET_S:.0f} "
          f"s); K2 launches {total}")
    if total == 0:
        fail("phase 13: K2 never launched")
    return total

# Phase 14: the fleet, at phase 4's width and model, on K2.  The dead-fleet
# CLI process of (e) starts first, so its start-up overlaps (a)-(d).
FLEET_BUDGET_S = 90.0
FLEET_REPLICAS, FLEET_REQUESTS = 3, 32
LIFECYCLE_RUNS = ("off", "on", "off", "on")


def k2_f32_batch_invariance() -> None:
    """Phase 14a: float32 K2 gives a row the same bits alone (B = 1), in a
    batch of 4 and of 8, and moved to another index.  A re-queued request
    decodes again in another slot, maybe in another bucket, and its
    caption must not move.  Then the rollout's 1344 rows (the register
    tiles) against each row alone, moved, and sub-batches of 8, 40 (the
    weight stream) and 320 (the tiles).  Comparison launches: not
    counted."""
    import torch

    from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2

    gen = torch.Generator().manual_seed(2468)
    b = 8
    q, pm, mem, v = attention_inputs(b, gen)
    x = torch.randn(b, E, generator=gen).cuda()
    c = torch.randn(b, H, generator=gen).cuda()
    h = torch.tanh(torch.randn(b, H, generator=gen)).cuda()
    wg = (torch.randn(E + 2 * H, 4 * H, generator=gen) / (E + H) ** 0.5).cuda()
    bias = (0.1 * torch.randn(4 * H, generator=gen)).cuda()
    args = (x, c, h, q, pm, mem, v, wg, bias)
    full = k2.fused_decode_cell(*args)
    half = k2.fused_decode_cell(*(a[:4].contiguous() for a in args[:6]),
                                v, wg, bias)
    same4 = all(torch.equal(f[:4], g) for f, g in zip(full, half))
    moved_alone = bf16_batch_invariant(k2.fused_decode_cell, args, 6)
    alone = all(
        torch.equal(f[r:r + 1], g)
        for r in range(b)
        for f, g in zip(full, k2.fused_decode_cell(
            *(a[r:r + 1].contiguous() for a in args[:6]), v, wg, bias)))
    b = ROLLOUT_ROWS
    q, pm, mem, v = attention_inputs(b, gen)
    big = (torch.randn(b, E, generator=gen).cuda(),
           torch.randn(b, H, generator=gen).cuda(),
           torch.tanh(torch.randn(b, H, generator=gen)).cuda(), q, pm, mem,
           v, wg, bias)
    rollout = bf16_batch_invariant(k2.fused_decode_cell, big, 6,
                                   K2_INVARIANCE_SIZES)
    torch.cuda.synchronize()
    print(f"fleet K2 float32 batch invariance: B=1 (each of 8 rows alone) "
          f"{alone}, B=4 {same4}, B=8 moved to another index and alone "
          f"{moved_alone}; B={b} moved, rows alone and in batches of "
          f"{K2_INVARIANCE_SIZES} {rollout}")
    if not (alone and same4 and moved_alone and rollout):
        fail("phase 14: float32 K2 is not bitwise batch-invariant")


def fleet_cli(*extra):
    """The fleet CLI at phase 4's width and model, as a process."""
    return subprocess.Popen(
        [sys.executable, "-m", "cst_captioning_tpu_torch.serve_fleet",
         "--serve_demo", "1", "--serve_demo_eos_bias", EOS_BIAS,
         *WIDTH_ARGS, "--decode_kernel", "fused", "--beam_size", "1",
         *extra],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE))


def fleet_phase(greedy_caps, ref_caps) -> dict:
    """Phase 14: (a) float32 K2's batch invariance; (b) 3 replicas on one
    card serving 32 greedy requests through ``CaptionServer``, and 2
    replicas on the reference cell with K1; (c) a replica killed mid-run;
    (d) a replica-targeted wedge past the ladder, restarted; (e) the fleet
    CLI with every replica spent: exit 124 and a blackbox; (f) greedy
    serving with the lifecycle tracer on and off; (g) the bench's fleet
    record.  (b)-(d) run with the lock sanitizer armed.  -> {"K1", "K2"
    float32 launches, "K2_bf16" the bench's}."""
    import tempfile

    import torch

    from cst_captioning_tpu_torch import serve
    from cst_captioning_tpu_torch.ops import _cuda, launch_counts, \
        reset_launch_counts
    from cst_captioning_tpu_torch.resilience.faults import FaultPlan
    from cst_captioning_tpu_torch.serving.engine import ServingEngine
    from cst_captioning_tpu_torch.serving.fleet import FleetRouter
    from cst_captioning_tpu_torch.serving.server import CaptionServer
    from cst_captioning_tpu_torch.telemetry.lifecycle import LifecycleTracer
    from cst_captioning_tpu_torch.telemetry.spans import SpanTracer
    from cst_captioning_tpu_torch.utils import locksan

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    box = os.path.join(tmp, "dead_blackbox.json")
    p_dead = fleet_cli("--serve_replicas", "2", "--serve_restart_limit",
                       "0", "--serve_retry_limit", "0",
                       "--serve_rebuild_limit", "0", "--serve_cache", "0",
                       "--fault_plan",
                       "serve_wedge@replica=0,serve_wedge@replica=1",
                       "--serve_blackbox", box)
    total = {"K1": 0, "K2": 0, "K2_bf16": 0}
    try:
        k2_f32_batch_invariance()

        os.environ[locksan.ENV_FLAG] = "1"
        os.environ[locksan.ENV_RECEIPT] = os.path.join(tmp, "locksan.json")
        violations0 = len(locksan.violations())

        def backend(*extra):
            opt = serve.parse_args(["--serve_demo", "1",
                                    "--serve_demo_eos_bias", EOS_BIAS,
                                    "--beam_size", "1"]
                                   + WIDTH_ARGS + list(extra))
            return (opt,) + serve.build_backend(opt)

        opt, model, vocab, feat_shapes, feats_for = backend(
            "--decode_kernel", "fused")

        def router(n, mdl=model, plan=None, lifecycle=None, **kw):
            def factory(k):
                return ServingEngine(
                    mdl, feat_shapes,
                    **{**serve.engine_kwargs(opt), "queue_limit": 0, **kw},
                    fault_plan=plan.for_replica(k) if plan else None,
                    lifecycle=(lifecycle.for_replica(k) if lifecycle
                               else None))
            fleet = FleetRouter(factory, n, lifecycle=lifecycle)
            fleet.warm()
            return fleet

        def line(i):
            return json.dumps({"id": i, "video_id": f"v{i % 16}"}) + "\n"

        def serve_fleet(fleet, n, lifecycle=None, after_step=None):
            """Serve ``n`` requests through ``CaptionServer`` on ``fleet``
            -> ({id: caption}, seconds, K2 and K1 launches)."""
            if after_step is not None:
                real = fleet.step

                def step():
                    done = real()
                    after_step(fleet)
                    return done

                fleet.step = step
            out = io.StringIO()
            reset_launch_counts()
            t0 = time.perf_counter()
            rc = CaptionServer(fleet, vocab, feats_for, out=out,
                               health_source=fleet.health,
                               lifecycle=lifecycle).run_stdin(
                lines=[line(i) for i in range(n)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = launch_counts()
            if rc != 0:
                fail(f"phase 14: fleet server exited {rc}")
            replies = [json.loads(ln) for ln in out.getvalue().splitlines()]
            caps = {r["id"]: r.get("caption") for r in replies}
            if sorted(caps) != list(range(n)):
                fail(f"phase 14: answered {sorted(caps)}")
            return (caps, seconds, launches["fused_decode_cell"],
                    launches["fused_additive_attention"])

        def equal_to(caps, want):
            return sum(caps[i] == want[f"v{i % 16}"] for i in caps)

        # (b) 3 replicas on one card, 32 greedy requests.
        lc = LifecycleTracer()
        fleet = router(FLEET_REPLICAS, lifecycle=lc)
        caps, secs, k2n, _ = serve_fleet(fleet, FLEET_REQUESTS, lc)
        st = fleet.stats()
        check_launches("fleet 3 replicas", "K2", k2n, st["decode_steps"], 2)
        total["K2"] += k2n
        routed = {}
        for ev in lc.events():
            if ev["kind"] == "routed":
                routed[ev["replica"]] = routed.get(ev["replica"], 0) + 1
        same = equal_to(caps, greedy_caps)
        print(f"fleet {FLEET_REPLICAS} replicas on one card (replicas "
              f"share one card): {FLEET_REQUESTS} requests in {secs:.4f} s "
              f"= {FLEET_REQUESTS / secs:.3f} captions/s; {same}/"
              f"{FLEET_REQUESTS} captions equal to phase 4's; routed per "
              f"replica {dict(sorted(routed.items()))}; completed per "
              f"replica {[p['completed'] for p in st['per_replica']]}; "
              f"latency p50={st['latency_p50_ms']:.3f} ms "
              f"p99={st['latency_p99_ms']:.3f} ms; K2 launches {k2n} in "
              f"{st['decode_steps']} decode steps; accounting "
              f"{lc.accounting()['terminal_ok']}")
        if same != FLEET_REQUESTS or not lc.accounting()["terminal_ok"]:
            fail("phase 14 (b): fleet captions differ from phase 4's")

        # (b') 2 replicas on the reference cell, attention on K1.
        r_opt, r_model, _, _, _ = backend("--decode_kernel", "reference",
                                          "--pallas_attention", "1")
        k1_fleet = router(2, mdl=r_model)
        caps, secs, _, k1n = serve_fleet(k1_fleet, 16)
        st = k1_fleet.stats()
        check_launches("fleet reference-k1", "K1", k1n, st["decode_steps"],
                       1)
        total["K1"] += k1n
        same = equal_to(caps, ref_caps)
        print(f"fleet 2 replicas on the reference cell with K1 (replicas "
              f"share one card): 16 requests in {secs:.4f} s; {same}/16 "
              f"captions equal to phase 6's; K1 launches {k1n} in "
              f"{st['decode_steps']} decode steps")
        if same != 16:
            fail("phase 14 (b'): K1 fleet captions differ from phase 6's")
        del k1_fleet, r_model

        # (c) kill replica 1 once half the requests are in.
        lc = LifecycleTracer()
        fleet = router(FLEET_REPLICAS, lifecycle=lc)
        killed = []

        def kill_once(f):
            eng = f._replicas[1].engine
            if not killed and f.fleet_counters()["fleet_routed"] >= \
                    FLEET_REQUESTS // 2 and eng.resident_count:
                killed.extend(r.request_id for r in eng.resident_requests())
                f.kill_replica(1)

        events0 = _cuda.library_events()
        caps, secs, k2n, _ = serve_fleet(fleet, FLEET_REQUESTS, lc,
                                         after_step=kill_once)
        loads = _cuda.library_events() - events0
        st = fleet.stats()
        check_launches("fleet kill", "K2", k2n, st["decode_steps"], 2)
        total["K2"] += k2n
        chains = {}
        for ev in lc.events():
            chains.setdefault(ev["id"], []).append(ev["kind"])
        chain_ok = bool(killed) and all(
            chains[r].index("killed") < chains[r].index("requeued")
            < chains[r].index("responded") for r in killed)
        same = equal_to(caps, greedy_caps)
        fc = st["fleet"]
        print(f"fleet kill_replica(1): {len(killed)} resident(s) killed; "
              f"{same}/{FLEET_REQUESTS} captions bit-identical to phase "
              f"4's; kills {fc['fleet_replica_kills']}, restarts "
              f"{fc['fleet_replica_restarts']}, rerouted "
              f"{fc['fleet_rerouted']}; library events {loads}; "
              f"killed -> requeued -> responded {chain_ok}; requeue p99 "
              f"{lc.attribution_report()['components']['requeue']['p99_ms']}"
              f" ms; {secs:.4f} s")
        if (same != FLEET_REQUESTS or loads or not chain_ok
                or (fc["fleet_replica_kills"],
                    fc["fleet_replica_restarts"]) != (1, 1)):
            fail(f"phase 14 (c): {fc}, loads {loads}, chains {chain_ok}")

        # (d) a replica-targeted wedge past the ladder: an in-process 124,
        # taken as a restart.
        fleet = router(2, plan=FaultPlan.parse("serve_wedge@replica=0"),
                       retry_limit=0, rebuild_limit=0)
        caps, secs, k2n, _ = serve_fleet(fleet, 16)
        st = fleet.stats()
        check_launches("fleet wedge", "K2", k2n, st["decode_steps"], 2)
        total["K2"] += k2n
        same = equal_to(caps, greedy_caps)
        fc = st["fleet"]
        print(f"fleet serve_wedge@replica=0, ladder 0/0: restarts "
              f"{fc['fleet_replica_restarts']}, kills "
              f"{fc['fleet_replica_kills']}; {same}/16 captions "
              f"bit-identical to phase 4's")
        if same != 16 or fc["fleet_replica_restarts"] != 1:
            fail(f"phase 14 (d): {fc}")
        del fleet

        found = locksan.violations()[violations0:]
        print(f"fleet lock sanitizer: {len(found)} violations")
        if found or os.path.exists(os.environ[locksan.ENV_RECEIPT]):
            fail(f"phase 14: lock-order violations {found}")
        del os.environ[locksan.ENV_FLAG]

        # (e) every replica spent: exit 124 with a blackbox.
        out, err = p_dead.communicate(
            "".join(line(i) for i in range(4)), timeout=120)
        doc = json.load(open(box)) if os.path.exists(box) else {}
        stats = [ln for ln in err.splitlines()
                 if ln.startswith("serve_fleet: {")]
        print(f"fleet CLI, every replica spent: exit {p_dead.returncode}; "
              + "; ".join(ln for ln in err.splitlines()
                          if "UNRECOVERABLE" in ln or "blackbox" in ln)
              + f"; blackbox {doc.get('events_retained')} events, "
              f"replicas {[p['status'] for p in doc.get('health', {}).get('per_replica', [])]}")
        if p_dead.returncode != 124 or doc.get("reason") != "unrecoverable":
            fail(f"phase 14 (e): exit {p_dead.returncode}\n" + err[-3000:])
        # Its wedges fire before any chunk launches: it runs no kernel.
        if not stats or json.loads(stats[-1][len("serve_fleet: "):])[
                "decode_steps"]:
            fail(f"phase 14 (e): stats {stats}")

        # (f) greedy serving, one engine, the lifecycle tracer on and off.
        lines16 = [line(i) for i in range(16)]
        for run in LIFECYCLE_RUNS:
            lc = tracer = None
            trace_dir = os.path.join(tmp, f"trace_{run}_{time.time_ns()}")
            if run == "on":
                tracer = SpanTracer(trace_dir)
                lc = LifecycleTracer(tracer=tracer)
            eng = ServingEngine(model, feat_shapes, **serve.engine_kwargs(
                opt), tracer=tracer, lifecycle=lc)
            out = io.StringIO()
            server = CaptionServer(eng, vocab, feats_for, out=out,
                                   lifecycle=lc, blackbox_path=os.path.join(
                                       tmp, "box.json"))
            reset_launch_counts()
            t0 = time.perf_counter()
            rc = server.run_stdin(lines=lines16)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            k2n = launch_counts()["fused_decode_cell"]
            st = eng.stats()
            check_launches(f"lifecycle {run}", "K2", k2n, st["decode_steps"],
                           2)
            total["K2"] += k2n
            caps = {json.loads(r)["id"]: json.loads(r).get("caption")
                    for r in out.getvalue().splitlines()}
            extra = ""
            if run == "on":
                replies = []
                server._handle_line('{"op": "dump"}',
                                    lambda s: replies.append(json.loads(s)))
                tracer.close()
                parts = os.listdir(trace_dir)
                extra = (f"; dump op {replies[0]}; trace parts {len(parts)} "
                         f"({sum(os.path.getsize(os.path.join(trace_dir, p)) for p in parts)} bytes); "
                         f"attribution reconciled "
                         f"{st['attribution']['reconcile_ok']}")
                if not parts or replies[0].get("events", 0) == 0:
                    fail(f"phase 14 (f): {replies}, parts {parts}")
            print(f"fleet lifecycle {run}: 16 requests in {secs:.4f} s = "
                  f"{16 / secs:.3f} req/s; latency p50="
                  f"{st['latency_p50_ms']:.3f} ms p99="
                  f"{st['latency_p99_ms']:.3f} ms" + extra)
            if rc != 0 or equal_to(caps, greedy_caps) != 16:
                fail(f"phase 14 (f) lifecycle {run}: captions differ")

        # (g) the bench's fleet record.
        rec = run_bench(
            "serving fleet", "--stage", "serving", "--replicas",
            str(FLEET_REPLICAS), "--serve_kill_replica", "1",
            "--serve_trace", "1", "--serve_blackbox",
            os.path.join(tmp, "bench_box.json"), "--serve_buckets",
            ",".join(map(str, BENCH_BUCKETS)), "--probe_eos_bias", "0",
            phase="phase 14")
        fl, lcr = rec.get("fleet", {}), rec.get("lifecycle", {})
        print(f"fleet bench: {rec['value']} captions/s ({FLEET_REPLICAS} "
              f"replicas share one card: {rec.get('replicas_share_device')})"
              f"; parity_ok {fl.get('parity_ok')}; kills "
              f"{fl.get('fleet_replica_kills')}; accounting "
              f"{lcr.get('terminal_ok')}; attribution reconciled "
              f"{rec.get('attribution', {}).get('reconcile_ok')}")
        if not (fl.get("parity_ok") and lcr.get("terminal_ok")
                and rec.get("attribution", {}).get("reconcile_ok")
                and fl.get("fleet_replica_kills") == 1
                and rec["launches"]["fused_decode_cell"] > 0):
            fail(f"phase 14 (g): {rec}")
        total["K2_bf16"] += rec["launches"]["fused_decode_cell"]
    finally:
        os.environ.pop(locksan.ENV_FLAG, None)
        if p_dead.poll() is None:
            p_dead.kill()
            p_dead.wait()
    seconds = time.perf_counter() - t_phase
    print(f"fleet phase: {seconds:.1f} s (budget {FLEET_BUDGET_S:.0f} s); "
          f"launches {total}")
    if not (total["K1"] and total["K2"]):
        fail(f"phase 14: a kernel never launched: {total}")
    return total


PROC_BUDGET_S = 150.0
PROC_REPLICAS, PROC_REQUESTS = 3, 32
PROC_ROOT = os.path.join(HERE, "checkpoints", "chip_smoke_procs")
PROC_WEDGE_TIMEOUT = "20"
_LISTEN = re.compile(r"serve: listening on 127\.0\.0\.1:(\d+)")


def supervisor_cli(root: str, *extra, stdin=None):
    """The process-fleet CLI at phase 4's width and model, in a process
    group of its own (one ``killpg`` reaches it and its children), with
    the lock sanitizer armed in it and every child; stdout and stderr go
    to files in ``root``.  A group, not a session: a session leader's
    group is orphaned, and when a process of an orphaned group that holds
    a stopped process (the wedge drill's SIGSTOP) exits, the kernel sends
    the whole group SIGHUP and SIGCONT."""
    os.makedirs(root, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=HERE, CST_LOCK_SANITIZER="1",
               CST_LOCK_SANITIZER_RECEIPT=os.path.join(root, "locksan.json"))
    with open(os.path.join(root, "stdout.txt"), "w") as out, \
            open(os.path.join(root, "stderr.txt"), "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "cst_captioning_tpu_torch.serve_supervisor",
             "--serve_demo", "1", "--serve_demo_eos_bias", EOS_BIAS,
             *WIDTH_ARGS, "--beam_size", "1", "--supervise_dir", root,
             *extra],
            stdin=subprocess.PIPE if stdin is not None else subprocess.DEVNULL,
            stdout=out, stderr=err, text=True, cwd=HERE, env=env,
            process_group=0)


def reap_fleet_processes() -> list:
    """SIGKILL every process of this phase: each supervisor's group, and
    any process whose command line names ``PROC_ROOT`` (the journal
    drill's inner supervisors lead sessions of their own).  -> the pids
    found still running."""
    import signal

    found = []
    me = os.getpid()
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == me:
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if PROC_ROOT in cmd:
            found.append(int(pid))
            try:
                os.kill(int(pid), signal.SIGKILL)
            except OSError:
                pass
    return found


def wait_listening(proc, root: str, timeout_s: float = 300.0) -> int:
    """The supervisor's port, from its ``serve: listening on`` line."""
    path = os.path.join(root, "stderr.txt")
    end = time.monotonic() + timeout_s
    while time.monotonic() < end:
        with open(path) as f:
            m = _LISTEN.search(f.read())
        if m:
            return int(m.group(1))
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    fail(f"phase 15: the supervisor in {root} never listened (exit "
         f"{proc.poll()}):\n" + open(path).read()[-3000:])


def finish(proc, root: str, timeout_s: float) -> int:
    try:
        return proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        fail(f"phase 15: {root} ran past {timeout_s:.0f} s:\n"
             + open(os.path.join(root, "stderr.txt")).read()[-3000:])


def child_results(root: str) -> list:
    """The exit stats of every child that exited cleanly under ``root``
    (``replica<K>/result.json``, ``reference/result.json``)."""
    out = []
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name, "result.json")
        if os.path.exists(path):
            with open(path) as f:
                out.append((name, json.load(f)["stats"]))
    return out


def child_launches(run: str, root: str, kernel: str) -> int:
    """Sum a kernel's launches over the children's exit stats under
    ``root``, each held to its count per decode step (K2 twice, K1
    once)."""
    key, per = {"K2": ("fused_decode_cell", 2),
                "K1": ("fused_additive_attention", 1)}[kernel]
    total = 0
    for name, st in child_results(root):
        n = st["kernel_launches"][key]
        if n or st["decode_steps"]:     # a restarted child may serve none
            check_launches(f"phase 15 {run} {name}", kernel, n,
                           st["decode_steps"], per)
        total += n
    return total


def socket_serve(port: int, conns: int, n: int, video=lambda i: f"v{i % 16}"):
    """``n`` greedy requests over ``conns`` connections to a supervisor;
    -> ({id: reply}, seconds from the first send to the last answer)."""
    import socket

    socks = [socket.create_connection(("127.0.0.1", port), timeout=300)
             for _ in range(conns)]
    files = [s.makefile("r", encoding="utf-8") for s in socks]
    t0 = time.perf_counter()
    for i in range(n):
        socks[i % conns].sendall((json.dumps(
            {"id": i, "video_id": video(i)}) + "\n").encode())
    replies = {}
    for k, f in enumerate(files):
        want = len(range(k, n, conns))
        while sum(1 for i in replies if i % conns == k) < want:
            r = json.loads(f.readline())
            replies[r["id"]] = r
    seconds = time.perf_counter() - t0
    socks[0].sendall(b'{"op": "stats"}\n')
    stats = json.loads(files[0].readline())
    for s in socks:
        s.close()
    return replies, seconds, stats


def stop_supervisor(proc, root: str) -> dict:
    """SIGTERM: the children drain and exit 75, then the supervisor does.
    -> its exit snapshot."""
    import signal

    os.kill(proc.pid, signal.SIGTERM)
    rc = finish(proc, root, 120)
    if rc != 75:
        fail(f"phase 15: SIGTERM gave exit {rc}, 75 expected")
    with open(os.path.join(root, "supervisor_exit.json")) as f:
        return json.load(f)


def record_of(root: str) -> dict:
    lines = open(os.path.join(root, "stdout.txt")).read().splitlines()
    return json.loads(lines[-1]) if lines else {}


def fleet_plane_checks(root: str, rec: dict) -> str:
    """Phase 15 (f) over the kill probe's directory."""
    rows = [json.loads(ln) for ln in open(
        os.path.join(root, "fleet_metrics.jsonl"))]
    interval = rows[0]["interval_ms"] / 1e3
    gaps = [b["wall"] - a["wall"] for a, b in zip(rows, rows[1:])]
    covered = all(len(r["children"]) == r["fleet"]["replicas"]
                  and {c["index"] for c in r["children"]}
                  == set(range(r["fleet"]["replicas"])) for r in rows)
    sync = json.load(open(os.path.join(root, "clock_sync.json")))
    pids = len(sync["children"])
    want_pids = PROC_REPLICAS + rec["supervisor"]["restarts"]
    traces = {d: len([n for n in os.listdir(os.path.join(root, d))
                      if n.endswith(".json")])
              for d in ["trace"] + [f"replica{k}/trace"
                                    for k in range(PROC_REPLICAS)]
              if os.path.isdir(os.path.join(root, d))}
    alerts = os.path.join(root, "slo_alerts.jsonl")
    n_alerts = (len(open(alerts).read().splitlines())
                if os.path.exists(alerts) else 0)
    line = (f"{len(rows)} samples, every replica slot in every row "
            f"{covered}, largest gap {max(gaps):.3f} s (limit "
            f"{3 * interval:.3f} s); clock_sync {pids} child pids "
            f"({want_pids} expected); trace parts {traces}; SLO alerts "
            f"{n_alerts}")
    if not (covered and max(gaps) <= 3 * interval and pids == want_pids
            and len(traces) == PROC_REPLICAS + 1 and all(traces.values())
            and n_alerts == 0 and rec["slo"]["alerts_fired"] == 0):
        fail(f"phase 15 (f): {line}")
    return line


def concurrent_probes(root, runs: dict) -> dict:
    """Phase 15's probes started at once, each in ``root(name)`` and
    under ``runs[name]``: (b) the kill probe, (c) a wedge and a preempt
    over 24 streams, (d) the journal probe, (e) the autoscale probe, (g)
    every replica dead.  -> their exits, once all have ended."""
    fused = ("--decode_kernel", "fused")
    runs["b"] = supervisor_cli(
        root("b"), *fused, "--supervise_probe", "1",
        "--supervise_replicas", str(PROC_REPLICAS),
        "--slo_p99_ms", "60000", "--slo_availability", "0.5")
    runs["c"] = supervisor_cli(
        root("c"), *fused, "--supervise_replicas", str(PROC_REPLICAS),
        "--fault_plan", "proc_wedge@replica=0,proc_preempt@replica=2",
        "--wedge_timeout", PROC_WEDGE_TIMEOUT, stdin=True)
    runs["d"] = supervisor_cli(
        root("d"), *fused, "--journal_probe", "1",
        "--supervise_replicas", "2")
    runs["e"] = supervisor_cli(
        root("e"), *fused, "--autoscale_probe", "1", "--autoscale_min",
        "1", "--autoscale_max", "3", "--autoscale_up_cooldown_s", "1",
        "--autoscale_down_cooldown_s", "1", "--fleet_scrape_ms", "200",
        "--autoscale_queue_hi_ms", "10", "--serve_cache", "0")
    runs["g"] = supervisor_cli(
        root("g"), *fused, "--supervise_replicas", "2",
        "--supervise_restart_limit", "0", "--serve_recover", "0",
        "--fault_plan", "serve_wedge@replica=0,serve_wedge@replica=1",
        stdin=True)
    c_lines = [json.dumps({"id": i, "video_id": f"v{i % 16}",
                           "op": "stream"}) + "\n" for i in range(24)]
    runs["c"].stdin.write("".join(c_lines))
    runs["c"].stdin.close()
    runs["g"].stdin.write("".join(
        json.dumps({"id": i, "video_id": f"v{i}"}) + "\n"
        for i in range(4)))
    runs["g"].stdin.close()
    return {k: finish(runs[k], root(k), 420) for k in "bcdeg"}


def kill_probe(path: str, rc: int, greedy_caps) -> tuple:
    """Phase 15 (b), the kill probe (``proc_kill@replica=1``), read from
    its directory ``path``; a failed probe's stderr is the evidence: its
    tail is printed before anything else is read.  -> (its record, the
    reading, whether it passed)."""
    if rc != 0:
        print(f"process fleet (b) exited {rc}; the tail of its stderr:\n"
              + open(os.path.join(path, "stderr.txt")).read()[-6000:])
    rec = record_of(path)
    sup = rec.get("supervisor", {})
    incidents = os.path.join(path, "incidents")
    inc = [d for d in (os.listdir(incidents)
                       if os.path.isdir(incidents) else [])
           if re.fullmatch(r"\d{3}_replica1_rc137", d)]
    bb = bool(inc) and os.path.exists(os.path.join(
        path, "incidents", inc[0], "blackbox.json"))
    caps = sup.get("captions", {})
    same = sum(caps[v] == greedy_caps[v] for v in caps)
    reading = (
        f"process fleet (b) proc_kill@replica=1: exit {rc}; "
        f"{rec.get('completed')}/{rec.get('num_requests')} answered "
        f"once, {same}/{len(caps)} captions equal to phase 4's, parity "
        f"with the single-engine child {sup.get('parity_ok')}, prefix "
        f"{rec.get('stream')}; restarts {sup.get('restarts')}, requeued "
        f"{sup.get('requeued')}; incident {inc} blackbox {bb}; "
        f"recompiles after warm-up {rec.get('recompiles_after_warmup')}, "
        f"nvcc builds per live child {sup.get('library_builds')}")
    ok = (rc == 0 and bb and same == 16
          and rec.get("recompiles_after_warmup") == 0
          and sup.get("restarts") == 1
          and not any((sup.get("library_builds") or {"?": 1}).values()))
    return rec, reading, ok


def process_fleet_phase(greedy_caps, ref_caps) -> dict:
    """Phase 15: the process fleet, ``python -m
    cst_captioning_tpu_torch.serve_supervisor`` at phase 4's width and
    model.  (a) 3 children serve 32 greedy requests over 2 connections,
    timed alone on the card; (a') 2 children on the reference cell with K1
    serve 16; then, all at once: (b) the kill probe, (c) a wedge and a
    preempt, (d) the journal probe, (e) the autoscale probe, (g) every
    replica dead; (f) the fleet plane over (b).  -> {"K1", "K2"} float32
    launches read from the children's exit stats."""
    import shutil

    t_phase = time.perf_counter()
    shutil.rmtree(PROC_ROOT, ignore_errors=True)
    runs = {}
    total = {"K1": 0, "K2": 0}

    def root(name):
        return os.path.join(PROC_ROOT, name)

    def equal_to(caps, want):
        return sum(caps[v] == want[v] for v in caps)

    try:
        # (a) plain serving, 3 children sharing the card.
        # No result cache, as in phases 4 and 14: every request decodes.
        p = runs["a"] = supervisor_cli(
            root("a"), "--decode_kernel", "fused", "--supervise_replicas",
            str(PROC_REPLICAS), "--serve_port", "-1", "--serve_cache", "0")
        port = wait_listening(p, root("a"))
        socket_serve(port, PROC_REPLICAS, 2 * PROC_REPLICAS,
                     video=lambda i: f"v{i}")          # warm-up, two each
        replies, secs, st = socket_serve(port, 2, PROC_REQUESTS)
        lat = sorted(r["latency_ms"] for r in replies.values())
        p50, p99 = (lat[min(len(lat) - 1, round(q * (len(lat) - 1)))]
                    for q in (0.5, 0.99))
        exit_doc = stop_supervisor(p, root("a"))
        caps = {f"v{i % 16}": r.get("caption") for i, r in replies.items()}
        same = sum(r.get("caption") == greedy_caps[f"v{i % 16}"]
                   for i, r in replies.items())
        k2n = child_launches("a", root("a"), "K2")
        total["K2"] += k2n
        per = {s["replica"]: s["completed"] for s in st["per_replica"]}
        print(f"process fleet (a): {PROC_REPLICAS} processes sharing one "
              f"card ({card_line()}): {PROC_REQUESTS} requests over 2 "
              f"connections in {secs:.4f} s = {PROC_REQUESTS / secs:.3f} "
              f"captions/s; latency p50={p50} ms p99={p99} ms "
              f"(supervisor intake to answer); completed per child "
              f"{per}; routed {st['supervisor']['sup_routed']}; "
              f"{same}/{PROC_REQUESTS} captions equal to phase 4's; K2 "
              f"launches {k2n}; parent CUDA context "
              f"{exit_doc['parent_cuda_initialized']}")
        if (same != PROC_REQUESTS or len(caps) != 16
                or exit_doc["parent_cuda_initialized"]):
            fail("phase 15 (a): captions differ from phase 4's or the "
                 "supervisor created a CUDA context")

        # (a') the reference cell with K1, 2 children.
        p = runs["a2"] = supervisor_cli(
            root("a2"), "--decode_kernel", "reference",
            "--pallas_attention", "1", "--supervise_replicas", "2",
            "--serve_port", "-1")
        port = wait_listening(p, root("a2"))
        replies, secs, st = socket_serve(port, 1, 16,
                                         video=lambda i: f"v{i}")
        stop_supervisor(p, root("a2"))
        same = sum(r.get("caption") == ref_caps[f"v{i}"]
                   for i, r in replies.items())
        k1n = child_launches("a'", root("a2"), "K1")
        total["K1"] += k1n
        print(f"process fleet (a'): 2 processes on the reference cell with "
              f"K1 (sharing one card): 16 requests in {secs:.4f} s; "
              f"{same}/16 captions equal to phase 6's; K1 launches {k1n}")
        if same != 16:
            fail("phase 15 (a'): captions differ from phase 6's")

        # (b)-(g) at once: none of them is timed.
        t_conc = time.perf_counter()
        rcs = concurrent_probes(root, runs)
        print(f"process fleet (b)-(g) together: {time.perf_counter() - t_conc:.1f} s; "
              f"exits {rcs}")

        # (b) the kill probe.
        rec, reading, ok = kill_probe(root("b"), rcs["b"], greedy_caps)
        print(reading)
        if not ok:
            fail(f"phase 15 (b): {rec}")

        # (f) the fleet plane over (b).
        print("process fleet (f): " + fleet_plane_checks(root("b"), rec))

        # (c) the wedge and the preempt.
        answers = {}
        for ln in open(os.path.join(root("c"), "stdout.txt")):
            r = json.loads(ln)
            answers.setdefault(r["id"], []).append(r)
        doc = json.load(open(os.path.join(root("c"), "supervisor_exit.json")))
        incs = [(i["replica"], i["rc"], i["classification"])
                for i in doc["stats"]["incidents"]]
        ok_c = sum(
            1 for i, rs in answers.items()
            if [r.get("caption") for r in rs if r.get("final")]
            == [greedy_caps[f"v{i % 16}"]]
            and " ".join(r["text"] for r in rs
                         if not r.get("final") and r["text"])
            == greedy_caps[f"v{i % 16}"])
        c = doc["stats"]["supervisor"]
        print(f"process fleet (c) proc_wedge@replica=0 (SIGSTOP, killed "
              f"from outside after {PROC_WEDGE_TIMEOUT} s), "
              f"proc_preempt@replica=2: exit {rcs['c']}; incidents {incs}; "
              f"wedge kills {c['sup_wedge_kills']}, requeued "
              f"{c['sup_requeued']}, restarts {c['sup_replica_restarts']}; "
              f"{ok_c}/24 streams answered once, prefix-consistent and "
              f"equal to phase 4's")
        if (rcs["c"] != 0 or ok_c != 24 or len(answers) != 24
                or (0, 124, "wedge") not in incs
                or (2, 75, "resumable") not in incs
                or c["sup_wedge_kills"] != 1):
            fail(f"phase 15 (c): {doc['stats']}")

        # (d) the journal probe.
        rec = record_of(root("d"))
        j = rec.get("journal", {})
        same = equal_to(rec.get("supervisor", {}).get("captions", {}),
                        greedy_caps)
        print(f"process fleet (d) journal probe: exit {rcs['d']}; "
              f"{ {k: j.get(k) for k in ('killed_mid_storm', 'terminals_before_kill', 'streams_in_flight_at_kill', 'replayed', 'recovered_terminals', 'replay_accounted', 'exactly_once', 'dup_suppressed', 'torn_records', 'clean_exit')} }"
              f"; prefix {rec.get('stream')}; {same}/6 captions equal to "
              f"phase 4's")
        if rcs["d"] != 0 or same != 6:
            fail(f"phase 15 (d): {rec}")

        # (e) the autoscale probe.
        rec = record_of(root("e"))
        a = rec.get("autoscale", {})
        caps = rec.get("supervisor", {}).get("captions", {})
        same = equal_to(caps, greedy_caps)
        print(f"process fleet (e) autoscale probe: exit {rcs['e']}; "
              f"{rec.get('num_requests')} requests, scale ups "
              f"{a.get('scale_ups')} (after {a.get('scale_up_intervals')} "
              f"scrape intervals) and downs {a.get('scale_downs')}, back "
              f"to the floor {a.get('scaled_down')}; {same}/{len(caps)} "
              f"captions equal to phase 4's; recompiles after warm-up "
              f"{rec.get('recompiles_after_warmup')}")
        if rcs["e"] != 0 or not caps or same != len(caps):
            fail(f"phase 15 (e): {rec}")

        # (g) every replica dead.
        doc = json.load(open(os.path.join(root("g"), "supervisor_exit.json")))
        box = json.load(open(os.path.join(root("g"), "blackbox.json")))
        dead = [p["status"] for p in box["health"]["per_replica"]]
        incs = sorted(os.listdir(os.path.join(root("g"), "incidents")))
        print(f"process fleet (g) every replica dead: exit {rcs['g']}; "
              f"incidents {incs}; blackbox ({box['reason']}) replicas "
              f"{dead}")
        if (rcs["g"] != 124 or dead != ["dead", "dead"] or len(incs) != 2
                or doc["stats"]["supervisor"]["sup_replica_deaths"] != 2):
            fail(f"phase 15 (g): {doc['stats']}")

        receipts = [k for k in runs
                    if os.path.exists(os.path.join(root(k), "locksan.json"))]
        print(f"process fleet lock sanitizer: {len(receipts)} processes "
              f"with violations")
        if receipts:
            fail(f"phase 15: lock-order violations in {receipts}")
        for k in "bcde":
            total["K2"] += child_launches(k, root(k), "K2")
    finally:
        for p in runs.values():
            if p.poll() is None:
                try:
                    os.killpg(p.pid, 9)
                except OSError:
                    pass
                p.wait()
        time.sleep(0.5)
        left = reap_fleet_processes()
    print(f"process fleet: processes left running after the phase: "
          f"{len(left)}")
    if left:
        fail(f"phase 15: {len(left)} processes outlived their run: {left}")
    seconds = time.perf_counter() - t_phase
    print(f"process fleet phase: {seconds:.1f} s (budget "
          f"{PROC_BUDGET_S:.0f} s); launches {total}")
    if not (total["K1"] and total["K2"]):
        fail(f"phase 15: a kernel never launched: {total}")
    return total


# Phase 16: the model variants at phase 7's width and split.  Checkpoints
# go here and are removed at the phase's end.
VARIANT_ROOT = os.path.join(HERE, "checkpoints", "chip_smoke_variants")
# The transformer at MSR-VTT's width (8 heads, 2 layers); manet's
# memory: one token per feature stream.
TX_ARGS = ("--model_type", "transformer", "--num_heads", "8",
           "--num_tx_layers", "2", "--pallas_attention", "0",
           "--decode_kernel", "reference")
T_MANET = 2
VARIANTS_BUDGET_S = 150.0
# Prefix decode against the full-buffer decode on the card: logits within
# this share of max(1, max|logit|) (two GEMM shapes, one function).
PREFIX_TOL = 1e-4


def variant_kernel_checks() -> dict:
    """Phase 16 (b), the kernels at manet's few time steps: K1 at B = 1, 8,
    1280 and K2 at B = 1, 8, 1344, float32 and bfloat16, each against its
    plain version at T = 1, 2 and 3 (the float32 and bfloat16 tolerances
    of phases 3 and 8); at T = 2 timed and bounded as in phases 3 and 8
    (K1's gradients at 1280 too), and both bitwise batch-invariant at B =
    40.  -> {storage: {kernel: {"T2/<B>": measurement}}}."""
    import torch

    from cst_captioning_tpu_torch.ops import attention_kernel as k1
    from cst_captioning_tpu_torch.ops import decode_cell_kernel as k2

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator().manual_seed(1616)
    out = {"float32": {"K1": {}, "K2": {}}, "bfloat16": {"K1": {}, "K2": {}}}

    def k2_args(b, attn):
        q, pm, mem, v = attn
        x = torch.randn(b, E, generator=gen).cuda()
        c = torch.randn(b, H, generator=gen).cuda()
        h = torch.tanh(torch.randn(b, H, generator=gen)).cuda()
        wg = (torch.randn(E + 2 * H, 4 * H, generator=gen)
              / (E + H) ** 0.5).cuda()
        bias = (0.1 * torch.randn(4 * H, generator=gen)).cuda()
        return (x, c, h, q, pm, mem, v, wg, bias)

    def bf16(args):
        return tuple(a if a.dim() == 1 and a.shape[0] == A else
                     a.to(torch.bfloat16) for a in args)

    for t in (1, 3):
        for b1, b2 in ((1, 1), (8, 8), (TRAIN_ROWS, ROLLOUT_ROWS)):
            for name, b, fn, plain, ulps in (
                    ("K1", b1, k1.fused_additive_attention,
                     k1.additive_attention_plain, 1),
                    ("K2", b2, k2.fused_decode_cell, k2.decode_cell_plain,
                     2)):
                attn = attention_inputs(b, gen, t)
                args = attn if name == "K1" else k2_args(b, attn)
                got, want = fn(*args), plain(*args)
                err = max((g - w).abs().max().item()
                          for g, w in zip(got, want))
                err_b, tol_b, ok_b, _ = bf16_errors(
                    fn(*bf16(args)), plain(*bf16(args)), ulps)
                print(f"kernel {name} T={t} B={b}: max_abs_err float32 "
                      f"{err:.3e} (tolerance {TOL}), bfloat16 {err_b:.3e} "
                      f"(tolerance {tol_b:.3e})")
                if err > TOL or not ok_b:
                    fail(f"{name} at T={t}, B={b} disagrees with its plain "
                         f"version: float32 {err:.3e}, bfloat16 {err_b:.3e}")
    for b1, b2 in ((1, 1), (8, 8), (TRAIN_ROWS, ROLLOUT_ROWS)):
        train_rows = b1 == TRAIN_ROWS
        attn = attention_inputs(b1, gen, T_MANET)
        m = check_k1(b1, attn, gen, flush, backward=train_rows)
        out["float32"]["K1"][f"T2/{b1}"] = m
        report_check("K1", b1, m, f" T={T_MANET}")
        m = check_k1_bf16(b1, attn, gen, flush, backward=train_rows)
        out["bfloat16"]["K1"][f"T2/{b1}"] = m
        report_bf16("K1", b1, m, f" T={T_MANET}")
        attn = attention_inputs(b2, gen, T_MANET)
        m = check_k2(b2, attn, gen, flush)
        out["float32"]["K2"][f"T2/{b2}"] = m
        report_check("K2", b2, m, f" T={T_MANET}")
        m = check_k2_bf16(b2, attn, gen, flush)
        out["bfloat16"]["K2"][f"T2/{b2}"] = m
        report_bf16("K2", b2, m, f" T={T_MANET}")
    attn = attention_inputs(40, gen, T_MANET)
    inv = {}
    for name, fn, args, per_row in (
            ("K1", k1.fused_additive_attention, attn, 3),
            ("K2", k2.fused_decode_cell, k2_args(40, attn), 6)):
        for dtype, a in (("float32", args), ("bfloat16", bf16(args))):
            inv[f"{name} {dtype}"] = bf16_batch_invariant(fn, a, per_row)
            out[dtype][name]["T2/8"]["batch_invariant_b40"] = \
                inv[f"{name} {dtype}"]
    print(f"kernels at T={T_MANET}, B=40: bitwise batch-invariant {inv}")
    if not all(inv.values()):
        fail(f"a kernel is not batch-invariant at T={T_MANET}: {inv}")
    return out


def variant_trainer(splits, name: str, *extra):
    """A ``Trainer`` of phase 7's arguments (``stage_args``) with ``extra``
    after them (argparse keeps the last value), checkpoints under
    ``VARIANT_ROOT/name``."""
    from cst_captioning_tpu_torch import train

    return smoke_trainer(train.parse_args(stage_args(
        "--checkpoint_path", os.path.join(VARIANT_ROOT, name), *extra)),
        splits)


def save_stage(trainer, name: str) -> str:
    from cst_captioning_tpu_torch.training import checkpoint

    path = os.path.join(VARIANT_ROOT, name)
    checkpoint.CheckpointManager(path).save(
        trainer.step, trainer.checkpoint_payload(), score=0.0)
    return path


def expect_launches(k1_per_step: int, k2_per_rollout_step: int = 0):
    """A ``timed_steps`` check: K1 exactly ``k1_per_step`` a completed
    step, K2 ``k2_per_rollout_step`` a rollout step (0: none), nothing in
    bfloat16, every loss and reward finite."""
    import numpy as np

    def check(done, launches):
        k1 = launches["fused_additive_attention"]
        k2 = launches["fused_decode_cell"]
        want_k2 = sum(k2_per_rollout_step * float(m.get("rollout_steps", 0))
                      for _, m in done)
        if (k1 != k1_per_step * len(done) or k2 != want_k2
                or launches["fused_additive_attention/bfloat16"]
                or launches["fused_decode_cell/bfloat16"]):
            fail(f"launches {launches} in {len(done)} steps: K1 "
                 f"{k1_per_step} a step and K2 {want_k2} expected")
        for _, m in done:
            if not all(np.isfinite(float(m[k])) for k in ("loss", "reward")
                       if k in m):
                fail(f"a variant step is not finite: {m}")

    return check


def split_feats(split, n: int):
    """The first ``n`` videos of ``split``: (video ids, feats on the
    card, feats_for(video id) -> the video's arrays)."""
    import numpy as np
    import torch

    ids = list(split.video_ids[:n])
    arrays = split.features(np.arange(n))
    index = {v: i for i, v in enumerate(ids)}
    return (ids, [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                  for a in arrays],
            lambda v: (None if v not in index
                       else [a[index[v]] for a in arrays]))


def serve_split(model, split, vocab, n: int, feats_for=None) -> tuple:
    """``n`` greedy requests of ``split``'s first videos through
    ``ServingEngine`` and ``CaptionServer``, their features from
    ``feats_for`` (a serve backend's; default ``split``'s) -> ({video id:
    served caption}, {video id: the offline greedy decode's caption of
    ``split``'s arrays}, engine stats, launches)."""
    import torch

    from cst_captioning_tpu_torch.ops import (launch_counts,
                                              launch_counts_by_dtype,
                                              reset_launch_counts)
    from cst_captioning_tpu_torch.serving.buckets import parse_buckets
    from cst_captioning_tpu_torch.serving.engine import ServingEngine
    from cst_captioning_tpu_torch.serving.server import CaptionServer

    ids, feats, own = split_feats(split, n)
    feats_for = feats_for or own
    engine = ServingEngine(
        model, list(zip(split.feat_times, split.feat_dims)),
        max_len=MAX_LEN, beam_size=1, decode_chunk=CHUNK,
        bucket_sizes=parse_buckets("1,4,8"))
    lines = [json.dumps({"id": i, "video_id": v}) + "\n"
             for i, v in enumerate(ids)]
    sink = io.StringIO()
    reset_launch_counts()
    rc = CaptionServer(engine, vocab, feats_for, out=sink).run_stdin(
        lines=lines)
    torch.cuda.synchronize()
    launches = {**launch_counts(), **launch_counts_by_dtype()}
    got = {r["video_id"]: r.get("caption") for r in
           map(json.loads, sink.getvalue().splitlines())}
    if rc != 0:
        fail(f"phase 16: the server exited {rc}")
    from cst_captioning_tpu_torch.ops.sampling import greedy_decode
    want = dict(zip(ids, vocab.decode_batch(greedy_decode(
        model, feats, MAX_LEN, decode_chunk=CHUNK).cpu().numpy())))
    return got, want, engine.stats(), launches


def prefix_against_full(model, feats) -> dict:
    """The transformer's greedy rollout over the prefix ``[0, pos + 1)``
    against the same rollout over the whole buffer (the reference's
    decode), on the card: the largest logit difference over max(1,
    max|logit|), whether every argmax agrees, and each rollout's
    milliseconds after one untimed rollout of each, and the full-buffer
    rollout's tokens."""
    import torch

    out = {}
    logits = {}
    with torch.no_grad():
        memory, _, pooled = model.encode(feats)
        for full in (False, True, False, True):
            carry = model.init_carry(pooled, MAX_LEN)
            prev = torch.zeros(pooled.shape[0], dtype=torch.long,
                               device=pooled.device)
            steps = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MAX_LEN):
                carry, lg = model.tx.decode(carry, prev[:, None], memory,
                                            pooled, full=full)
                steps.append(lg[:, 0])
                prev = lg[:, 0].argmax(-1)
            torch.cuda.synchronize()
            out["full_ms" if full else "prefix_ms"] = (
                time.perf_counter() - t0) * 1e3
            logits[full] = torch.stack(steps, 1)
        diff = (logits[False] - logits[True]).abs().max().item()
        out["err"] = diff / max(1.0, logits[True].abs().max().item())
        out["same_tokens"] = bool(torch.equal(logits[False].argmax(-1),
                                              logits[True].argmax(-1)))
        out["full_tokens"] = logits[True].argmax(-1)
    return out


def tx_eval_captions_checked(ck: str, eval_argv: list) -> None:
    """The transformer's eval held to the reference's decode: the
    checkpoint ``ck`` loaded as the eval CLI loads it, its prefix decode
    held to the full buffer over the first 16 val videos, and the eval
    CLI's beam-1 captions of those videos equal to the words of that
    full-buffer greedy rollout."""
    import torch

    from cst_captioning_tpu_torch import eval as port_eval

    model, vocab, val, _ = port_eval.load_checkpoint_model(
        ck, torch.device("cuda"))
    ids, feats, _ = split_feats(val, 16)
    pf = prefix_against_full(model, feats)
    want = dict(zip(ids, vocab.decode_batch(pf["full_tokens"].cpu())))
    argv = list(eval_argv)
    argv[argv.index("--beam_size") + 1] = "1"
    got = {p["image_id"]: p["caption"] for p in port_eval.evaluate(
        port_eval.parse_args(argv))["predictions"]}
    same = sum(got[v] == want[v] for v in ids)
    print(f"eval transformer beam 1 against the full-buffer greedy rollout "
          f"of the checkpoint: {same} of {len(ids)} captions equal; prefix "
          f"vs full logits {pf['err']:.3e}, tokens equal "
          f"{pf['same_tokens']}; first: {want[ids[0]]!r}")
    if pf["err"] > PREFIX_TOL or not pf["same_tokens"] or same != len(ids):
        fail("phase 16: the transformer's eval captions differ from its "
             "full-buffer greedy decode")


def variants_phase(splits) -> dict:
    """Phase 16: the model variants at phase 7's width and split (E = H =
    A = 512, 64 x 20 a batch, ``max_length`` 30), through the train CLI's
    parser and ``Trainer``, the eval CLI and the serve CLI's backend:
    (a) the transformer (8 heads, 2 layers): 2 + 10 XE steps, its
    profiled step, the prefix decode against the full buffer over 16
    greedy rows (and both timed at 1280), 1 + 5 fused CST steps
    (scb-sample), the beam-5 eval of
    the result (497 val videos in batches of 64), 3 bfloat16 XE steps and
    the serve CLI's refusal; no K1 or K2 launch; (b) manet: the kernels
    at T = 1, 2, 3, 2 + 5 XE steps on K1, 1 + 3 fused CST steps on K2
    and 16 greedy requests through the serve CLI's backend, equal to the
    offline decode; (c) the 2-layer LSTM: the fused cell refused, 2 + 5
    XE steps on K1 and 16 requests on the reference cell with K1; (d) the
    pooled LSTM: 2 + 5 XE steps, no launch; (e) ``--remat_cell`` 0
    against 1: XE ms/step and peak memory with and without K1, a
    profiled step of each with K1, and one step's gradients within
    1e-6.  -> ({(kernel, storage): launches},
    the T = 2 measurements)."""
    import contextlib
    import shutil

    import torch

    from cst_captioning_tpu_torch import eval as port_eval
    from cst_captioning_tpu_torch import serve, train
    from cst_captioning_tpu_torch.ops import (launch_counts,
                                              launch_counts_by_dtype,
                                              reset_launch_counts)
    from cst_captioning_tpu_torch.ops.losses import cross_entropy_loss
    from cst_captioning_tpu_torch.training.trainer import build_model
    from cst_captioning_tpu_torch.weights import init_like_flax_

    t_phase = time.perf_counter()
    shutil.rmtree(VARIANT_ROOT, ignore_errors=True)
    rows = TRAIN_BATCH * TRAIN_SEQ
    total = {("K1", "float32"): 0, ("K2", "float32"): 0,
             ("K1", "bfloat16"): 0, ("K2", "bfloat16"): 0}

    def add(steps):
        for _, _, launches in steps:
            for (kernel, dtype) in total:
                name = ("fused_additive_attention" if kernel == "K1"
                        else "fused_decode_cell")
                total[(kernel, dtype)] += launches[f"{name}/{dtype}"]

    def train_steps(trainer, name, warm, n, check):
        add(timed_steps(trainer, warm, check))
        steps = timed_steps(trainer, n, check)
        add(steps)
        return report_stage(name, steps, rows), steps

    measured = variant_kernel_checks()
    t_kernels = time.perf_counter() - t_phase

    # (a) The transformer.
    none = expect_launches(0)
    xe = variant_trainer(splits, "tx_xe", *TX_ARGS)
    n_params = sum(p.numel() for p in xe.model.parameters())
    print(f"variants transformer: {n_params} parameters "
          f"({xe.model.tx.max_len} positions)")
    tx_xe_ms, _ = train_steps(xe, "transformer XE", 2, 10, none)
    prof = device_profile(xe.iteration, iters=1)
    print(f"train transformer XE: profiled step: device time "
          f"{prof['ms']:.3f} ms (summed), busy {prof['busy_ms']:.3f} ms of "
          f"{prof['wall_ms']:.3f} ms wall = busy share "
          f"{prof['busy_ms'] / prof['wall_ms']:.3f}; top kernels (name, ms, "
          "launches): " + "; ".join(f"{k} {ms:.3f} {n:.0f}"
                                    for k, ms, n in prof["top"]))
    _, feats64, _ = split_feats(splits[1], TRAIN_BATCH)
    for n, feats in ((16, [f[:16] for f in feats64]),
                     (rows, [f.repeat_interleave(TRAIN_SEQ, 0)
                             for f in feats64])):
        pf = prefix_against_full(xe.model, feats)
        print(f"transformer prefix decode vs the full buffer, {n} greedy "
              f"rows x {MAX_LEN} steps: logits max diff / max(1, "
              f"max|logit|) {pf['err']:.3e}, tokens equal "
              f"{pf['same_tokens']}; rollout {pf['prefix_ms']:.3f} ms "
              f"prefix, {pf['full_ms']:.3f} ms full buffer (host clock)")
        # The check is on the 16 rows; at the rollout batch the two
        # rollouts are timed (a near-tie may round to another argmax).
        if n == 16 and (pf["err"] > PREFIX_TOL or not pf["same_tokens"]):
            fail(f"phase 16: the transformer's prefix decode differs from "
                 f"the full-buffer decode (tolerance {PREFIX_TOL})")
    tx_start = save_stage(xe, "tx_xe")
    xe.close()
    del xe
    t0 = time.perf_counter()
    cst = variant_trainer(splits, "tx_cst", *TX_ARGS, "--use_rl", "1",
                          "--rl_baseline", "scb-sample", "--learning_rate",
                          "2e-5", "--start_from", tx_start)
    print(f"variants transformer CST: trainer built in "
          f"{time.perf_counter() - t0:.1f} s")
    tx_cst_ms, cst_steps = train_steps(cst, "transformer CST fused "
                                       "scb-sample", 1, 5, none)
    ms = phase_medians(cst_steps)
    print(f"train transformer CST phases (median ms, CUDA events): rollout "
          f"{ms['rollout']:.3f} ({rows} rows, steps "
          f"{[float(m['rollout_steps']) for _, d, _ in cst_steps for _, m in d]}"
          f"), on-device reward {ms['reward']:.3f}, grad {ms['grad']:.3f}")
    tx_ck = save_stage(cst, "tx_cst")
    cst.close()
    del cst
    eval_argv = ["--checkpoint_path", tx_ck, "--beam_size", str(EVAL_BEAM),
                 "--eval_batch_size", str(EVAL_BATCH), "--max_length",
                 str(MAX_LEN), "--decode_chunk", str(CHUNK),
                 "--decode_kernel", "reference"]
    reset_launch_counts()
    out = port_eval.evaluate(port_eval.parse_args(eval_argv))
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"eval transformer beam {EVAL_BEAM}: {out['videos']} videos in "
          f"batches of {EVAL_BATCH}; decode {out['decode_s']:.3f} s = "
          f"{out['videos'] / out['decode_s']:.1f} videos/s "
          f"({out['decode_steps']} beam steps); scores " + ", ".join(
              f"{k} {v:.6f}" for k, v in out["scores"].items())
          + f"; launches {launches}")
    if (out["videos"] != splits[1].num_videos or any(launches.values())
            or not all(0.0 <= v < 20.0 for v in out["scores"].values())):
        fail(f"phase 16: the transformer's eval: {out['scores']}, "
             f"launches {launches}")
    caps = [p["caption"].split() for p in out["predictions"]]
    print(f"eval transformer beam {EVAL_BEAM} captions: "
          f"{sum(not c for c in caps)} of {len(caps)} empty, mean length "
          f"{sum(map(len, caps)) / len(caps):.2f} words, mean distinct "
          f"words {sum(len(set(c)) for c in caps) / len(caps):.2f}; first "
          "three: " + " | ".join(p["caption"] for p in out["predictions"][:3]))
    tx_eval_captions_checked(tx_ck, eval_argv)
    bf = variant_trainer(splits, "tx_bf16", *TX_ARGS, "--use_bfloat16", "1")
    if bf.model.dtype != torch.bfloat16:
        fail("phase 16: the bfloat16 transformer computes in "
             f"{bf.model.dtype}")
    tx_bf16_ms, _ = train_steps(bf, "transformer XE bf16", 0, 3, none)
    bf.close()
    del bf
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = serve.main(["--checkpoint_path", tx_ck, "--decode_kernel",
                         "reference"])
    print(f"serve --checkpoint_path <transformer>: exit {rc}; stderr "
          f"{err.getvalue().strip()!r}")
    if rc == 0 or "per-row decoder state" not in err.getvalue():
        fail("phase 16: the serve CLI did not refuse the transformer with "
             "the reference's reason")

    # (b) manet: K1 and K2 over a memory of T = 2.
    manet = ("--fusion_type", "manet", "--remat_cell", "1")
    xe = variant_trainer(splits, "manet_xe", *manet)
    if xe.model.encoder.fusion != "modality":
        fail("phase 16: --fusion_type manet did not build the modality "
             "fusion")
    manet_xe_ms, _ = train_steps(xe, "manet XE (K1, remat)", 2, 5,
                                 expect_launches(2 * MAX_LEN))
    start = save_stage(xe, "manet_xe")
    xe.close()
    del xe
    cst = variant_trainer(splits, "manet_cst", *manet, "--use_rl", "1",
                          "--rl_baseline", "greedy", "--learning_rate",
                          "2e-5", "--start_from", start)
    manet_cst_ms, cst_steps = train_steps(
        cst, "manet CST fused (K2 at T=2)", 1, 3,
        expect_launches(2 * MAX_LEN, 2))
    ms = phase_medians(cst_steps)
    print(f"train manet CST phases (median ms, CUDA events): rollout "
          f"{ms['rollout']:.3f} ({ROLLOUT_ROWS} rows), on-device reward "
          f"{ms['reward']:.3f}, grad {ms['grad']:.3f}")
    manet_ck = save_stage(cst, "manet_cst")
    cst.close()
    del cst
    opt = serve.parse_args(["--checkpoint_path", manet_ck, "--beam_size",
                            "1", "--decode_kernel", "fused", "--max_length",
                            str(MAX_LEN), "--decode_chunk", str(CHUNK)])
    model, vocab, _, feats_for = serve.build_backend(opt)
    got, want, stats, launches = serve_split(model, splits[1], vocab, 16,
                                             feats_for)
    same = sum(got.get(v) == c for v, c in want.items())
    print(f"serve --checkpoint_path <manet> --decode_kernel fused: 16 "
          f"requests, {same} captions equal to the offline decode; "
          f"decode_steps {stats['decode_steps']}, "
          f"decode_ms_per_step {stats['decode_ms_per_step']:.4f}; "
          f"launches {launches}")
    if same != 16:
        fail("phase 16: manet's served captions differ from the offline "
             "decode")
    check_launches("phase 16 manet serving", "K2",
                   launches["fused_decode_cell"], stats["decode_steps"], 2)
    total[("K2", "float32")] += launches["fused_decode_cell/float32"]
    del model

    # (c) The 2-layer LSTM.
    try:
        variant_trainer(splits, "lstm2_fused", "--num_layers", "2")
        fail("phase 16: --decode_kernel fused took the 2-layer LSTM")
    except ValueError as e:
        print(f"2-layer LSTM with --decode_kernel fused: refused at "
              f"construction ({e})")
    lstm2 = ("--num_layers", "2", "--decode_kernel", "reference",
             "--remat_cell", "1")
    xe = variant_trainer(splits, "lstm2_xe", *lstm2)
    lstm2_ms, _ = train_steps(xe, "2-layer LSTM XE (K1, remat)", 2, 5,
                              expect_launches(2 * MAX_LEN))
    got, want, stats, launches = serve_split(xe.model, splits[1], xe.vocab,
                                             16)
    same = sum(got.get(v) == c for v, c in want.items())
    print(f"serve 2-layer LSTM, reference cell with K1: 16 requests, "
          f"{same} captions equal to the offline decode; decode_steps "
          f"{stats['decode_steps']}; launches {launches}")
    if same != 16:
        fail("phase 16: the 2-layer LSTM's served captions differ from the "
             "offline decode")
    check_launches("phase 16 2-layer serving", "K1",
                   launches["fused_additive_attention"],
                   stats["decode_steps"], 1)
    total[("K1", "float32")] += launches["fused_additive_attention/float32"]
    xe.close()
    del xe

    # (d) The pooled LSTM (no attention: no kernel).
    xe = variant_trainer(splits, "pooled_xe", "--use_attention", "0",
                         "--decode_kernel", "reference", "--remat_cell", "1")
    pooled_ms, _ = train_steps(xe, "pooled LSTM XE", 2, 5, none)
    xe.close()
    del xe

    # (e) --remat_cell 0 against 1, with and without K1.
    remat = {}
    for k1_on in ("1", "0"):
        for flag in ("0", "1"):
            per = MAX_LEN * (1 + int(flag)) if k1_on == "1" else 0
            xe = variant_trainer(splits, f"remat{flag}_k1{k1_on}",
                                 "--remat_cell", flag, "--pallas_attention",
                                 k1_on)
            add(timed_steps(xe, 2, expect_launches(per)))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            steps = timed_steps(xe, 5, expect_launches(per))
            add(steps)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            remat[(k1_on, flag)] = (report_stage(
                f"XE --remat_cell {flag} --pallas_attention {k1_on}", steps,
                rows), peak)
            print(f"XE --remat_cell {flag} --pallas_attention {k1_on}: peak "
                  f"device memory {peak:.3f} GiB over the timed steps")
            if k1_on == "1":
                prof = device_profile(xe.iteration, iters=1)
                print(f"XE --remat_cell {flag}: profiled step: device time "
                      f"{prof['ms']:.3f} ms (summed), busy "
                      f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms "
                      f"wall = busy share "
                      f"{prof['busy_ms'] / prof['wall_ms']:.3f}; top kernels "
                      "(name, ms, launches): " + "; ".join(
                          f"{k} {ms:.3f} {n:.0f}" for k, ms, n in
                          prof["top"]))
            xe.close()
            del xe
            torch.cuda.empty_cache()
    for k1_on in ("1", "0"):
        (ms0, p0), (ms1, p1) = remat[(k1_on, "0")], remat[(k1_on, "1")]
        print(f"remat cost with --pallas_attention {k1_on}: ms/step "
              f"{ms0 * 1e3:.3f} -> {ms1 * 1e3:.3f} ({ms1 / ms0 - 1:+.1%}), "
              f"peak {p0:.3f} -> {p1:.3f} GiB")
    opt = train.parse_args(stage_args())
    _, feats, _ = split_feats(splits[0], TRAIN_BATCH)
    labels = torch.from_numpy(splits[0].labels[:rows]).long().cuda()
    grads = {}
    for flag in (0, 1):
        opt.remat_cell = flag
        model = build_model(opt, splits[0].vocab.size_with_pad,
                            splits[0].feat_dims, splits[0].seq_length)
        init_like_flax_(model, torch.Generator().manual_seed(16))
        model.to(labels.device)
        loss = cross_entropy_loss(model(
            feats, labels, TRAIN_SEQ, train=True,
            generator=torch.Generator(labels.device).manual_seed(17)),
            labels)
        loss.backward()
        grads[flag] = {n: p.grad for n, p in model.named_parameters()
                       if p.grad is not None}
        del model
    worst = max(((grads[1][n] - g).abs().max()
                 / max(1.0, g.abs().max().item())).item()
                for n, g in grads[0].items())
    bitwise = all(torch.equal(grads[1][n], g) for n, g in grads[0].items())
    print(f"remat gradients after one XE step (K1, dropout on, one "
          f"generator seed): max |g1 - g0| / max(1, max|g0|) {worst:.3e} "
          f"over {len(grads[0])} tensors (tolerance 1e-6); bitwise "
          f"{bitwise}")
    if worst > 1e-6 or grads[0].keys() != grads[1].keys():
        fail("phase 16: --remat_cell 1 changed the gradients")
    del grads
    shutil.rmtree(VARIANT_ROOT, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"variants summary (ms/step): transformer XE {tx_xe_ms * 1e3:.3f}, "
          f"CST {tx_cst_ms * 1e3:.3f}, XE bf16 {tx_bf16_ms * 1e3:.3f}; manet "
          f"XE {manet_xe_ms * 1e3:.3f}, CST {manet_cst_ms * 1e3:.3f}; "
          f"2-layer XE {lstm2_ms * 1e3:.3f}; pooled XE {pooled_ms * 1e3:.3f}")
    print(f"variants phase: {seconds:.1f} s (kernels {t_kernels:.1f} s; "
          f"budget {VARIANTS_BUDGET_S:.0f} s); launches "
          + json.dumps({f"{k}/{d}": n for (k, d), n in total.items()}))
    return total, measured


# Phase 17: training telemetry and the autotuner through the CLIs: the
# train CLI on phase 10's split (6 batches of 64 x 20 an epoch, phase 7's
# width) traced and profiled against disarmed twins, ``--debug_nans``, the
# tune CLI's fast sweep into a record of its own, and the stage probe.
TELEMETRY_ROOT = os.path.join(HERE, "checkpoints", "chip_smoke_telemetry")
TELEMETRY_BUDGET_S = 90.0
#: The profiler window, loop steps [2, 4) of the epoch's 6.
PROFILE_WINDOW = (2, 4)
#: K1's CUDA symbol as the profiler's trace names it; K2 launches the same
#: attention kernel and then one of its gate kernels
#: (``decode_cell_kernel.GATE_KERNELS``).
K1_SYMBOL = "attention_kernel"
TELEMETRY_SPANS = {"xe": {"data_wait", "compute", "ckpt", "ckpt_commit",
                          "prefetch_assemble"},
                   "cst": {"data_wait", "compute", "ckpt", "ckpt_commit"}}
PHASE_GAUGES = ("data_wait_ms", "compute_ms", "score_ms", "ckpt_ms")
#: The tuning record's key of this card: the torch device type.
TUNE_PLATFORM = "cuda"


def tune_cli(record: str) -> list:
    """The fast sweep of phase 17 into ``record``."""
    return [sys.executable, "-m", "cst_captioning_tpu_torch.tune", "--fast",
            "--record", record]


def cli_env(**extra) -> dict:
    """The environment of a phase-17 CLI process."""
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("CST_FAULT_PLAN", None)
    env.update(extra)
    return env


def without(argv: list, flag: str) -> list:
    """``argv`` without ``flag`` and its value."""
    i = argv.index(flag)
    return argv[:i] + argv[i + 2:]


def train_cli(name: str, argv, env, expect: int = 0):
    """One ``python -m cst_captioning_tpu_torch.train`` of phase 17; fails
    unless it exits ``expect``.  -> (the process, its seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cst_captioning_tpu_torch.train", *argv],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    if proc.returncode != expect:
        print(proc.stderr[-6000:], file=sys.stderr)
        fail(f"phase 17 {name}: exit {proc.returncode}, {expect} expected")
    return proc, secs


def train_records(ck: str) -> list:
    with open(os.path.join(ck, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["scope"] == "train"]


def step_ms(ck: str) -> dict:
    """{step: wall ms} of a ``--log_every 1`` run, from each step's
    captions/s (the host clock from one record to the next, the step's
    metric fetch included)."""
    return {r["step"]: TRAIN_ROWS / r["captions_per_sec"] * 1e3
            for r in train_records(ck) if r.get("captions_per_sec")}


def trace_kernels(path: str) -> tuple:
    """A profiler trace, read once -> (its device kernels: all of them and
    those whose symbol names K1 and K2's gate stage; ``profile_top``'s
    summary of the same events, every name listed, with the seconds the
    read and the summary took under ``seconds``)."""
    from cst_captioning_tpu_torch.ops.decode_cell_kernel import GATE_KERNELS
    from cst_captioning_tpu_torch.tools.profile_top import summarize

    t0 = time.perf_counter()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    t1 = time.perf_counter()
    top = summarize(events, top=0)
    top["seconds"] = {"read": t1 - t0, "summary": time.perf_counter() - t1,
                      "trace_mb": os.path.getsize(path) / 2 ** 20}
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"all": len(names),
            "attention": sum(K1_SYMBOL in n for n in names),
            "gate": sum(any(g in n for g in GATE_KERNELS) for n in names),
            "gates": {g: sum(g in n for n in names)
                      for g in GATE_KERNELS}}, top


def span_names(trace_dir: str) -> set:
    """Span names of every Chrome-trace part of a ``--trace_dir``."""
    import glob

    names = set()
    for path in glob.glob(os.path.join(trace_dir, "*.json")):
        with open(path) as f:
            doc = json.load(f)
        names |= {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    return names


def first_step_wall(trace_dir: str) -> float:
    """The wall clock (Unix seconds) at which a ``--trace_dir`` run's
    first ``compute`` span began."""
    import glob

    starts = []
    for path in glob.glob(os.path.join(trace_dir, "*.json")):
        with open(path) as f:
            doc = json.load(f)
        epoch = doc["otherData"]["wall_epoch_unix_s"]
        starts += [epoch + e["ts"] / 1e6 for e in doc["traceEvents"]
                   if e.get("ph") == "X" and e["name"] == "compute"]
    return min(starts)


def collect(job: dict) -> None:
    """Wait for ``job["proc"]``; store its output and the wall clock at
    its end in ``job``."""
    try:
        job["out"], job["err"] = job["proc"].communicate(timeout=300)
    except subprocess.TimeoutExpired:
        job["proc"].kill()
        job["out"], job["err"] = "", "timed out after 300 s"
    job["ended"] = time.time()


def traced_run(name: str, args, env) -> tuple:
    """Phase 17 (a)/(b): a traced, step-timed, profiled train run with
    TensorBoard, checked: the span trace, the gauges and a non-null
    ``mfu_pct``, and the profiler trace's kernels against the window's
    launch counts.  A profiler session that comes back without device
    events is taken again once.  -> (checkpoint dir, the window's
    launches, the trace's kernels, ``profile_top``'s summary)."""
    for attempt in (1, 2):
        root = os.path.join(TELEMETRY_ROOT, f"{name}_on{attempt}")
        ck, tdir, pdir = (os.path.join(root, d)
                          for d in ("ck", "trace", "profile"))
        proc, secs = train_cli(f"{name} traced", resume_args(
            *args, "--checkpoint_path", ck, "--trace_dir", tdir,
            "--step_timing", "1", "--profile_dir", pdir, "--profile_steps",
            "%d:%d" % PROFILE_WINDOW, "--tensorboard", "1",
            "--loglevel", "WARNING"), env)
        prof = telemetry(ck)["info"]["profile"]
        kernels, top = trace_kernels(prof["trace"])
        if kernels["all"]:
            break
        print(f"telemetry {name}: the profiler trace holds no device "
              f"event (attempt {attempt})", file=sys.stderr)
    else:
        fail(f"phase 17 {name}: two profiler sessions without device "
             "events")
    spans = span_names(tdir)
    recs = train_records(ck)
    gauged = [r for r in recs if "data_wait_ms" in r]
    missing = TELEMETRY_SPANS[name] - spans
    if missing or not gauged or any(
            k not in r for r in gauged for k in PHASE_GAUGES):
        fail(f"phase 17 {name}: spans {sorted(spans)} (missing "
             f"{sorted(missing)}), {len(gauged)} gauged records")
    if any(r["mfu_pct"] is None for r in gauged):
        fail(f"phase 17 {name}: mfu_pct is null on the card")
    tb = os.path.join(ck, "tb")
    tb_files = os.listdir(tb) if os.path.isdir(tb) else []
    if not tb_files and "tensorboard writer unavailable" not in proc.stderr:
        fail(f"phase 17 {name}: --tensorboard 1 wrote nothing and did not "
             "warn")
    last = gauged[-1]
    print(f"telemetry {name}: traced run {secs:.1f} s; spans "
          f"{sorted(spans)}; last record "
          + ", ".join(f"{k} {last[k]}" for k in PHASE_GAUGES)
          + f", mfu_pct {last['mfu_pct']}; tensorboard "
          + (f"{len(tb_files)} event file(s)" if tb_files
             else "not installed (warned)"))
    return ck, prof, kernels, top


def telemetry_phase() -> dict:
    """Phase 17: training telemetry and the autotuner on the card.

    (e) ``python -m cst_captioning_tpu_torch.tune --fast`` into a record
    of its own: the ``cuda`` entry with this card's name, both points
    measured; beside it (d) a ``--debug_nans 1`` XE run with
    ``nan_grad@step=1`` (exits non-zero and names the non-finite value)
    and (f) ``probe_device`` (``ok``).  (e') the sweep's rerun (reused, 0
    measured) runs beside the start of (a)'s traced run.
    (c) XE and fused CST (``--decode_kernel fused``) on the phase-10
    split at phase 7's width, disarmed and armed (``--trace_dir
    --step_timing 1``) in turns, in this process through the train CLI's
    parser and ``Trainer``.  (a) XE and (b) fused CST traced through the
    CLI (the same, ``--profile_dir`` over loop steps [2, 4),
    ``--tensorboard 1``): the spans, the four phase gauges and a
    non-null ``mfu_pct``; the profiler trace naming K1 ``MAX_LEN`` times
    a profiled step and K2's gate kernel once per executed rollout step,
    equal to the wrappers' counts over the window.  Printed: ms/step
    disarmed, armed, profiled (inside the window), and the steps that
    open and close it.  All under the record: the disarmed XE runs leave
    ``--decode_chunk`` to it, the traced one sets it, and
    ``tuned_provenance`` in each ``telemetry.json`` says which won.
    -> {(kernel, dtype): launches}."""
    import shutil

    import numpy as np
    import torch

    from cst_captioning_tpu_torch import train
    from cst_captioning_tpu_torch.ops import (launch_counts_by_dtype,
                                              reset_launch_counts)
    from cst_captioning_tpu_torch.ops.decode_cell_kernel import GATE_KERNELS
    from cst_captioning_tpu_torch.tools.stage_chain import probe_device
    from cst_captioning_tpu_torch.training.trainer import build_splits

    t_phase = time.perf_counter()
    shutil.rmtree(TELEMETRY_ROOT, ignore_errors=True)
    os.makedirs(TELEMETRY_ROOT)
    record = os.path.join(TELEMETRY_ROOT, "TUNED_CONFIGS_TORCH.json")
    total = dict.fromkeys([("K1", "float32"), ("K2", "float32"),
                           ("K1", "bfloat16"), ("K2", "bfloat16")], 0)
    wrapper = {"K1": "fused_additive_attention", "K2": "fused_decode_cell"}

    def add(launches: dict) -> None:
        for key, dtype in total:
            total[(key, dtype)] += launches.get(f"{wrapper[key]}/{dtype}", 0)

    def add_process(ck: str) -> dict:
        gauges = telemetry(ck)["gauges"]
        add({k.split("/", 1)[1]: n for k, n in gauges.items()
             if k.startswith("launches/")})
        return telemetry(ck)

    # (e) the fast sweep into its own record; (d) --debug_nans and (f)
    # the probe beside it, while this process builds (c)'s split.
    tune = tune_cli(record)
    off_env = cli_env(CST_TUNED_CONFIGS_TORCH="")
    t0 = time.perf_counter()
    sweep = subprocess.Popen(tune, cwd=HERE, env=off_env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    nan_ck = os.path.join(TELEMETRY_ROOT, "debug_nans")
    nans = subprocess.Popen(
        [sys.executable, "-m", "cst_captioning_tpu_torch.train",
         *resume_args("--checkpoint_path", nan_ck, "--debug_nans", "1",
                      "--fault_plan", "nan_grad@step=1",
                      "--loglevel", "WARNING")],
        cwd=HERE, env=off_env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    verdict = probe_device(device=TUNE_PLATFORM)
    # (c) runs disarmed and armed in this process on one shared split.
    splits = build_splits(train.parse_args(resume_args()))
    out, err = sweep.communicate(timeout=600)
    tune_s = time.perf_counter() - t0
    nan_out, nan_err = nans.communicate(timeout=300)
    if sweep.returncode != 0:
        print(err[-6000:], file=sys.stderr)
        fail(f"phase 17 tune: exit {sweep.returncode}")
    first = json.loads(out.strip().splitlines()[-1])
    add(first["launches"])
    with open(record) as f:
        entry = json.load(f)["platforms"].get(TUNE_PLATFORM)
    kind = torch.cuda.get_device_name(0)
    if (entry is None or entry["device_kind"] != kind
            or not entry["complete"] or first["measured"] != 2
            or any(not p.get("captions_per_sec") for p in entry["points"])):
        fail(f"phase 17 tune: record entry {entry}, line {first}")
    named = re.search(r"Function '(\w+)' returned nan values", nan_err)
    if nans.returncode == 0 or named is None:
        print(nan_err[-4000:], file=sys.stderr)
        fail(f"phase 17 --debug_nans: exit {nans.returncode}, the "
             "non-finite value not named")
    add_process(nan_ck)
    if verdict != ("ok", ""):
        fail(f"phase 17 probe_device: {verdict}")
    print(f"telemetry tune --fast (beside --debug_nans and the probe): "
          f"{tune_s:.1f} s, entry '{TUNE_PLATFORM}' "
          f"({entry['device_kind']}), points "
          + "; ".join(f"{p['config']['decode_kernel']} "
                      f"{p['captions_per_sec']} captions/s"
                      for p in entry["points"])
          + f"; winner {entry['winner']}; launches {first['launches']}; "
          f"--debug_nans with nan_grad@step=1 exited {nans.returncode}: "
          f"\"{named.group(0)}\"; probe_device {verdict[0]}")

    # (c) first: disarmed and armed in this process, in turns (ABBA),
    # through the train CLI's parser and ``Trainer``; then (a), (b): the
    # traced CLI runs, (e') the sweep's rerun beside XE's.  All under the
    # record.

    def in_process(label: str, argv: list) -> str:
        ck = os.path.join(TELEMETRY_ROOT, label)
        os.environ["CST_TUNED_CONFIGS_TORCH"] = record
        try:
            opt = train.parse_args(argv + ["--checkpoint_path", ck,
                                           "--loglevel", "WARNING"])
        finally:
            os.environ["CST_TUNED_CONFIGS_TORCH"] = ""
        reset_launch_counts()
        trainer = smoke_trainer(opt, splits)
        try:
            trainer.train()
        finally:
            trainer.close()
        add(launch_counts_by_dtype())
        return ck

    env = cli_env(CST_TUNED_CONFIGS_TORCH=record)
    cost = {}
    for name, args in (("xe", ()),
                       ("cst", ("--use_rl", "1", "--rl_baseline", "greedy"))):
        off_argv = resume_args(*args)
        if name == "xe":
            off_argv = without(off_argv, "--decode_chunk")
        armed_argv = resume_args(*args, "--trace_dir", os.path.join(
            TELEMETRY_ROOT, f"{name}_armed_trace"), "--step_timing", "1")
        t0 = time.perf_counter()
        runs = {"disarmed": [], "armed": []}
        for turn, label in enumerate(("disarmed", "armed", "armed",
                                      "disarmed")):
            ck = in_process(f"{name}_{label}{turn}",
                            off_argv if label == "disarmed" else armed_argv)
            runs[label].append(ck)
        ab_s = time.perf_counter() - t0
        if any(k.endswith("_ms") for ck in runs["disarmed"]
               for r in train_records(ck) for k in r):
            fail(f"phase 17 {name}: a disarmed run has phase gauges")
        if not all("data_wait_ms" in r for ck in runs["armed"]
                   for r in train_records(ck) if "captions_per_sec" in r):
            fail(f"phase 17 {name}: an armed run lacks the phase gauges")
        tel_off = telemetry(runs["disarmed"][0])
        if name == "xe":
            # (e') the rerun reads the record and measures nothing: it
            # runs beside the traced run's start.
            rerun = {"proc": subprocess.Popen(
                tune, cwd=HERE, env=off_env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)}
            waiter = threading.Thread(target=collect, args=(rerun,),
                                      name="tune-rerun-wait", daemon=True)
            waiter.start()
        ck_on, prof, kernels, top = traced_run(name, args, env)
        tel_on = add_process(ck_on)
        if name == "xe":
            waiter.join()
            lines = rerun["out"].strip().splitlines()
            again = json.loads(lines[-1]) if lines else {}
            if (rerun["proc"].returncode != 0 or not again.get("reused")
                    or again.get("measured") != 0):
                print(rerun["err"][-4000:], file=sys.stderr)
                fail(f"phase 17 tune rerun: exit "
                     f"{rerun['proc'].returncode}, {again}")
            lead = first_step_wall(os.path.join(
                os.path.dirname(ck_on), "trace")) - rerun["ended"]
            print(f"telemetry tune rerun (beside the traced XE run): "
                  f"reused {again['reused']} with {again['measured']} "
                  f"measurements; it ended {lead:.1f} s before the traced "
                  "run's first step")
        steps = prof["steps"]
        launches = prof["launches"]
        k1 = launches["fused_additive_attention/float32"]
        k2 = launches["fused_decode_cell/float32"]
        profiled = steps[1] - steps[0]
        want_k2 = name == "cst"
        if (steps != list(PROFILE_WINDOW) or k1 != MAX_LEN * profiled
                or (k2 > 0) != want_k2 or k2 % 2
                or k2 > 2 * MAX_LEN * profiled
                or kernels["attention"] != k1 + k2 // 2
                or kernels["gate"] != k2 // 2):
            fail(f"phase 17 {name}: profiled steps {steps}, counters K1 "
                 f"{k1} K2 {k2}, the trace's kernels {kernels}")
        print(f"telemetry {name}: profiler window {steps}: the trace names "
              f"{K1_SYMBOL} {kernels['attention']} times and "
              f"K2's gate kernels {kernels['gate']} {kernels['gates']} "
              f"({kernels['all']} kernel "
              f"events); the wrappers counted K1 {k1} ({MAX_LEN} a step) "
              f"and K2 {k2} (2 a rollout step: {k2 // 2} executed)")
        named = {sym: sum(r["count"] for r in top["kernels"]
                          if sym in r["name"])
                 for sym in (K1_SYMBOL, *GATE_KERNELS)}
        named_gates = {g: named[g] for g in GATE_KERNELS}
        span = top["span_us"]
        print(f"telemetry {name} profile_top [{card_line()}]: window "
              f"{span / 1e3:.3f} ms, device busy "
              f"{top['device_busy_us'] / 1e3:.3f} ms (share "
              f"{top['device_busy_share']:.4f}); {K1_SYMBOL} "
              f"{named[K1_SYMBOL]}, gate kernels {named_gates} "
              f"of {top['distinct_kernels']} kernel names (trace "
              f"{top['seconds']['trace_mb']:.1f} MiB read in "
              f"{top['seconds']['read']:.2f} s, summarised in "
              f"{top['seconds']['summary']:.2f} s); top 10 by total: "
              + json.dumps([{"name": r["name"][:160], "count": r["count"],
                             "total_us": round(r["total_us"], 3),
                             "mean_us": round(r["mean_us"], 3),
                             "share": round(r["total_us"] / span, 4)}
                            for r in top["kernels"][:10]]))
        if (named[K1_SYMBOL], named_gates) != (
                kernels["attention"], kernels["gates"]) \
                or sum(r["count"] for r in top["kernels"]) != kernels["all"]:
            fail(f"phase 17 {name}: profile_top counts {named} "
                 f"({sum(r['count'] for r in top['kernels'])} kernel "
                 f"events), trace_kernels {kernels}")
        # Record k is loop step k - 1: the window [a, b) opens in record
        # a + 1's interval and closes (the trace's export) in b + 1's.
        per = {label: [step_ms(ck) for ck in cks]
               for label, cks in runs.items()}
        on = step_ms(ck_on)
        a, b = steps
        c = cost[name] = {
            label: float(np.median([ms for run in per[label]
                                    for k, ms in run.items() if k > 1]))
            for label in per}
        c.update({
            "profiled": float(np.median([on[k] for k in range(a + 2,
                                                              b + 1)])),
            "window_open": on[a + 1], "window_close": on[b + 1],
            "traced_outside_window": float(np.median([
                ms for k, ms in on.items()
                if k > 1 and not a + 1 <= k <= b + 1]))})
        print(f"telemetry {name} ms/step (disarmed and armed in this "
              f"process, {ab_s:.1f} s for the four runs): " + "; ".join(
                  f"{label} {[round(run[k], 3) for k in sorted(run)]}"
                  for label in ("disarmed", "armed") for run in per[label])
              + f"; traced (CLI) {[round(on[k], 3) for k in sorted(on)]}; "
              f"medians from step 2: disarmed {c['disarmed']:.3f}, armed "
              f"{c['armed']:.3f} ({c['armed'] / c['disarmed'] - 1:+.1%}), "
              f"profiled {c['profiled']:.3f} "
              f"({c['profiled'] / c['disarmed'] - 1:+.1%}), the traced run "
              f"outside the window {c['traced_outside_window']:.3f}; the "
              f"step that opens the window {c['window_open']:.3f}, the one "
              f"that closes it (export) {c['window_close']:.3f}")
        if name == "xe":
            prov_on = tel_on["meta"]["tuned_config"]
            prov_off = tel_off["meta"]["tuned_config"]
            if (not prov_on.get("tuned") or not prov_off.get("tuned")
                    or prov_off.get("platform") != TUNE_PLATFORM
                    or "decode_chunk" in prov_on["applied"]
                    or prov_off["applied"].get("decode_chunk")
                    != entry["winner"]["decode_chunk"]):
                fail(f"phase 17 tuned_provenance: traced {prov_on}, "
                     f"disarmed {prov_off}")
            print(f"telemetry tuned_provenance: the disarmed run applied "
                  f"{prov_off['applied']} from the record; the traced run's "
                  f"explicit --decode_chunk won ({prov_on['applied']})")
    del splits
    shutil.rmtree(TELEMETRY_ROOT, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"telemetry phase: {seconds:.1f} s (budget "
          f"{TELEMETRY_BUDGET_S:.0f} s); armed cost "
          + json.dumps({k: {m: round(v, 3) for m, v in c.items()}
                        for k, c in cost.items()})
          + "; launches "
          + json.dumps({f"{k}/{d}": n for (k, d), n in total.items()}))
    return total

DP_ROOT = os.path.join(HERE, "checkpoints", "chip_smoke_dp")
DP_BUDGET_S = 90.0
# (a): XE steps, then fused CST steps from the XE state.
DP_XE_STEPS, DP_CST_STEPS = 3, 2
# (b): run_dp_pipeline at full width, 8 videos x 20 captions, K1 and K2.
DP_BATCH = 8
DP_CONFIG = {"vocab": 8000, "hidden": 512, "seq_per_img": TRAIN_SEQ,
             "max_len": MAX_LEN, "feat_shapes": [(28, 2048), (1, 4096)]}
# (c): SP at B = 64 over phase 7's T (29, padded to 30 and masked) and at
# T = 4096; the CP step on phase 16's transformer (8 heads, 2 layers) with
# a time-sharded long stream (254 x 2048) and clip vectors (2 x 4096):
# both T and the memory's 256 divide the 2 ranks.
SP_B, SP_LQ, SP_D, SP_T_LONG = 64, 4, 64, 4096
CP_BATCH = 4
CP_CONFIG = {"vocab": 8000, "hidden": 512, "heads": 8, "layers": 2,
             "max_len": MAX_LEN, "seq_per_img": TRAIN_SEQ, "lr": 1e-2,
             "feat_shapes": [(254, 2048), (2, 4096)]}
CP_LOSS_TOL, CP_PARAM_TOL = 1e-5, 2e-5
# (b)'s parameters after 4 updates (lr 1e-3), held to the reference
# test's elementwise bound (rtol 1e-4, atol 1e-6) under SGD.  Under Adam
# a few elements fall outside it: where the first update's gradient is
# near Adam's eps (1e-8), the sum of two half batches differs from the
# whole batch's in its last bits by a few percent of itself, and
# m / (sqrt(v) + eps) carries that into the update.  Those may number at
# most DP_OUTLIERS of all the elements (about 3 times the 1.29e-5, 207 of
# 16,069,440, that every card run has read), every element stays within
# DP_STEP_FRACTION of one step (lr), and Adam replayed at them from each
# run's reduced gradients must reproduce their gap within PARAM_ATOL.
PARAM_RTOL, PARAM_ATOL, DP_OUTLIERS, DP_STEP_FRACTION = 1e-4, 1e-6, 4e-5, 0.05
DP_LR = 1e-3
# The device of phase 18's ranks (the CPU in a rehearsal).
DP_DEVICE = "cuda"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_twin(splits, name: str, group_flags) -> dict:
    """Phase 18 (a), one run through the train CLI's parser and
    ``Trainer`` on phase 7's split and width: ``DP_XE_STEPS`` XE steps,
    the state saved, then ``DP_CST_STEPS`` fused CST steps started from
    it; with ``group_flags`` inside the process group ``train.py`` starts
    for them.  -> per-step losses, ms/step, the final parameters and
    optimizer state (host copies), the launches and the backend."""
    import shutil

    import torch
    import torch.distributed as dist

    from cst_captioning_tpu_torch import train
    from cst_captioning_tpu_torch.parallel.dp import distributed_init
    from cst_captioning_tpu_torch.training import checkpoint

    root = os.path.join(DP_ROOT, name)
    shutil.rmtree(root, ignore_errors=True)
    opt = train.parse_args(stage_args(
        "--checkpoint_path", os.path.join(root, "xe"), *group_flags))
    started = distributed_init(opt.coordinator_address, opt.num_processes,
                               opt.process_id, device=opt.device or "cuda")
    try:
        backend = dist.get_backend() if started else None
        xe = smoke_trainer(opt, splits)
        xe_steps = timed_steps(xe, DP_XE_STEPS, expect_launches(MAX_LEN))
        start = os.path.join(root, "xe_state")
        checkpoint.CheckpointManager(start).save(
            xe.step, xe.checkpoint_payload(), score=0.0)
        grouped = xe.dp is not None
        del xe
        cst = smoke_trainer(train.parse_args(stage_args(
            "--use_rl", "1", "--rl_baseline", "greedy", "--learning_rate",
            "2e-5", "--start_from", start, "--checkpoint_path",
            os.path.join(root, "cst"), *group_flags)), splits)
        cst_steps = timed_steps(cst, DP_CST_STEPS,
                                expect_launches(MAX_LEN, 2))
        grouped = grouped and cst.dp is not None
        state = ([p.detach().cpu().clone() for p in cst.model.parameters()]
                 + [v.detach().cpu().clone() for st in cst.optimizer.state
                    for v in st.values()]
                 + [cst.optimizer.count.detach().cpu().clone()])
        del cst
    finally:
        if started:
            dist.destroy_process_group()
    steps = xe_steps + cst_steps
    launches = {k: sum(n[k] for _, _, n in steps)
                for k in ("fused_additive_attention", "fused_decode_cell")}
    return {"losses": [float(m["loss"]) for _, done, _ in steps
                       for _, m in done],
            "xe_ms": [s * 1e3 for s, _, _ in xe_steps],
            "cst_ms": [s * 1e3 for s, _, _ in cst_steps],
            "state": state, "launches": launches, "backend": backend,
            "grouped": grouped}


def sp_inputs(seed: int = 18) -> dict:
    """(c)'s global SP inputs: dot attention at T = 4096 (row 0 attends
    to its first 100 steps only), 8 heads of 64 at T = 256, and the
    additive attention at phase 7's width over T = 29 padded to 30 (the
    pad masked)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    mask = np.ones((8, SP_T_LONG), bool)
    mask[0, 100:] = False
    amask = np.ones((SP_B, T_MEM + 1), bool)
    amask[:, T_MEM] = False
    return {"q": r(8, SP_LQ, SP_D), "k": r(8, SP_T_LONG, SP_D),
            "v": r(8, SP_T_LONG, SP_D), "mask": mask,
            "q4": r(8, SP_LQ, 8, 64), "k4": r(8, 256, 8, 64),
            "v4": r(8, 256, 8, 64),
            "qp": r(SP_B, A) * 0.5, "mem": r(SP_B, T_MEM + 1, H),
            "pm": r(SP_B, T_MEM + 1, A) * 0.5, "sv": r(A) * 0.1,
            "amask": amask}


def full_attention(q, k, v, mask=None):
    """One rank's attention over the whole T, float32 on the device."""
    import torch

    s = torch.einsum("bqd,btd->bqt", q, k) / q.shape[-1] ** 0.5
    if mask is not None:
        s = s.masked_fill(~mask[:, None, :], -1e30)
    return torch.einsum("bqt,btd->bqd", torch.softmax(s, dim=-1), v)


def cp_inputs(seed: int = 19):
    """(c)'s CP step: seeded transformer weights and a global batch."""
    import numpy as np
    import torch

    from cst_captioning_tpu_torch.models.captioner import CaptionModel
    from cst_captioning_tpu_torch.weights import init_like_flax_

    cfg = CP_CONFIG
    model = CaptionModel(
        cfg["vocab"], [d for _, d in cfg["feat_shapes"]],
        embed_size=cfg["hidden"], hidden_size=cfg["hidden"],
        attn_size=cfg["hidden"], drop_prob=0.0, decoder_type="transformer",
        num_heads=cfg["heads"], num_tx_layers=cfg["layers"],
        tx_max_len=cfg["max_len"] + 1)
    init_like_flax_(model, torch.Generator().manual_seed(seed))
    params = {k: v.numpy() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed)
    x = {f"feats{m}": rng.standard_normal((CP_BATCH,) + s).astype(
        np.float32) for m, s in enumerate(cfg["feat_shapes"])}
    x["labels"] = rng.integers(1, cfg["vocab"], (
        CP_BATCH * cfg["seq_per_img"], cfg["max_len"])).astype(np.int32)
    x["labels"][::3, 10:] = 0           # captions of mixed lengths
    return params, x


def adam_outliers(one: dict, two: dict, out: dict):
    """Phase 18 (b) under Adam: at the elements ``out`` marks (outside
    the elementwise bound), each update's reduced gradient g of the
    one-rank run, the relative gap between the two runs' g, and the gap
    between the normalised updates u = m / (sqrt(v) + eps) that Adam,
    replayed there in float32 from each run's gradients (the global-norm
    clip included), makes of them, against the gradients over all
    elements.  -> (the reading, the largest gap the replay leaves
    unexplained)."""
    import numpy as np

    from cst_captioning_tpu_torch.training.state import B1, B2, EPS

    names = sorted(out)

    def at(d, where=True):
        return np.concatenate([d[k][out[k]] if where else d[k].ravel()
                               for k in names])

    def replay(grads):
        mu = nu = np.float32(0.0)
        us, gs = [], []
        for t, g in enumerate(grads, 1):
            norm = np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64)))
                               for v in g.values()))
            x = at(g)
            if norm >= 5.0:             # the pipeline's grad_clip
                x = x / np.float32(norm) * np.float32(5.0)
            mu = np.float32(1 - B1) * x + np.float32(B1) * mu
            nu = np.float32(1 - B2) * x * x + np.float32(B2) * nu
            us.append((mu / np.float32(1 - B1 ** t))
                      / (np.sqrt(nu / np.float32(1 - B2 ** t))
                         + np.float32(EPS)))
            gs.append(x)
        return us, gs

    if not any(o.any() for o in out.values()):
        return "no element outside the bound", 0.0
    (u1, g1), (u2, g2) = replay(one["grads"]), replay(two["grads"])
    seen = at(one["params"]) - at(two["params"])
    made = DP_LR * sum(b - a for a, b in zip(u1, u2))

    def fmt(xs):
        return "[" + ", ".join(f"{x:.3g}" for x in xs) + "]"

    def rel_gap(a, b):
        return np.median(np.abs(a - b) / np.maximum(np.abs(a), 1e-30))

    g_all = [at(g, False) for g in one["grads"]]
    gap_all = [rel_gap(a, at(b, False))
               for a, b in zip(g_all, two["grads"])]
    residual = float(np.max(np.abs(seen - made)))
    sgd = DP_LR * np.max(np.abs(sum(a - b for a, b in zip(g1, g2))))
    return (
        f"{seen.size} elements, their gap max {np.max(np.abs(seen)):.3g}; "
        f"Adam replayed there from each run's reduced gradients gives a "
        f"gap max {np.max(np.abs(made)):.3g} (max residual {residual:.3g});"
        f" SGD on the same gradients would give max {sgd:.3g}. By update: "
        f"|g| median {fmt(np.median(np.abs(g)) for g in g1)} there against "
        f"{fmt(np.median(np.abs(g)) for g in g_all)} over all elements; the "
        f"runs' relative gradient gap median "
        f"{fmt(rel_gap(a, b) for a, b in zip(g1, g2))} there against "
        f"{fmt(gap_all)}; |u| gap max "
        f"{fmt(np.max(np.abs(a - b)) for a, b in zip(u1, u2))} steps "
        f"(Adam's eps {EPS:g})"), residual


def cp_step(mesh, cfg: dict, params: dict, x: dict, device: str) -> dict:
    """One SGD XE step of phase 16's transformer (``cfg``: ``CP_CONFIG``
    in the smoke; a spawned rank reads no global of this module) from
    ``params`` on the global batch ``x`` (``cp_inputs``): context-parallel
    over the mesh's model axis with the long modality time-sharded where
    the axis has two ranks, the plain step on one -> the loss and the
    updated parameters (numpy)."""
    import torch

    from cst_captioning_tpu_torch.models.captioner import CaptionModel
    from cst_captioning_tpu_torch.parallel import (DataParallel,
                                                   context_parallel_xe_step,
                                                   time_shard_memory)
    from cst_captioning_tpu_torch.training.state import Optimizer
    from cst_captioning_tpu_torch.training.steps import xe_step

    dev = torch.device(device)
    shapes = cfg["feat_shapes"]
    model = CaptionModel(
        cfg["vocab"], [d for _, d in shapes], embed_size=cfg["hidden"],
        hidden_size=cfg["hidden"], attn_size=cfg["hidden"], drop_prob=0.0,
        decoder_type="transformer", num_heads=cfg["heads"],
        num_tx_layers=cfg["layers"], tx_max_len=cfg["max_len"] + 1)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    model.to(dev)
    opt = Optimizer(model.parameters(), "sgd", learning_rate=cfg["lr"])
    feats = [torch.from_numpy(x[f"feats{m}"]).to(dev)
             for m in range(len(shapes))]
    labels = torch.from_numpy(x["labels"]).long().to(dev)
    weights = torch.ones(labels.shape[0], device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    if mesh.model.size > 1:
        model.shard_time(time_shard_memory(mesh, [t for t, _ in shapes],
                                           (True, False)))
        m = context_parallel_xe_step(model, opt, feats, labels, weights,
                                     cfg["seq_per_img"], gen,
                                     DataParallel(mesh))
    else:
        m = xe_step(model, opt, feats, labels, weights, cfg["seq_per_img"],
                    gen)
    return {"loss": float(m["loss"]),
            "params": {k: v.detach().cpu().numpy()
                       for k, v in model.state_dict().items()}}


def sp_cp_rank(mesh, x: dict, cfg: dict, params: dict, cx: dict,
               device: str):
    """Phase 18 (c) on one rank of the (1, 2) mesh: the SP ops on the
    global inputs ``x`` (``sp_inputs``), gathered whole: the dot
    attention by the combine and by the ring, with and without its mask,
    and the additive attention over the ragged T; then the CP step
    (``cp_step``).  -> (their results, the CP step's)."""
    import torch

    from cst_captioning_tpu_torch.parallel import (sp_additive_attention,
                                                   sp_cross_attention,
                                                   time_sharding)

    t = {k: torch.from_numpy(v).to(torch.device(device))
         for k, v in x.items()}
    out = {}
    for tag, ring in (("dot", False), ("ring", True)):
        out[tag] = sp_cross_attention(t["q"], t["k"], t["v"], mesh,
                                      ring=ring)
        out[f"{tag}_masked"] = sp_cross_attention(
            t["q"], t["k"], t["v"], mesh, mask=t["mask"], ring=ring)
    rows, times = time_sharding(mesh, t["qp"].shape[0], t["mem"].shape[1])
    local = sp_additive_attention(
        t["qp"][rows], t["mem"][rows, times], t["pm"][rows, times],
        t["sv"], mesh.model, mask=t["amask"][rows, times])
    out["additive"] = torch.cat(mesh.data.all_gather(local.contiguous()))
    return ({k: v.cpu().numpy() for k, v in out.items()},
            cp_step(mesh, cfg, params, cx, device))


def live_children() -> list:
    """The pids of this process's children that still run (read from
    ``/proc``), but for multiprocessing's resource tracker, which lives
    as long as this process once a spawned rank has started."""
    me, pids = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[1]) != me or fields[0] == "Z":
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if b"resource_tracker" not in cmd:
            pids.append(int(name))
    return pids


def dp_phase(splits) -> dict:
    """Phase 18: data and context parallelism on the card.  -> {kernel:
    launches of (a) and (b)}."""
    import numpy as np
    import torch

    from cst_captioning_tpu_torch.ops import attention_kernel as k1
    from cst_captioning_tpu_torch.parallel import dryrun, make_mesh

    t_phase = time.perf_counter()
    card = card_line()
    before = set(live_children())
    # (a) the train CLI in a one-rank NCCL group against the same run
    # without the group flags.
    t0 = time.perf_counter()
    plain = dp_twin(splits, "plain", ())
    group = ("--num_processes", "1", "--process_id", "0",
             "--coordinator_address", f"127.0.0.1:{free_port()}")
    nccl = dp_twin(splits, "nccl", group)
    same_losses = plain["losses"] == nccl["losses"]
    same_state = all(torch.equal(a, b) for a, b in zip(plain["state"],
                                                       nccl["state"]))
    print(f"phase 18 (a): {DP_XE_STEPS} XE + {DP_CST_STEPS} fused CST "
          f"steps, backend {nccl['backend']} at world size 1 "
          f"(data parallel: {nccl['grouped']}): losses bitwise equal "
          f"{same_losses} {nccl['losses']}; {len(nccl['state'])} "
          f"parameter and optimizer tensors bitwise equal {same_state}; "
          f"launches {nccl['launches']} ({time.perf_counter() - t0:.1f} s)")
    if nccl["backend"] != ("nccl" if DP_DEVICE == "cuda" else "gloo") \
            or not nccl["grouped"] or plain["grouped"]:
        fail(f"phase 18 (a): the group run did not run data-parallel over "
             f"NCCL: {nccl['backend']}, {nccl['grouped']}")
    if not (same_losses and same_state):
        fail(f"phase 18 (a): the one-rank group differs from the run "
             f"without it: {plain['losses']} vs {nccl['losses']}")
    for name, ms in (("without the group", plain),
                     ("in the one-rank NCCL group", nccl)):
        print(f"phase 18 (d) [{card}]: train CLI {name}: XE ms/step "
              f"{[round(x, 3) for x in ms['xe_ms']]}, fused CST ms/step "
              f"{[round(x, 3) for x in ms['cst_ms']]}")

    # (b) two ranks sharing the card over gloo against one rank, under
    # Adam and under SGD.
    t0 = time.perf_counter()
    kw = dict(batch_size=DP_BATCH, xe_steps=2, decode_kernel="fused",
              kernel_attention=True, config=DP_CONFIG, device=DP_DEVICE,
              decode_chunk=CHUNK)
    runs = {}
    for optim in ("adam", "sgd"):
        runs[optim] = (
            dryrun.run_dp_pipeline(1, optim=optim, grads=optim == "adam",
                                   **kw),
            dryrun.run_dp_pipeline(2, backend="gloo", optim=optim,
                                   grads=optim == "adam", **kw))
    for optim, (one, two) in runs.items():
        errs = {k: abs(two[k] - one[k]) / max(abs(one[k]), 1e-12)
                for k in ("rl_loss", "fused_loss", "fused_reward")}
        errs["xe_losses"] = max(abs(a - b) / abs(b) for a, b in
                                zip(two["xe_losses"], one["xe_losses"]))
        param_err = max(float(np.max(np.abs(two["params"][k]
                                            - one["params"][k])))
                        for k in one["params"])
        out = {k: ~np.isclose(two["params"][k], one["params"][k],
                              rtol=PARAM_RTOL, atol=PARAM_ATOL)
               for k in one["params"]}
        outliers = sum(int(o.sum()) for o in out.values()) / sum(
            v.size for v in one["params"].values())
        params_ok = (outliers == 0 if optim == "sgd" else
                     outliers <= DP_OUTLIERS
                     and param_err <= DP_STEP_FRACTION * DP_LR)
        tokens = (np.array_equal(two["sampled"], one["sampled"])
                  and np.array_equal(two["greedy"], one["greedy"]))
        print(f"phase 18 (b) {optim}: run_dp_pipeline(2) (gloo, one card) "
              f"against run_dp_pipeline(1) at B = {DP_BATCH} x "
              f"{DP_CONFIG['seq_per_img']}, K1 and K2: tokens bitwise equal "
              f"{tokens}; relative errors {errs}; parameters: share of all "
              f"elements outside rtol {PARAM_RTOL} / atol {PARAM_ATOL} "
              f"{outliers:.3g} (at most "
              f"{0 if optim == 'sgd' else DP_OUTLIERS}), max abs difference "
              f"{param_err:.3g}; ranks agree {two['ranks_agree']}; "
              f"launches 1 rank {one['launches']}, 2 ranks "
              f"{two['launches']}")
        if optim == "adam":
            reading, residual = adam_outliers(one, two, out)
            print(f"phase 18 (b) adam, outside the bound: {reading}")
            params_ok = params_ok and residual <= PARAM_ATOL
        for n, r in ((1, one), (2, two)):
            # every rank: K1 on each teacher-forced step (the XE steps,
            # the RL step and the fused step's recompute), K2 twice a
            # decode step of both rollouts
            want = {"fused_additive_attention":
                    n * DP_CONFIG["max_len"] * (kw["xe_steps"] + 2),
                    "fused_decode_cell": n * 2 * int(
                        r["rollout_steps"] + r["fused_rollout_steps"])}
            got = {k: r["launches"][k] for k in want}
            if got != want:
                fail(f"phase 18 (b) {optim}: launches at {n} rank(s) "
                     f"{got}, expected {want}")
        if not (tokens and two["ranks_agree"] and max(errs.values()) <= TOL
                and params_ok):
            fail(f"phase 18 (b) {optim}: 2 ranks differ from 1: tokens "
                 f"{tokens}, errors {errs}, parameters {param_err}, "
                 f"outside the bound {outliers}")
    # The SGD pair's times: the Adam pair copies every update's gradients
    # to the host.
    one, two = runs["sgd"]
    for name, r in (("1 rank", one), ("2 ranks", two)):
        print(f"phase 18 (d) [{card}]: run_dp_pipeline {name} (SGD) ms: "
              + json.dumps({k: [round(x, 3) for x in v]
                            for k, v in r["step_ms"].items()})
              + ("  (two ranks share one card through host-staged gloo: "
                 "a wiring check, not a scaling figure)" if r is two
                 else ""))
    print(f"phase 18 (b): {time.perf_counter() - t0:.1f} s")

    # (c) SP ops and the CP transformer XE step over 2 ranks.
    t0 = time.perf_counter()
    x = sp_inputs()
    params, cx = cp_inputs()
    sp, cp = dryrun.run_ranks(2, sp_cp_rank, x, CP_CONFIG, params, cx,
                              DP_DEVICE, model_parallel=2, device=DP_DEVICE,
                              backend="gloo")[0]
    ref_cp = cp_step(make_mesh(), CP_CONFIG, params, cx, DP_DEVICE)
    dev = torch.device(DP_DEVICE)
    t = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
    k1_ctx, _ = k1.fused_additive_attention(
        t["qp"], t["pm"][:, :T_MEM].contiguous(),
        t["mem"][:, :T_MEM].contiguous(), t["sv"])
    want = {"additive": k1_ctx,
            "dot": full_attention(t["q"], t["k"], t["v"]),
            "dot_masked": full_attention(t["q"], t["k"], t["v"], t["mask"])}
    want["ring"], want["ring_masked"] = want["dot"], want["dot_masked"]
    sp_err = {k: float(np.max(np.abs(sp[k] - w.cpu().numpy())))
              for k, w in want.items()}
    cp_loss_err = abs(cp["loss"] - ref_cp["loss"])
    cp_param_err = max(float(np.max(np.abs(cp["params"][k]
                                           - ref_cp["params"][k])))
                       for k in ref_cp["params"])
    print(f"phase 18 (c): SP over 2 ranks, max abs errors against K1 on "
          f"the whole T = {T_MEM} (additive, B = {SP_B}) and one rank's "
          f"full attention (T = {SP_T_LONG}): {sp_err}; CP transformer XE "
          f"step (T = {' + '.join(str(t) for t, _ in CP_CONFIG['feat_shapes'])}"
          f" over 2 ranks): loss {cp['loss']:.6f} against "
          f"{ref_cp['loss']:.6f} (error {cp_loss_err:.3g}), parameters "
          f"within {cp_param_err:.3g} ({time.perf_counter() - t0:.1f} s)")
    if max(sp_err.values()) > TOL or not np.isfinite(cp["loss"]) \
            or cp_loss_err > CP_LOSS_TOL or cp_param_err > CP_PARAM_TOL:
        fail(f"phase 18 (c): SP {sp_err}, CP loss {cp_loss_err}, CP "
             f"parameters {cp_param_err}")
    # Every rank process has exited: the fleets of phases 13-15 that come
    # next share the card with nothing of this phase.
    left = [pid for pid in live_children() if pid not in before]
    print(f"phase 18: child processes it left running: {left} (running "
          f"before it: {sorted(before)})")
    if left:
        fail(f"phase 18 left child processes running: {left}")
    torch.cuda.empty_cache()   # the fleets of phases 13-15 come next
    seconds = time.perf_counter() - t_phase
    launches = {k: plain["launches"][k] + nccl["launches"][k]
                + sum(r["launches"][k] for pair in runs.values() for r in pair)
                for k in ("fused_additive_attention", "fused_decode_cell")}
    print(f"phase 18: {seconds:.1f} s (budget {DP_BUDGET_S:.0f} s); "
          f"launches {launches}")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "cst_captioning_tpu_torch")):
        print("chip_smoke: no cst_captioning_tpu_torch package beside "
              "this script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    # A tuning record on the machine never moves phases 1-16 or their
    # children; phase 17 gives its processes a record of its own.
    os.environ["CST_TUNED_CONFIGS_TORCH"] = ""
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

    lint = lint_start()
    t0 = time.perf_counter()
    built = _cuda.build()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          + json.dumps({n: round(b["seconds"], 2) for n, b in built.items()}))
    for name, b in built.items():
        for ln in b["ptxas"].splitlines():
            print(f"build {name}: {ln.strip()}")
    lint_check(lint)

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
    e_launch, e_scores, e_preds = eval_phase(splits, measured)

    # Phase 10: preemption, the wedge watchdog and resume through the
    # train CLI, each resumed run bit-identical to its twin.
    resume_launch = resume_phase()

    # Phase 11: the port's bench, its serving and data stages.
    bench_launch = bench_phase(scored, bf16_measured)
    del scored

    # Phase 12: train, evaluate and serve from split files.
    f_launch = files_phase(splits, e_scores, e_preds)

    # Phase 16: the model variants (transformer, manet, 2-layer, pooled,
    # --remat_cell) on phase 7's split, K1 and K2 at manet's T = 2.
    v_launch, v_measured = variants_phase(splits)

    # Phase 18: data and context parallelism (the train CLI in a one-rank
    # NCCL group, two gloo ranks sharing the card, SP and the CP step).
    dp_launch = dp_phase(splits)
    del splits

    # Phase 13: serving, the rest (streams, the cache, the ladder,
    # deadlines, the socket CLI and its exits), on K2.
    rest_launch = rest_phase(greedy_caps, beam_caps)

    # Phase 14: the fleet (K2 batch invariance, replicas on one card, a
    # kill, a restart, the CLI's exit 124, lifecycle on and off, the
    # bench's fleet record).
    fleet_launch = fleet_phase(greedy_caps, ref_caps)

    # Phase 15: the process fleet (serve-CLI children under the
    # supervisor: plain serving, a kill, a wedge and a preempt, the
    # journal, the autoscaler, the fleet plane, every replica dead).
    proc_launch = process_fleet_phase(greedy_caps, ref_caps)

    # Phase 17: training telemetry (spans, step phases, the profiler
    # window, TensorBoard, --debug_nans) and the autotuner, through the
    # train and tune CLIs; the stage probe.
    tel_launch = telemetry_phase()

    # The kernels line: one entry per kernel and storage dtype.  Launches:
    # float32 from phases 4-7, 9, 10, 12-18, bfloat16 from phases 8, 11,
    # 14g and 17 (the tune CLI; phase 16 launches none in bfloat16);
    # times at B=8, the
    # greedy serving batch (8-slot bucket), every measured batch under
    # ``by_batch``.
    launches = {
        ("K1", "float32"): v_launch[("K1", "float32")]
        + r_launch["fused_additive_attention"]
        + t_launch["fused_additive_attention"]
        + resume_launch["fused_additive_attention"]
        + f_launch["fused_additive_attention"] + fleet_launch["K1"]
        + proc_launch["K1"] + tel_launch[("K1", "float32")]
        + dp_launch["fused_additive_attention"],
        ("K2", "float32"): v_launch[("K2", "float32")]
        + g_launch["fused_decode_cell"]
        + beam_launch["fused_decode_cell"]
        + t_launch["fused_decode_cell"] + e_launch
        + resume_launch["fused_decode_cell"]
        + f_launch["fused_decode_cell"] + rest_launch + fleet_launch["K2"]
        + proc_launch["K2"] + tel_launch[("K2", "float32")]
        + dp_launch["fused_decode_cell"],
        ("K1", "bfloat16"): v_launch[("K1", "bfloat16")]
        + s_launch["fused_additive_attention/bfloat16"]
        + bt_launch["fused_additive_attention/bfloat16"]
        + bench_launch["fused_additive_attention"]
        + tel_launch[("K1", "bfloat16")],
        ("K2", "bfloat16"): v_launch[("K2", "bfloat16")]
        + s_launch["fused_decode_cell/bfloat16"]
        + bt_launch["fused_decode_cell/bfloat16"]
        + bench_launch["fused_decode_cell"] + fleet_launch["K2_bf16"]
        + tel_launch[("K2", "bfloat16")],
    }
    meta = {
        "K1": ("fused_additive_attention", "cst_captioning_tpu_torch/csrc/"
               "attention.cu", "cst_captioning_tpu/ops/pallas_attention.py:86"),
        "K2": ("fused_decode_cell", "cst_captioning_tpu_torch/csrc/"
               "decode_cell.cu",
               "cst_captioning_tpu/ops/pallas_decode_cell.py:139"),
    }
    # K2's gate launches by gate kernel, from phase 7 (float32: training,
    # its rollouts and validation) and phase 8 (bfloat16 training).
    gates = {"float32": ("phase 7", gate_totals(t_launch)),
             "bfloat16": ("phase 8", gate_totals(bt_launch))}
    kernels = []
    for (key, dtype), n in launches.items():
        name, source, replaces = meta[key]
        res = measured if dtype == "float32" else bf16_measured
        res[key].update(v_measured[dtype][key])
        m = res[key][8]
        extra = ({"gate_launches": gates[dtype][1],
                  "gate_launches_from": gates[dtype][0]}
                 if key == "K2" else {})
        kernels.append({
            **extra, "name": name if dtype == "float32" else f"{name}_bf16",
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
