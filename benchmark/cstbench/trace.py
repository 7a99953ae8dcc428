"""The traced segments of a ``--trace 1`` run and their reduction:
``torch.profiler`` windows over a fixed number of training steps, each
written as a Chrome trace and read back (the pattern of the port's
``tools/profile_top.py``).

The device alone is traced first, since tracing the host's operations
slows the host and so stretches the device's idle gaps: from it the
device-busy seconds (the union of kernel, copy and memset intervals
inside the window), the window's length and the device operations that
took most time.  Then the host and the device together: the longest idle
gaps by what the host's main thread was doing (stretched by the
profiler), and the device time of the kernels launched inside each named
range (``bench.k1``, ``bench.k2``: the benchmark's own ranges around the
port's kernel calls), matched through the launches' correlation ids.
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
WINDOW = "bench.trace_window"
TOP = 10
#: Host events searched back from an idle gap for the innermost one.
LOOKBACK = 256


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    #: range name -> (device seconds of its kernels, kernels matched)
    ranges: Dict[str, Tuple[float, int]] = field(default_factory=dict)


def profile(step: Callable[[], None], steps: int, path: str,
            host: bool) -> TraceSummary:
    """Run ``step`` ``steps`` times under the profiler, between two
    device synchronisations, and reduce the trace written to ``path``
    (then removed).  ``host=False`` traces the device alone (what the
    host does costs the profiler's time only with ``host=True``): its
    window is the host's clock between the synchronisations."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, window_s)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events: List[dict], window_s: float = None) -> TraceSummary:
    """The summary of one trace's ``traceEvents`` (times in µs there).
    The window is the ``WINDOW`` range, or else ``window_s`` from the
    first device event (a trace of the device alone)."""
    spans = [e for e in events if e.get("ph") == "X"
             and isinstance(e.get("ts"), (int, float))]
    win = [e for e in spans if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0].get("dur", 0.0))
        main_tid = win[0].get("tid")
    elif window_s is not None and device:
        w0 = min(float(e["ts"]) for e in device)
        w1 = w0 + window_s * 1e6
        main_tid = None
    else:
        raise ValueError(f"the trace has no {WINDOW} range and no device "
                         "event")
    clipped = [(max(float(e["ts"]), w0),
                min(float(e["ts"]) + float(e.get("dur", 0.0)), w1))
               for e in device]
    busy = _union([(a, b) for a, b in clipped if b > a])
    busy_us = sum(b - a for a, b in busy)

    per_op: Dict[str, float] = defaultdict(float)
    for e in device:
        per_op[e.get("name", "")] += float(e.get("dur", 0.0)) / 1e6
    device_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]

    host = sorted((e for e in spans if e.get("tid") == main_tid
                   and e.get("cat") in HOST_CATS
                   and e.get("name") != WINDOW),
                  key=lambda e: float(e["ts"]))
    starts = [float(e["ts"]) for e in host]
    gaps = []
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    per_gap: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        per_gap[_host_doing(host, starts, (a + b) / 2)] += (b - a) / 1e6
    idle_gaps = sorted(per_gap.items(), key=lambda kv: -kv[1])[:TOP]

    kernels_by_corr: Dict[object, List[dict]] = defaultdict(list)
    for e in spans:
        if e.get("cat") == "kernel":
            kernels_by_corr[(e.get("args") or {}).get("correlation")].append(e)
    launches: Dict[object, List[Tuple[float, object]]] = defaultdict(list)
    for e in spans:
        if e.get("cat") in LAUNCH_CATS:
            launches[e.get("tid")].append(
                (float(e["ts"]), (e.get("args") or {}).get("correlation")))
    for lst in launches.values():
        lst.sort(key=lambda x: x[0])
    ranges: Dict[str, Tuple[float, int]] = {}
    for r in (e for e in spans if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("bench.k")):
        a, b = float(r["ts"]), float(r["ts"]) + float(r.get("dur", 0.0))
        sec, n = ranges.get(r["name"], (0.0, 0))
        lst = launches.get(r.get("tid"), [])
        i = bisect.bisect_left(lst, a, key=lambda x: x[0])
        while i < len(lst) and lst[i][0] <= b:
            for k in kernels_by_corr.get(lst[i][1], ()):
                sec += float(k.get("dur", 0.0)) / 1e6
                n += 1
            i += 1
        ranges[r["name"]] = (sec, n)
    return TraceSummary(window_s=(w1 - w0) / 1e6 if win else window_s,
                        busy_s=busy_us / 1e6,
                        device_ops=device_ops, idle_gaps=idle_gaps,
                        ranges=ranges)


def _host_doing(host: List[dict], starts: List[float], t: float) -> str:
    """The innermost host event of the main thread that covers ``t`` (the
    shortest of the last ``LOOKBACK`` to start before it), or ``python``
    when none does."""
    best = None
    i = bisect.bisect_right(starts, t)
    for e in host[max(0, i - LOOKBACK):i]:
        if float(e["ts"]) + float(e.get("dur", 0.0)) >= t and (
                best is None or e.get("dur", 0.0) < best.get("dur", 0.0)):
            best = e
    return "python" if best is None else str(best.get("name", ""))
