"""Summarise a ``--profile_dir`` window: the top device kernels and CPU
ops by total time (the port's counterpart of the reference's
``scripts/profile_top.py``, which reads JAX xplane files).

    python -m cst_captioning_tpu_torch.tools.profile_top PROFILE_DIR [--top 15]
    python -m cst_captioning_tpu_torch.tools.profile_top profile_X.json --json

The trainer's ``--profile_dir``/``--profile_start``/``--profile_steps``
window writes a ``torch.profiler`` Chrome trace,
``profile_<pid>_steps<a>-<b>.json`` (``training/trainer.py``).  Given a
directory, this reads the newest such file under it (by modification
time); given a file, that file.  It prints:

- the top ``--top`` device kernels (events of category ``kernel``) by
  total time, each with its count, total and mean in microseconds;
- the top ``--top`` CPU ops (category ``cpu_op``) the same way.  CPU ops
  nest (``aten::linear`` holds its ``aten::addmm``), so an op's total
  includes its children's;
- the window's span (first event's start to last event's end) and the
  device-busy share of it: the union of the kernel, copy and memset
  intervals over the span (0 for a CPU run, which has no device events).

``--top 0`` lists every name.  ``--json`` prints one JSON object instead.
A path with no trace is a usage error: one line on stderr, exit 2
(``resilience/exitcodes.py``'s ``EXIT_USAGE``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from ..resilience.exitcodes import EXIT_OK

#: Event categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace(path: str) -> Optional[str]:
    """``path`` itself when it is a file; else the newest
    ``profile_*.json`` under it (None when there is none)."""
    if os.path.isfile(path):
        return path
    hits = glob.glob(os.path.join(path, "**", "profile_*.json"),
                     recursive=True)
    if not hits:
        return None
    return max(hits, key=lambda p: (os.path.getmtime(p), p))


def _table(events: Iterable[dict], top: int) -> Tuple[List[dict], int]:
    """Per-name count, total and mean (µs) of ``events``, by total
    descending (ties by name) -> (the first ``top`` rows, or all for
    ``top`` <= 0; the number of distinct names)."""
    tot: Dict[str, float] = {}
    cnt: Dict[str, int] = {}
    for e in events:
        name = e.get("name", "")
        tot[name] = tot.get(name, 0.0) + float(e.get("dur", 0.0))
        cnt[name] = cnt.get(name, 0) + 1
    rows = [{"name": n, "count": cnt[n], "total_us": tot[n],
             "mean_us": tot[n] / cnt[n]}
            for n in sorted(tot, key=lambda n: (-tot[n], n))]
    return (rows[:top] if top > 0 else rows), len(rows)


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of ``[start, end)`` intervals."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def summarize(events: List[dict], top: int = 15) -> dict:
    """The summary of one trace's ``traceEvents`` (see the module doc)."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") != "Trace"
             and isinstance(e.get("ts"), (int, float))]
    kernels, n_kernels = _table(
        (e for e in spans if e.get("cat") == "kernel"), top)
    cpu_ops, n_cpu_ops = _table(
        (e for e in spans if e.get("cat") == "cpu_op"), top)
    span_us = 0.0
    if spans:
        span_us = (max(e["ts"] + e.get("dur", 0.0) for e in spans)
                   - min(e["ts"] for e in spans))
    busy_us = _union_us([(e["ts"], e["ts"] + e.get("dur", 0.0))
                         for e in spans if e.get("cat") in DEVICE_CATS])
    return {"span_us": span_us, "device_busy_us": busy_us,
            "device_busy_share": busy_us / span_us if span_us else 0.0,
            "kernels": kernels, "distinct_kernels": n_kernels,
            "cpu_ops": cpu_ops, "distinct_cpu_ops": n_cpu_ops}


def render(path: str, s: dict) -> str:
    lines = [f"profile_top: {path}",
             f"window {s['span_us'] / 1e3:.3f} ms, device busy "
             f"{s['device_busy_us'] / 1e3:.3f} ms "
             f"({s['device_busy_share']:.3f} of the window)"]
    for title, rows, n in (("device kernels", s["kernels"],
                            s["distinct_kernels"]),
                           ("CPU ops", s["cpu_ops"], s["distinct_cpu_ops"])):
        lines.append(f"== {title}: top {len(rows)} of {n} by total time ==")
        if rows:
            lines.append(f"  {'total us':>12s} {'count':>7s} "
                         f"{'mean us':>10s}  name")
        for r in rows:
            lines.append(f"  {r['total_us']:12.3f} {r['count']:7d} "
                         f"{r['mean_us']:10.3f}  {r['name'][:100]}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cst_captioning_tpu_torch.tools.profile_top",
        description="top device kernels and CPU ops of a torch.profiler "
                    "window")
    p.add_argument("trace", help="a --profile_dir directory or a "
                                 "profile_*.json file")
    p.add_argument("--top", type=int, default=15,
                   help="rows per table (0: every name)")
    p.add_argument("--json", action="store_true",
                   help="one JSON object on stdout")
    args = p.parse_args(argv)

    path = find_trace(args.trace)
    if path is None:
        p.error(f"no profile_*.json under {args.trace!r}: was the run "
                "given --profile_dir?")
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    except (OSError, ValueError, KeyError, TypeError) as e:
        p.error(f"cannot read a Chrome trace from {path!r}: {e}")
    s = summarize(events, args.top)
    if args.json:
        print(json.dumps({"trace": os.path.abspath(path), **s}))
    else:
        print(render(path, s))
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
