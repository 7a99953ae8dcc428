"""Dev runs on one GPU around ``chip_smoke.py``'s phases, outside its main
path: they print no result line.

    python3 chip_dev.py drills N
    python3 chip_dev.py phases [--root DIR]

``drills N``: the kernels built, phase 4 (for its captions) and the whole
of phase 18, then phase 13's drain abort (two signals, exit 143) N times
and phase 15's probes (b)-(g), all at once as phase 15 runs them, N
times: each run's exit and seconds; for a run that fails, the tail of
its stderr and ``nvidia-smi``'s list of the processes on the card; then
one ``drills`` JSON line.  Exit 1 when any run failed.

``phases``: the smoke of the checkout at ``--root`` (default: this one)
through its lint where it has one, the build, phases 4 and 6 (their
captions feed phase 15), 15 and 17, each phase's seconds, then one
``phases`` JSON line.  To compare two commits on one host, unpack the
parent into a directory git ignores and run, in one call, ``phases
--root`` it, ``phases``, ``phases``, ``phases --root`` it.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
EXIT_FAILURE = 1


def load_smoke(root: str):
    """``chip_smoke`` of the checkout at ``root``, its package first on
    the path, or exit 1 without a CUDA device."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.environ["CST_TUNED_CONFIGS_TORCH"] = ""
    import torch

    if not torch.cuda.is_available():
        print("chip_dev: torch.cuda.is_available() is False",
              file=sys.stderr)
        raise SystemExit(EXIT_FAILURE)
    import chip_smoke

    if chip_smoke.HERE != root:
        print(f"chip_dev: chip_smoke came from {chip_smoke.HERE}, not "
              f"{root}", file=sys.stderr)
        raise SystemExit(EXIT_FAILURE)
    return chip_smoke


def build() -> float:
    from cst_captioning_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build()
    return time.perf_counter() - t0


def gpu_processes() -> str:
    """``nvidia-smi``'s list of the processes on the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,process_name,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip() or "(none)"


def child_start_span(path: str):
    """Seconds from the first to the last ``replica K up`` line of a
    supervisor's stderr in ``path``: how long its first child, connected
    and silent, waited for the first health poll (None without two)."""
    with open(os.path.join(path, "stderr.txt")) as f:
        stamps = [datetime.datetime.strptime(m.group(1),
                                             "%Y-%m-%d %H:%M:%S,%f")
                  for m in re.finditer(r"^(\S+ \S+) \S+ INFO supervisor: "
                                       r"replica \d+ up", f.read(), re.M)]
    return ((max(stamps) - min(stamps)).total_seconds()
            if len(stamps) > 1 else None)


def drills(cs, n: int) -> bool:
    """Phase 4 and phase 18, then the two drills ``n`` times each (the
    kill probe checked as phase 15 checks it, the other probes' exits
    printed).  -> whether every run passed."""
    print(f"card: {cs.card_line()}; build {build():.2f} s", flush=True)
    greedy_caps = cs.serve_phase(
        "greedy-fused", ["--decode_kernel", "fused", "--beam_size", "1"],
        16)[3]
    cs.dp_phase(cs.train_splits())
    results = {"drain_abort": [], "kill_probe": []}
    lines = [json.dumps({"id": i, "video_id": f"v{i}"}) + "\n"
             for i in range(8)]
    for i in range(n):
        t0 = time.perf_counter()
        proc = cs.rest_cli(*cs.DRAIN_ABORT_ARGS)
        try:
            d = cs.drain_abort(proc, lines)
            if d["why"] is not None:
                print(f"drill {i + 1}/{n} drain abort FAILED: {d['why']}\n"
                      "the tail of its stderr:\n"
                      + "\n".join(ln for ln in d["err"][-60:] if ln)
                      + "\nprocesses on the card:\n" + gpu_processes())
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        secs = time.perf_counter() - t0
        print(f"drill {i + 1}/{n} phase 13 drain abort: exit {d['rc']}, "
              f"{len(d['out'])} answered rejected_draining, {secs:.1f} s, "
              + ("ok" if d["why"] is None else "FAILED"), flush=True)
        results["drain_abort"].append({"ok": d["why"] is None,
                                       "rc": d["rc"], "seconds": secs})
    for i in range(n):
        shutil.rmtree(cs.PROC_ROOT, ignore_errors=True)
        runs, rcs, ok = {}, {}, False
        t0 = time.perf_counter()
        try:
            rcs = cs.concurrent_probes(
                lambda k: os.path.join(cs.PROC_ROOT, k), runs)
            _, reading, ok = cs.kill_probe(os.path.join(cs.PROC_ROOT, "b"),
                                           rcs["b"], greedy_caps)
            print(reading)
        except SystemExit as e:     # a probe ran past its time (finish)
            print(f"drill {i + 1}/{n}: {e}")
        if not ok:
            print(f"drill {i + 1}/{n} kill probe FAILED; processes on the "
                  "card:\n" + gpu_processes())
        for p in runs.values():
            if p.poll() is None:
                try:
                    os.killpg(p.pid, 9)
                except OSError:
                    pass
                p.wait()
        time.sleep(0.5)
        left = cs.reap_fleet_processes()
        secs = time.perf_counter() - t0
        span = child_start_span(os.path.join(cs.PROC_ROOT, "b"))
        print(f"drill {i + 1}/{n} phase 15 (b)-(g): exits {rcs}, "
              f"{secs:.1f} s, (b)'s children started over {span} s, "
              f"processes left {len(left)}, " + ("ok" if ok else "FAILED"),
              flush=True)
        results["kill_probe"].append({"ok": ok, "exits": rcs,
                                      "seconds": secs, "start_span": span,
                                      "left": len(left)})
    shutil.rmtree(cs.PROC_ROOT, ignore_errors=True)
    print("drills: " + json.dumps(results))
    return all(r["ok"] for rs in results.values() for r in rs)


def phases(cs) -> bool:
    """The lint (where the smoke has one), the build, phases 4, 6, 15 and
    17, each timed; a phase that fails is timed to its failure.  ->
    whether every phase passed."""
    secs, ok = {}, {}
    lint = cs.lint_start() if hasattr(cs, "lint_start") else None
    secs["build"] = round(build(), 2)
    if lint is not None:
        t0 = time.perf_counter()
        cs.lint_check(lint)
        secs["lint_wait"] = round(time.perf_counter() - t0, 2)

    def timed(name, fn):
        t0 = time.perf_counter()
        try:
            out, ok[name] = fn(), True
        except SystemExit:
            out, ok[name] = None, False
        secs[name] = round(time.perf_counter() - t0, 1)
        print(f"chip_dev phase {name}: {secs[name]} s, "
              + ("ok" if ok[name] else "FAILED"), flush=True)
        return out

    greedy = timed("4", lambda: cs.serve_phase(
        "greedy-fused", ["--decode_kernel", "fused", "--beam_size", "1"],
        16))
    ref = timed("6", lambda: cs.serve_phase(
        "greedy-reference-k1", ["--decode_kernel", "reference",
                                "--pallas_attention", "1", "--beam_size",
                                "1"], 16))
    if greedy is not None and ref is not None:
        timed("15", lambda: cs.process_fleet_phase(greedy[3], ref[3]))
    timed("17", cs.telemetry_phase)
    print("phases: " + json.dumps({"root": cs.HERE, "card": cs.card_line(),
                                   "seconds": secs, "ok": ok}), flush=True)
    return all(ok.values()) and len(ok) == 4


def main() -> int:
    ap = argparse.ArgumentParser(description="dev runs around the smoke's "
                                             "phases on one GPU")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("drills", help="repeat the two drills")
    d.add_argument("n", type=int)
    p = sub.add_parser("phases", help="time phases 4, 6, 15 and 17")
    p.add_argument("--root", default=HERE,
                   help="the checkout whose smoke runs (default: this one)")
    args = ap.parse_args()
    if args.cmd == "drills":
        return 0 if drills(load_smoke(HERE), args.n) else EXIT_FAILURE
    return 0 if phases(load_smoke(args.root)) else EXIT_FAILURE


if __name__ == "__main__":
    sys.exit(main())
