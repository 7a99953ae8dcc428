"""The benchmark of ``cst_captioning_tpu_torch`` on one NVIDIA H100: one
run of one cell.

    python3 benchmark/run.py --workload attlstm-cst --seed 7 --seconds 40 --trace 0

From the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the run makes the
split and the weights from ``--seed``, builds the port's ``Trainer`` with
the cell's options, runs its first steps (which the comparison judges)
and a warm-up, measures a closed loop of training steps for ``--seconds``,
and with ``--trace 1`` traces a few more steps with ``torch.profiler``.
Then it frees the program, runs the plain reference over the first steps
and compares.

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (the window's steps, and those the
divergence guard skipped), ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number of the comparison with
its limit, which also end standard error.  Without a CUDA device, or with
fewer than the cell's chips, it prints no result and exits 2; if
``jax``, ``jaxlib``, ``flax``, ``optax`` or the JAX package is loaded
once the window has closed, it exits 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")

#: Top-level module names the run must not have loaded: JAX and the JAX
#: package the port was made from (compared whole: the port's name
#: begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cst_captioning_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [ROOT, HERE]

    import torch

    from cstbench import session, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"no result: the cell needs {cell.chips} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seed = args.seed % (1 << 62)
    peak = cell.config["peak_tflops"]
    print(f"card: {power_limit()}; peak {peak} TFLOP/s "
          f"({cell.config['precision']}), 3.35 TB/s", flush=True)

    rec = session.run(cell, seed, args.seconds, bool(args.trace), device,
                      T0)
    print("knobs: " + json.dumps(rec.knobs), flush=True)
    print("setup: " + json.dumps(rec.setup_parts), file=sys.stderr)
    if rec.step_ms:
        q = sorted(rec.step_ms)
        print(f"window: {rec.steps} steps, step ms p50 {q[len(q) // 2]:.3f} "
              f"max {q[-1]:.3f}, gc collections {rec.gc_collections}",
              file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"no result: the run loaded {found}", file=sys.stderr)
        return 3

    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = m.read(rec)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    limits = cell.limits["limits"]
    compared = {k: {"value": rec.numbers.get(k), "limit": limits.get(k)}
                for k in sorted(set(limits) | set(rec.numbers))}
    result = {
        "correct": session.check.verdict(rec.numbers, limits),
        "attempted": rec.steps,
        "failed": sum(int(v.get("bad_step", 0)) for v in rec.values),
        "metrics": metrics,
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips,
                   "memory_peak_bytes": rec.memory_peak_bytes}}
    if rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops,
                               "idle_gaps": rec.trace.idle_gaps}
    result["compared"] = compared
    for k, v in compared.items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
