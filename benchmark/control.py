"""Readings that the comparison's limits are set from, on the card at each
cell's own size (a separate tool: the benchmark's runs never do this).

    python3 benchmark/control.py --workload attlstm-cst --seeds 12 --others 3

For each cell, in one process: the program's first steps against the
reference on ``--seeds`` seeds (the sound readings: the lower end of each
limit); the control, the program with its bfloat16 path on (the nearest
precision below the configuration's float32), on ``--others`` seeds; and
each fault of the cell's file planted in the program
(``cstbench/faults.py``) on ``--others`` seeds.  No window is measured.
One JSON line a run, then one a cell: per number, the largest sound
reading and the least of the control's and of each fault's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
#: Seeds of the readings: apart from those the benchmark's runs take.
FIRST_SEED = 1_000_003


def readings(cell, seed: int, variant: str, device, shared: dict) -> dict:
    from cstbench import faults, session

    options = {"use_bfloat16": 1} if variant == "control" else None
    plant = faults.PLANTS.get(variant)
    t0 = time.perf_counter()
    rec = session.run(cell, seed, 0, False, device, t0, options=options,
                      plant=plant, shared=shared)
    return {"workload": cell.name, "variant": variant, "seed": seed,
            "seconds": time.perf_counter() - t0, "numbers": rec.numbers}


def summary(rows) -> dict:
    out: dict = {}
    for r in rows:
        for k, v in r["numbers"].items():
            slot = out.setdefault(k, {})
            if r["variant"] == "sound":
                slot["lower"] = max(slot.get("lower", 0.0), v)
            else:
                slot[r["variant"]] = min(slot.get(r["variant"], v), v)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--others", type=int, default=3)
    args = p.parse_args(argv)
    sys.path[:0] = [os.path.dirname(HERE), HERE]
    import torch

    from cstbench import spec

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for name in args.workload:
        cell = spec.load_cell(name)
        # A state left unchanged reads 1 by construction: not run.
        chosen = [f for f in cell.limits["faults"] if f != "state_unchanged"]
        rows = []
        for i in range(args.seeds):
            seed = FIRST_SEED + 7919 * i
            shared: dict = {}
            variants = ["sound"]
            if i < args.others:
                variants += ["control", *chosen]
            for variant in variants:
                row = readings(cell, seed, variant, device, shared)
                rows.append(row)
                print(json.dumps(row), flush=True)
        print(json.dumps({"workload": name, "summary": summary(rows)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
