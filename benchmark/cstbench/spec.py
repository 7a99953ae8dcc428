"""The benchmark's data, found by the names in ``BENCHMARK.json``: a
cell's configuration (``benchmark/configs/<config>.json``), its traffic
(``benchmark/traffic/<traffic>.json``), its correctness limits
(``benchmark/workloads/<cell>.json``), the configuration's model-FLOP
count (``benchmark/flops/<flops>.py``) and each metric's reader
(``benchmark/metrics/<metric>.py``).  A later cell, configuration or
metric is a new file and a new entry: nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _module(kind: str, name: str):
    path = os.path.join(BENCH_DIR, kind, name.replace("-", "_") + ".py")
    spec = importlib.util.spec_from_file_location(
        f"cstbench_{kind}_{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    flops: Callable[[dict, dict], float]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _reported(entries: List[dict], cell: str, moved: set) -> List[Metric]:
    """The metrics of ``entries`` that ``cell`` reports: those that list
    it, or, without a ``workloads`` key, every cell (per-layer metrics:
    every cell that reports the end-to-end metric they move)."""
    out = []
    for m in entries:
        cells = m.get("workloads")
        if cells is None:
            if "moves" in m and m["moves"] not in moved:
                continue
        elif cell not in cells:
            continue
        out.append(Metric(m["name"], m["unit"],
                          _module("metrics", m["name"]).read))
    return out


def load_cell(name: str) -> Cell:
    bench = _json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(ROOT, configs[w["config"]]["file"])
    traffic = _json(BENCH_DIR, "traffic", w["traffic"] + ".json")
    limits = _json(BENCH_DIR, "workloads", name + ".json")
    e2e = _reported(bench["end_to_end"], name, set())
    moved = {m.name for m in e2e}
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                flops=_module("flops", config["flops"]).step_flops,
                end_to_end=e2e,
                per_layer=_reported(bench["per_layer"], name, moved))


def option_argv(options: Dict[str, object]) -> List[str]:
    """``{"batch_size": 64}`` -> ``["--batch_size", "64"]``."""
    out: List[str] = []
    for k, v in options.items():
        out += [f"--{k}", str(v)]
    return out
