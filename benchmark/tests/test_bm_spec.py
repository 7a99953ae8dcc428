"""The harness finds every cell, configuration, traffic mix, limit file
and metric reader by the names in ``BENCHMARK.json``."""

import json
import os
import re

import pytest

from _tiny import BENCH, CELLS, ROOT, spec

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH_JSON = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_cells_are_the_proven_ones_on_one_chip():
    assert [w["name"] for w in BENCH_JSON["workloads"]] == list(CELLS)
    assert all(w["chips"] == 1 for w in BENCH_JSON["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH_JSON["workloads"] if w["name"] == name)
    assert {m.name for m in cell.end_to_end} >= {"train_captions_per_s",
                                                 "setup_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert set(cell.limits["limits"]) >= {"batch", "loss", "grad", "change"}
    assert cell.flops(cell.config, cell.traffic) > 0


def test_every_metric_has_a_reader_and_moves_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH_JSON["end_to_end"]}
    for m in BENCH_JSON["end_to_end"] + BENCH_JSON["per_layer"]:
        assert NAME.match(m["name"])
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
    for m in BENCH_JSON["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS)


def test_contract_limits():
    b = BENCH_JSON
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len(json.dumps(b)) < 64 * 1024
