"""``tools/chain_spread.py`` on fixed inputs: both packages'
``metrics.jsonl`` formats, the rule of the 10th-12th val records (a
re-logged step counted once), a run with fewer than 12 val records
refused, the arms' mean and sample deviation, the three verdicts, the
beam-5 caption comparison, ``collect``'s manifest and the CLI; and the
reference chain's recorded CST stage read as its report states it.
"""

import json
import math
import statistics
from pathlib import Path

import pytest

from cst_captioning_tpu_torch.tools import chain_spread

REPO = Path(__file__).resolve().parent.parent


def _write_run(path, ciders, port=False, relog=()):
    """A CST stage's ``metrics.jsonl``: a train record before each val
    record; ``relog`` steps are logged a second time (a resume) with the
    same value."""
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    for epoch, cider in enumerate(ciders, 1):
        step = 16 * epoch
        extra = {"schema": 2} if port else {}
        lines.append({**extra, "step": step - 6, "scope": "train",
                      "time": 1.0, "loss": -0.5, "reward": 4.1})
        lines.append({**extra, "step": step, "scope": "val", "time": 2.0,
                      "CIDEr": cider})
        if step in relog:
            lines.append({**extra, "step": step, "scope": "val",
                          "time": 3.0, "CIDEr": cider})
    path.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return path


def _ciders(m, n=12):
    """n val records whose 10th-12th average to m (the others far off)."""
    return [m - 1.0] * 9 + [m - 0.01, m, m + 0.01] + [m + 5.0] * (n - 12)


@pytest.mark.parametrize("port", [False, True], ids=["reference", "port"])
def test_both_formats_give_the_val_records_in_step_order(tmp_path, port):
    run = _write_run(tmp_path / "m.jsonl", [float(i) for i in range(12)],
                     port=port)
    assert chain_spread.val_cider(str(run)) == [float(i) for i in range(12)]


def test_the_10th_to_12th_records_and_a_relogged_step_counts_once(tmp_path):
    ciders = [0.0] * 9 + [3.0, 3.3, 3.6, 9.0, 9.0]
    run = _write_run(tmp_path / "m.jsonl", ciders, relog=(16, 48, 160))
    assert len(chain_spread.val_cider(str(run))) == 14
    assert chain_spread.run_mean(str(run)) == pytest.approx(3.3, abs=1e-12)


def test_fewer_than_12_val_records_is_refused(tmp_path):
    run = _write_run(tmp_path / "m.jsonl", [3.0] * 11, relog=(16, 32))
    with pytest.raises(ValueError, match=r"11 val record\(s\).*needs at "
                                         r"least 12"):
        chain_spread.run_mean(str(run))
    assert chain_spread.main(["summarize", "--arm",
                              f"a={tmp_path}/m.jsonl"]) == 2


def test_an_arm_mean_and_sample_deviation(tmp_path):
    ms = [3.01, 3.05, 2.98, 3.10, 3.02]
    runs = [str(_write_run(tmp_path / f"seed{i}" / "metrics.jsonl",
                           _ciders(m)).parent) for i, m in enumerate(ms)]
    st = chain_spread.arm_stats(runs)
    assert st["n"] == 5
    assert st["M"] == pytest.approx(statistics.fmean(ms), abs=1e-12)
    assert st["sd"] == pytest.approx(statistics.stdev(ms), abs=1e-12)
    one = chain_spread.arm_stats(runs[:1])
    assert one["sd"] == 0.0 and one["M"] == pytest.approx(3.01, abs=1e-12)


@pytest.mark.parametrize("a, b, want", [
    # |delta| 0.10 > 0.03 and > 2 se (sd 0.01 each): differ
    ([3.09, 3.10, 3.11], [2.99, 3.00, 3.01], "differ"),
    # |delta| 0.02 <= 0.03, however small the se: agree
    ([3.02, 3.02, 3.02], [3.00, 3.00, 3.00], "agree"),
    # |delta| 0.05 > 0.03 but below 2 se (sd about 0.1): unresolved
    ([3.15, 2.95, 3.05], [3.10, 2.90, 2.90], "unresolved"),
], ids=["differ", "agree", "unresolved"])
def test_the_three_verdicts(tmp_path, a, b, want):
    for arm, ms in (("A", a), ("B", b)):
        for i, m in enumerate(ms):
            _write_run(tmp_path / arm / f"seed{i}" / "metrics.jsonl",
                       _ciders(m))
    out = chain_spread.summarize([("A", f"{tmp_path}/A/seed*"),
                                  ("B", f"{tmp_path}/B/seed*")])
    (pair,) = out["pairs"]
    delta = statistics.fmean(a) - statistics.fmean(b)
    se = math.sqrt(statistics.variance(a) / 3 + statistics.variance(b) / 3)
    assert (pair["a"], pair["b"]) == ("A", "B")
    assert pair["delta"] == pytest.approx(delta, abs=1e-9)
    assert pair["se"] == pytest.approx(se, abs=1e-9)
    assert pair["verdict"] == want


@pytest.mark.parametrize("delta, se, want", [
    (0.03, 0.0, "agree"), (-0.03, 1.0, "agree"), (0.0301, 0.015, "differ"),
    (-0.05, 0.02, "differ"), (0.05, 0.025, "unresolved"),
    (-0.2, 0.2, "unresolved")])
def test_verdict_edges(delta, se, want):
    assert chain_spread.verdict(delta, se) == want


def test_every_pair_in_the_order_given(tmp_path):
    for arm, m in (("R", 3.08), ("P", 2.98), ("Q", 3.07)):
        _write_run(tmp_path / arm / "metrics.jsonl", _ciders(m))
    out = chain_spread.summarize([(n, f"{tmp_path}/{n}")
                                  for n in ("R", "P", "Q")])
    assert [(p["a"], p["b"]) for p in out["pairs"]] == [
        ("R", "P"), ("R", "Q"), ("P", "Q")]
    both = chain_spread.summarize([("RQ", f"{tmp_path}/R,{tmp_path}/Q")])
    assert both["arms"]["RQ"]["n"] == 2
    assert both["arms"]["RQ"]["M"] == pytest.approx(3.075, abs=1e-12)
    with pytest.raises(FileNotFoundError, match="arm X"):
        chain_spread.summarize([("X", f"{tmp_path}/nothing*")])
    (tmp_path / "R.log").write_text("not json\n")
    with pytest.raises(ValueError, match="R.log: a run is a metrics.jsonl"):
        chain_spread.summarize([("R", f"{tmp_path}/R*")])


def _beam(path, captions, cider):
    path.write_text(json.dumps({
        "scores": {"CIDEr": cider, "Bleu_4": 0.4},
        "predictions": [{"image_id": v, "caption": c}
                        for v, c in captions.items()]}))
    return str(path)


def test_beam_comparison_counts_equal_captions(tmp_path):
    a = _beam(tmp_path / "a.json", {"v1": "a man runs", "v2": "a cat",
                                    "v3": "x"}, 2.9)
    b = _beam(tmp_path / "b.json", {"v3": "x", "v2": "a dog",
                                    "v1": "a man runs"}, 2.8)
    got = chain_spread.compare_beams(a, b)
    assert (got["videos"], got["equal"], got["CIDEr"]) == (3, 2, [2.9, 2.8])
    c = _beam(tmp_path / "c.json", {"v1": "a man runs"}, 2.0)
    with pytest.raises(ValueError, match="different videos"):
        chain_spread.compare_beams(a, c)


def test_collect_copies_with_a_manifest(tmp_path):
    run = _write_run(tmp_path / "run" / "metrics.jsonl", _ciders(3.0))
    infos = tmp_path / "run" / "infos.json"
    infos.write_text('{"best_score": 3.0}')
    man = chain_spread.collect(str(tmp_path / "b"), [str(run), str(infos)],
                               "python -m x --seed 1", "abc123",
                               where="a CPU, 8 cores")
    written = json.loads((tmp_path / "b" / "MANIFEST.json").read_text())
    assert written == man
    assert (written["command"], written["commit"], written["where"]) == (
        "python -m x --seed 1", "abc123", "a CPU, 8 cores")
    assert set(written["files"]) == {"metrics.jsonl", "infos.json"}
    assert (tmp_path / "b" / "metrics.jsonl").read_bytes() == run.read_bytes()
    assert written["files"]["infos.json"]["bytes"] == len(infos.read_bytes())
    assert len(written["files"]["infos.json"]["sha256"]) == 64
    assert chain_spread.where_ran()


def test_cli_prints_one_line_per_pair_and_writes_the_summary(tmp_path,
                                                             capsys):
    for arm, m in (("A", 3.0), ("B", 3.1)):
        _write_run(tmp_path / arm / "metrics.jsonl", _ciders(m))
    a = _beam(tmp_path / "a.json", {"v1": "x"}, 1.0)
    out = tmp_path / "summary.json"
    assert chain_spread.main([
        "summarize", "--arm", f"A={tmp_path}/A", "--arm", f"B={tmp_path}/B",
        "--beam", f"ckpt={a},{a}", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln for ln in lines if " vs " in ln] == [
        "A vs B: delta -0.1000, se 0.0000, differ"]
    assert "beam 5 ckpt: 1/1 captions equal, CIDEr 1.0000 / 1.0000" in lines
    summary = json.loads(out.read_text())
    assert summary["pairs"][0]["verdict"] == "differ"
    assert summary["bound"] == 0.03 and summary["records"] == [10, 12]


def test_the_reference_chains_recorded_cst_stage():
    """The recorded reference chain's CST stage: epochs 10-12 read 3.0703,
    3.0837 and 3.1096, so m = 3.0878."""
    path = REPO / "artifacts" / "cpu512_healthy" / "cst_scb_sample"
    assert chain_spread.run_mean(chain_spread.metrics_file(str(path))) == \
        pytest.approx(3.0878, abs=5e-5)


def test_the_committed_crossover_summary_is_what_its_runs_give():
    """``artifacts_torch/crossover18/summary.json``: every arm's n, M and
    sd, every pair's delta, se and verdict and every beam comparison
    recomputed from the committed runs it names."""
    bundle = REPO / "artifacts_torch" / "crossover18"
    summary = json.loads((bundle / "summary.json").read_text())
    assert summary["bound"] == chain_spread.BOUND
    stats = {}
    for name, arm in summary["arms"].items():
        runs = [str(REPO / r) for r in arm["runs"]]
        assert all(Path(r).is_relative_to(bundle) for r in runs), name
        stats[name] = chain_spread.arm_stats(runs)
        assert stats[name]["n"] == arm["n"], name
        assert stats[name]["M"] == pytest.approx(arm["M"], abs=1e-12)
        assert stats[name]["sd"] == pytest.approx(arm["sd"], abs=1e-12)
    assert len(summary["pairs"]) == len(stats) * (len(stats) - 1) // 2
    for pair in summary["pairs"]:
        got = chain_spread.compare(stats[pair["a"]], stats[pair["b"]])
        assert got["verdict"] == pair["verdict"], pair
        assert got["delta"] == pytest.approx(pair["delta"], abs=1e-12)
    for label, beam in summary["beam5"].items():
        got = chain_spread.compare_beams(*(str(REPO / f)
                                           for f in beam["files"]))
        assert (got["equal"], got["CIDEr"]) == (beam["equal"],
                                                beam["CIDEr"]), label
