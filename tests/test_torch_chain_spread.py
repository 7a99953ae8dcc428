"""``tools/chain_spread.py`` on fixed inputs: both packages'
``metrics.jsonl`` formats, the rule of the 10th-12th val records (a
re-logged step counted once), a run with fewer than 12 val records
refused, other windows (``--window``), the arms' mean and sample
deviation, the three verdicts, the verdict paired by seed beside the
unpaired one and the pairs it refuses, the beam-5 caption comparison,
``collect``'s manifest and the CLI; the reference chain's recorded CST
stage read as its report states it; and both committed crossover
summaries recomputed from their runs.
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


def _arm(root, name, ms, n=12, seeds=None):
    """An arm's runs, ``root/name/seed<N>/metrics.jsonl``, whose
    ``_ciders`` window averages to each ``m``."""
    for seed, m in zip(seeds or range(len(ms)), ms):
        _write_run(root / name / f"seed{seed}" / "metrics.jsonl",
                   _ciders(m, n))
    return f"{root}/{name}/seed*"


def test_the_window_picks_its_val_records(tmp_path):
    ciders = [0.0] * 14 + [2.0, 2.2, 2.4, 2.6, 2.8, 3.0]
    run = _write_run(tmp_path / "m.jsonl", ciders, relog=(16, 320))
    assert chain_spread.run_mean(str(run), 15, 20) == pytest.approx(
        2.5, abs=1e-12)
    assert chain_spread.run_mean(str(run), 20, 20) == 3.0
    with pytest.raises(ValueError, match=r"20 val record\(s\).*91-100 "
                                         r"needs at least 100"):
        chain_spread.run_mean(str(run), 91, 100)
    assert chain_spread.parse_window("91-100") == (91, 100)
    for bad in ("12-10", "0-3", "10", "a-b", "10-"):
        with pytest.raises(Exception, match="FIRST-LAST"):
            chain_spread.parse_window(bad)


def test_the_paired_verdict_where_the_unpaired_cannot_tell(tmp_path):
    """The seeds move both arms together (the data order): unpaired, a
    gap of 0.05 under an se of 0.09 is unresolved; paired by seed, the
    same gap with d's sd 0.005 differs."""
    base = [2.80, 3.00, 2.90, 2.70, 3.10]
    seeds = [123, 1, 2, 3, 4]
    d = [0.050, 0.055, 0.045, 0.050, 0.050]
    out = chain_spread.summarize(
        [("P", _arm(tmp_path, "P", [b + x for b, x in zip(base, d)],
                    seeds=seeds)),
         ("R", _arm(tmp_path, "R", base, seeds=seeds))],
        paired=[("P", "R")])
    (pair,) = out["paired"]
    assert (pair["a"], pair["b"], pair["n"]) == ("P", "R", 5)
    assert pair["seeds"] == sorted(seeds)
    assert pair["delta"] == pytest.approx(statistics.fmean(d), abs=1e-9)
    assert pair["se"] == pytest.approx(statistics.stdev(d) / math.sqrt(5),
                                       abs=1e-9)
    assert pair["verdict"] == "differ"
    (unpaired,) = out["pairs"]
    assert pair["unpaired"] == {k: unpaired[k]
                                for k in ("delta", "se", "verdict")}
    assert unpaired["verdict"] == "unresolved"
    # and the other way: paired agree where unpaired agrees too
    flat = chain_spread.summarize(
        [("A", _arm(tmp_path, "A", base, seeds=seeds)),
         ("B", _arm(tmp_path, "B", [b + 0.01 for b in base], seeds=seeds))],
        paired=[("A", "B")])
    assert flat["paired"][0]["verdict"] == "agree"
    assert flat["paired"][0]["se"] == pytest.approx(0.0, abs=1e-9)
    assert "paired" not in chain_spread.summarize(
        [("A", f"{tmp_path}/A/seed*")])


@pytest.mark.parametrize("case, match", [
    ("seeds", r"seeds \[1, 2\] and \[1, 3\] do not match"),
    ("no_seed", "no seed<N> directory"),
    ("windows", "different val records"),
    ("arm", "no arm Z"),
])
def test_a_pair_that_cannot_be_paired_is_refused(tmp_path, case, match):
    a = _arm(tmp_path, "A", [3.0, 3.1], n=20, seeds=[1, 2])
    b = _arm(tmp_path, "B", [3.0, 3.1], n=20,
             seeds=[1, 3] if case == "seeds" else [1, 2])
    if case == "no_seed":
        b = str(_write_run(tmp_path / "B0" / "metrics.jsonl",
                           _ciders(3.0, 20)).parent)
    windows = {"B": (15, 20)} if case == "windows" else None
    pair = ("A", "Z") if case == "arm" else ("A", "B")
    with pytest.raises(ValueError, match=match):
        chain_spread.summarize([("A", a), ("B", b)], windows=windows,
                               paired=[pair])


def test_the_seed_of_a_run_is_its_last_seed_directory():
    assert chain_spread.run_seed("b/P_from_I/seed4") == 4
    assert chain_spread.run_seed("seed1/x/seed123/metrics.jsonl") == 123
    for path in ("b/seed4x/metrics.jsonl", "b/myseed4", "b/run"):
        with pytest.raises(ValueError, match="no seed<N>"):
            chain_spread.run_seed(path)


def test_cli_windows_apply_to_the_arms_after_them(tmp_path, capsys):
    """Two stages in one summary: each arm averages its own window, the
    unpaired pairs stay within one window, and ``records`` names each
    arm's."""
    for name in ("WA", "WB"):
        for seed, m in ((1, 2.9), (2, 3.0)):
            _write_run(tmp_path / name / f"seed{seed}" / "metrics.jsonl",
                       [0.0] * 14 + [m] * 6)
    for name, m in (("XA", 2.50), ("XB", 2.40)):
        for seed, e in ((1, 0.0), (2, 0.002)):
            _write_run(tmp_path / name / f"seed{seed}" / "metrics.jsonl",
                       [0.0] * 90 + [m + e] * 10)
    out = tmp_path / "s.json"
    assert chain_spread.main([
        "summarize", "--window", "15-20",
        "--arm", f"WA={tmp_path}/WA/seed*", "--arm", f"WB={tmp_path}/WB/seed*",
        "--paired", "WA,WB", "--window", "91-100",
        "--arm", f"XA={tmp_path}/XA/seed*", "--arm", f"XB={tmp_path}/XB/seed*",
        "--paired", "XA,XB", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    summary = json.loads(out.read_text())
    assert summary["records"] == {"WA": [15, 20], "WB": [15, 20],
                                  "XA": [91, 100], "XB": [91, 100]}
    assert [(p["a"], p["b"]) for p in summary["pairs"]] == [
        ("WA", "WB"), ("XA", "XB")]
    assert summary["arms"]["WA"]["M"] == pytest.approx(2.95, abs=1e-12)
    assert summary["arms"]["XA"]["M"] == pytest.approx(2.501, abs=1e-12)
    assert "XA vs XB paired by seed (n 2): delta +0.1000, se 0.0000, " \
           "differ; unpaired: delta +0.1000, se 0.0014, differ" in lines
    assert "WA vs WB paired by seed (n 2): delta +0.0000, se 0.0000, " \
           "agree; unpaired: delta +0.0000, se 0.0707, agree" in lines
    with pytest.raises(SystemExit):
        chain_spread.main(["summarize", "--window", "3-1", "--arm",
                           f"WA={tmp_path}/WA/seed*"])


def test_the_crossover18_summary_comes_out_unchanged(monkeypatch):
    """The command in ``artifacts_torch/crossover18/README.md``, run from
    the repository's root with the defaults of ``--window``, writes
    exactly the committed ``summary.json``."""
    monkeypatch.chdir(REPO)
    b = "artifacts_torch/crossover18"
    got = chain_spread.summarize(
        [("R<-R", f"{b}/R_from_R/seed*"), ("P<-R", f"{b}/P_from_R/seed*"),
         ("R<-P", f"{b}/R_from_P/seed*"), ("P<-P", f"{b}/P_from_P/seed*"),
         ("R-chain", f"{b}/R_from_R/seed123,{b}/R_chain/seed*/cst"),
         ("P-chain", f"{b}/P_from_P/seed123,{b}/P-chain/seed*/cst")],
        [("R-WXE", f"{b}/beam5/ref_on_R-WXE/ref_on_R-WXE_beam5.json,"
                   f"{b}/beam5/port_on_R-WXE/port_on_R-WXE_beam5.json"),
         ("P-WXE", f"{b}/beam5/ref_on_P-WXE/ref_on_P-WXE_beam5.json,"
                   f"{b}/beam5/port_on_P-WXE/port_on_P-WXE_beam5.json")])
    assert got == json.loads((REPO / b / "summary.json").read_text())


def test_the_committed_xe_wxe_crossover_summary_is_what_its_runs_give():
    """``artifacts_torch/crossover19/summary.json``: each arm over its own
    window (WXE's val records 15-20, XE's 91-100), every unpaired pair
    within a window and every pair by seed recomputed from the committed
    runs it names; every run has its manifest."""
    bundle = REPO / "artifacts_torch" / "crossover19"
    summary = json.loads((bundle / "summary.json").read_text())
    assert summary["bound"] == chain_spread.BOUND
    windows = {name: tuple(w) for name, w in summary["records"].items()}
    assert set(windows.values()) == {(15, 20), (91, 100)}
    stats = {}
    for name, arm in summary["arms"].items():
        runs = [str(REPO / r) for r in arm["runs"]]
        assert all(Path(r).is_relative_to(bundle) for r in runs), name
        assert all((Path(r) / "MANIFEST.json").is_file() for r in runs)
        stats[name] = chain_spread.arm_stats(runs, windows[name])
        assert stats[name]["n"] == arm["n"] >= 5, name
        assert stats[name]["M"] == pytest.approx(arm["M"], abs=1e-12)
        assert stats[name]["sd"] == pytest.approx(arm["sd"], abs=1e-12)
    for pair in summary["pairs"]:
        assert windows[pair["a"]] == windows[pair["b"]]
        got = chain_spread.compare(stats[pair["a"]], stats[pair["b"]])
        assert got["verdict"] == pair["verdict"], pair
        assert got["delta"] == pytest.approx(pair["delta"], abs=1e-12)
    assert len(summary["paired"]) >= 3
    for pair in summary["paired"]:
        got = chain_spread.compare_paired(stats[pair["a"]],
                                          stats[pair["b"]])
        assert (got["n"], got["seeds"], got["verdict"]) == (
            pair["n"], pair["seeds"], pair["verdict"]), pair
        assert got["delta"] == pytest.approx(pair["delta"], abs=1e-12)
        assert got["se"] == pytest.approx(pair["se"], abs=1e-12)
