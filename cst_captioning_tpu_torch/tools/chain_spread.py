"""The seed spread of training stages, and the verdict on each pair of
arms: the instrument of the crossovers between both packages' weights
and trainers.

    python -m cst_captioning_tpu_torch.tools.chain_spread summarize \\
        --arm 'R<-R=bundle/RR/seed*' --arm 'P<-R=bundle/PR/seed*' \\
        [--beam 'R-WXE=bundle/beam/ref_on_R.json,bundle/beam/port_on_R.json'] \\
        --out bundle/summary.json
    python -m cst_captioning_tpu_torch.tools.chain_spread summarize \\
        --window 15-20 --arm 'R<-R=bundle/RR/seed*' \\
        --arm 'P<-R=bundle/PR/seed*' --paired 'P<-R,R<-R' \\
        --window 91-100 --arm 'R<-I=bundle/RI/seed*' \\
        --arm 'P<-I=bundle/PI/seed*' --paired 'P<-I,R<-I' \\
        --out bundle/summary.json
    python -m cst_captioning_tpu_torch.tools.chain_spread collect \\
        --into bundle/PR/seed1 --command '...' --commit SHA \\
        --files run/checkpoints/cst/metrics.jsonl run/checkpoints/cst/infos.json

``summarize``: an arm is a name and globs of runs (comma-separated),
each a stage's ``metrics.jsonl`` or a directory holding one, in
either package's format (``{"scope": "val", "step": ..., "CIDEr": ...}``
records, the port's with a ``"schema"`` key as well). A run's ``m`` is
the mean of its val records FIRST-LAST (1-based) in step order (a step
logged twice, as a resume re-logs the steps it replays, counts once, its
last record); a run with fewer than LAST is refused. ``--window
FIRST-LAST`` sets the records of the arms given after it (before any:
10-12, CST's epochs 10-12). An arm's ``M`` is the mean
of its runs' ``m`` and ``sd`` their sample standard deviation (0 for one
run). For each pair of arms A, B of one window, in the order given:
``delta = M_A - M_B``, ``se = sqrt(sd_A^2/n_A + sd_B^2/n_B)``, and the
verdict ``differ`` when ``|delta| > 0.03`` and ``|delta| > 2 se``,
``agree`` when ``|delta| <= 0.03``, else ``unresolved`` (0.03: the
closing bound of the learning check). ``--paired A,B`` also pairs the
two arms' runs by seed (the ``seed<N>`` directory in each run's path):
``d = m_A - m_B`` per seed, ``delta`` their mean and ``se = sd(d) /
sqrt(n)``, under the same rule, printed beside the unpaired verdict; it
refuses arms of two windows, a run without a seed directory, a seed
twice in an arm, and arms whose seeds differ. The summary's
``records`` is the one window of every arm, or each arm's window by
name where they differ; ``paired`` is there only when asked
for. ``--beam LABEL=A,B``
compares two ``eval`` result files (``{"scores", "predictions"}``, both
packages' format) of one checkpoint: the captions equal per video and
each side's CIDEr. One line per pair and per beam comparison is printed;
``--out`` gets all of it as JSON.

``collect``: copies ``--files`` into ``--into`` by their base names and
writes ``MANIFEST.json`` there: the command that made them, the commit,
where it ran (``--where``; default: the card as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives it, else the
CPU and its core count) and each file's SHA-256 and size.

It imports nothing but the standard library and the port's
``resilience/integrity.py`` (itself standard library only).
"""

from __future__ import annotations

import argparse
import glob
import itertools
import json
import math
import os
import platform
import re
import shutil
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..resilience.exitcodes import EXIT_OK, EXIT_USAGE
from ..resilience.integrity import _sha256, atomic_json_write

#: The learning check's closing bound on the epochs-10-12 mean.
BOUND = 0.03
#: The val records (1-based, in step order) a run's ``m`` averages by
#: default: CST's epochs 10-12.
FIRST, LAST = 10, 12
#: A run's seed: the last ``seed<N>`` directory of its path.
SEED_DIR = re.compile(r"(?:^|[\\/])seed(\d+)(?=[\\/]|$)")


def val_cider(path: str) -> List[float]:
    """The CIDEr of each val record of a ``metrics.jsonl``, in step
    order, one per step (a re-logged step keeps its last record)."""
    by_step: Dict[int, float] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("scope") == "val" and "CIDEr" in rec:
                by_step[int(rec["step"])] = float(rec["CIDEr"])
    return [by_step[s] for s in sorted(by_step)]


def run_mean(path: str, first: int = FIRST, last: int = LAST) -> float:
    """``m``: the mean of the ``first``-th to ``last``-th val records."""
    cider = val_cider(path)
    if len(cider) < last:
        raise ValueError(
            f"{path}: {len(cider)} val record(s); the mean over val "
            f"records {first}-{last} needs at least {last}")
    window = cider[first - 1:last]
    return sum(window) / len(window)


def metrics_file(path: str) -> str:
    """A run given as its ``metrics.jsonl`` or a directory holding one."""
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    elif not path.endswith(".jsonl"):
        raise ValueError(f"{path}: a run is a metrics.jsonl or a directory "
                         "holding one")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no metrics.jsonl at {path}")
    return path


def arm_stats(runs: Sequence[str], window: Tuple[int, int] = (FIRST, LAST)
              ) -> Dict[str, object]:
    """-> {"runs": {path: m}, "n", "M", "sd"} over the runs' ``m`` (the
    mean of val records ``window``)."""
    if not runs:
        raise ValueError("an arm needs at least one run")
    ms = {p: run_mean(metrics_file(p), *window) for p in runs}
    vals = list(ms.values())
    return {"runs": ms, "n": len(vals), "M": statistics.fmean(vals),
            "sd": statistics.stdev(vals) if len(vals) > 1 else 0.0}


def verdict(delta: float, se: float) -> str:
    if abs(delta) <= BOUND:
        return "agree"
    if abs(delta) > 2 * se:
        return "differ"
    return "unresolved"


def compare(a: Dict[str, object], b: Dict[str, object]
            ) -> Dict[str, object]:
    """The pair (A, B): ``delta``, ``se`` and the verdict."""
    delta = a["M"] - b["M"]
    se = math.sqrt(a["sd"] ** 2 / a["n"] + b["sd"] ** 2 / b["n"])
    return {"delta": delta, "se": se, "verdict": verdict(delta, se)}


def run_seed(path: str) -> int:
    """The seed of a run: the last ``seed<N>`` directory of its path."""
    found = SEED_DIR.findall(path)
    if not found:
        raise ValueError(f"{path}: no seed<N> directory to pair by")
    return int(found[-1])


def compare_paired(a: Dict[str, object], b: Dict[str, object]
                   ) -> Dict[str, object]:
    """The pair (A, B) by seed: per seed ``d = m_A - m_B``; ``delta``
    their mean, ``se = sd(d) / sqrt(n)`` and the verdict."""
    by_seed = []
    for st in (a, b):
        seeds: Dict[int, float] = {}
        for path, m in st["runs"].items():
            seed = run_seed(path)
            if seed in seeds:
                raise ValueError(f"{path}: seed {seed} twice in one arm")
            seeds[seed] = m
        by_seed.append(seeds)
    if set(by_seed[0]) != set(by_seed[1]):
        raise ValueError(f"seeds {sorted(by_seed[0])} and "
                         f"{sorted(by_seed[1])} do not match")
    seeds = sorted(by_seed[0])
    d = [by_seed[0][s] - by_seed[1][s] for s in seeds]
    delta = statistics.fmean(d)
    se = (statistics.stdev(d) / math.sqrt(len(d)) if len(d) > 1 else 0.0)
    return {"n": len(d), "seeds": seeds, "d": d, "delta": delta, "se": se,
            "verdict": verdict(delta, se)}


def parse_window(text: str) -> Tuple[int, int]:
    """``FIRST-LAST`` (1-based val records, FIRST <= LAST)."""
    first, sep, last = text.partition("-")
    try:
        window = (int(first), int(last))
    except ValueError:
        window = (0, 0)
    if not sep or not 1 <= window[0] <= window[1]:
        raise argparse.ArgumentTypeError(
            f"{text!r}: expected FIRST-LAST, 1 <= FIRST <= LAST")
    return window


def compare_beams(path_a: str, path_b: str) -> Dict[str, object]:
    """Two eval result files of one checkpoint: captions equal per video
    and each side's CIDEr."""
    sides = []
    for path in (path_a, path_b):
        with open(path) as f:
            res = json.load(f)
        caps = {str(p["image_id"]): p["caption"] for p in res["predictions"]}
        sides.append((caps, res["scores"]["CIDEr"]))
    (ca, sa), (cb, sb) = sides
    if set(ca) != set(cb):
        raise ValueError(f"{path_a} and {path_b} decode different videos")
    return {"videos": len(ca), "equal": sum(ca[v] == cb[v] for v in ca),
            "CIDEr": [sa, sb], "files": [path_a, path_b]}


def _named(spec: str) -> Tuple[str, str]:
    name, sep, value = spec.partition("=")
    if not sep or not name or not value:
        raise argparse.ArgumentTypeError(f"{spec!r}: expected NAME=VALUE")
    return name, value


def _two(spec: str) -> Tuple[str, str]:
    a, sep, b = spec.partition(",")
    if not sep or not a or not b:
        raise argparse.ArgumentTypeError(f"{spec!r}: expected A,B")
    return a, b


class _Window(argparse.Action):
    """``--window``: the records of the ``--arm``s that follow it."""

    def __call__(self, parser, namespace, values, option_string=None):
        namespace.window = values


class _Arm(argparse.Action):
    """``--arm``: appended, with the window in force, to ``windows``."""

    def __call__(self, parser, namespace, values, option_string=None):
        if namespace.arm is None:
            namespace.arm, namespace.windows = [], {}
        namespace.arm.append(values)
        namespace.windows[values[0]] = namespace.window or (FIRST, LAST)


def summarize(arms: Sequence[Tuple[str, str]],
              beams: Sequence[Tuple[str, str]] = (),
              windows: Optional[Dict[str, Tuple[int, int]]] = None,
              paired: Sequence[Tuple[str, str]] = ()) -> Dict[str, object]:
    """``arms``: (name, "GLOB[,GLOB...]" of runs); ``beams``: (label,
    "A,B"); ``windows``: an arm's val records by name (default
    ``FIRST``-``LAST``); ``paired``: (A, B) arms to pair by seed."""
    windows = {name: tuple((windows or {}).get(name, (FIRST, LAST)))
               for name, _ in arms}
    stats = {}
    for name, patterns in arms:
        runs = sorted(r for pattern in patterns.split(",")
                      for r in glob.glob(pattern))
        if not runs:
            raise FileNotFoundError(f"arm {name}: nothing matches "
                                    f"{patterns!r}")
        stats[name] = arm_stats(runs, windows[name])
    pairs = [{"a": a, "b": b, **compare(stats[a], stats[b])}
             for a, b in itertools.combinations(stats, 2)
             if windows[a] == windows[b]]
    by_seed = []
    for a, b in paired:
        for name in (a, b):
            if name not in stats:
                raise ValueError(f"--paired {a},{b}: no arm {name}")
        if windows[a] != windows[b]:
            raise ValueError(f"--paired {a},{b}: the arms average "
                             "different val records")
        try:
            got = compare_paired(stats[a], stats[b])
        except ValueError as e:
            raise ValueError(f"--paired {a},{b}: {e}") from None
        by_seed.append({"a": a, "b": b, **got,
                        "unpaired": compare(stats[a], stats[b])})
    beam = {}
    for label, files in beams:
        a, sep, b = files.partition(",")
        if not sep:
            raise ValueError(f"--beam {label}: expected two files, A,B")
        beam[label] = compare_beams(a, b)
    shared = set(windows.values())
    records = (list(shared.pop()) if len(shared) == 1
               else {name: list(w) for name, w in windows.items()})
    out = {"bound": BOUND, "records": records, "arms": stats,
           "pairs": pairs, "beam5": beam}
    if paired:
        out["paired"] = by_seed
    return out


def where_ran() -> str:
    """The card as nvidia-smi names it, else the CPU and its cores."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
        if out:
            return out.splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return (f"CPU ({platform.machine()}, {os.cpu_count()} cores), "
            "no card")


def collect(into: str, files: Sequence[str], command: str, commit: str,
            where: str = "") -> Dict[str, object]:
    """Copy ``files`` into ``into`` and write its ``MANIFEST.json``."""
    os.makedirs(into, exist_ok=True)
    manifest = {"command": command, "commit": commit,
                "where": where or where_ran(),
                "collected": time.strftime("%Y-%m-%d %H:%M:%S UTC",
                                           time.gmtime()),
                "files": {}}
    for src in files:
        name = os.path.basename(src)
        if name in manifest["files"]:
            raise ValueError(f"two files named {name}")
        dst = os.path.join(into, name)
        shutil.copyfile(src, dst)
        manifest["files"][name] = {"source": src, "sha256": _sha256(dst),
                                   "bytes": os.path.getsize(dst)}
    atomic_json_write(os.path.join(into, "MANIFEST.json"), manifest,
                      indent=2)
    return manifest


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("summarize", help="the arms' spread and verdicts")
    s.add_argument("--window", type=parse_window, action=_Window,
                   help="FIRST-LAST: the val records a run's m averages, "
                        "for the arms after this flag (default 10-12)")
    s.add_argument("--arm", type=_named, action=_Arm, required=True,
                   help="NAME=GLOB[,GLOB...] of runs (metrics.jsonl or "
                        "directories)")
    s.add_argument("--paired", type=_two, action="append", default=[],
                   help="A,B: also pair the two arms' runs by their "
                        "seed<N> directories")
    s.add_argument("--beam", type=_named, action="append", default=[],
                   help="LABEL=A.json,B.json: two eval results of one "
                        "checkpoint")
    s.add_argument("--out", default=None, help="write the summary here")
    s.set_defaults(windows=None)
    c = sub.add_parser("collect", help="copy a run's files with a manifest")
    c.add_argument("--into", required=True)
    c.add_argument("--files", nargs="+", required=True)
    c.add_argument("--command", dest="run_command", required=True)
    c.add_argument("--commit", required=True)
    c.add_argument("--where", default="")
    args = p.parse_args(argv)
    if args.command == "collect":
        collect(args.into, args.files, args.run_command, args.commit,
                args.where)
        return EXIT_OK
    try:
        out = summarize(args.arm, args.beam, args.windows, args.paired)
    except (OSError, ValueError) as e:
        print(f"chain_spread: {e}", file=sys.stderr)
        return EXIT_USAGE
    for name, st in out["arms"].items():
        print(f"{name}: n {st['n']}, M {st['M']:.4f}, sd {st['sd']:.4f}")
    for pr in out["pairs"]:
        print(f"{pr['a']} vs {pr['b']}: delta {pr['delta']:+.4f}, se "
              f"{pr['se']:.4f}, {pr['verdict']}")
    for pr in out.get("paired", ()):
        un = pr["unpaired"]
        print(f"{pr['a']} vs {pr['b']} paired by seed (n {pr['n']}): "
              f"delta {pr['delta']:+.4f}, se {pr['se']:.4f}, "
              f"{pr['verdict']}; unpaired: delta {un['delta']:+.4f}, se "
              f"{un['se']:.4f}, {un['verdict']}")
    for label, b in out["beam5"].items():
        print(f"beam 5 {label}: {b['equal']}/{b['videos']} captions equal, "
              f"CIDEr {b['CIDEr'][0]:.4f} / {b['CIDEr'][1]:.4f}")
    if args.out:
        atomic_json_write(args.out, out, indent=2)
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
