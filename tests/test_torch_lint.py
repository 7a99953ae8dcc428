"""cstlint-torch, the port's static analysis (``cst_captioning_tpu_torch/
analysis``, ``python -m cst_captioning_tpu_torch.lint``), held the way
``tests/test_cstlint.py`` holds the reference's: every one of the twelve
rules fires on a positive snippet and stays silent on a near miss; the
suppression grammar (a required justification, statement spans, stale
suppressions); the clean-tree gate over the port and ``chip_smoke.py``;
the JSON report; the CLI's exits; and the two lints reading none of each
other's comments.  The findings this lint led to repairing are held here
too.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from cst_captioning_tpu.analysis import lint_sources as ref_lint_sources
from cst_captioning_tpu_torch.analysis import (RULES, lint_sources,
                                               lint_tree, render_json)
from cst_captioning_tpu_torch.analysis import engine, locksan
from cst_captioning_tpu_torch.resilience.exitcodes import (EXIT_FAILURE,
                                                           EXIT_OK,
                                                           EXIT_USAGE)
from cst_captioning_tpu_torch.utils import locksan as utils_locksan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "cst_captioning_tpu_torch/"

CORE = ("atomic-write", "bare-except-swallow", "declared-counters",
        "device-scalar-fetch", "exit-taxonomy", "journal-append")
CONCURRENCY = ("guarded-by", "lock-order", "monotonic-deadline",
               "signal-safe-handler", "thread-discipline",
               "thread-ownership")


def src(text: str) -> str:
    return textwrap.dedent(text).lstrip("\n")


#: rule -> (virtual path, positive snippet, near-miss snippet).
SNIPPETS = {
    "device-scalar-fetch": (PKG + "training/steps.py", src("""
        import torch
        def run(model, xs):
            out = []
            for x in xs:
                loss = model(x)
                out.append(loss.item())
            return out
        """), src("""
        import torch
        def run(model, xs):
            out = []
            for x in xs:
                out.append(model(x))
                n = int(len(x))
            return torch.stack(out).tolist()
        """)),
    "atomic-write": (PKG + "tools/sometool.py", src("""
        import json
        def save(path, doc):
            with open(path + ".json", "w") as f:
                json.dump(doc, f)
        """), src("""
        import json
        from cst_captioning_tpu_torch.resilience.integrity import \\
            atomic_json_write
        def save(path, doc):
            atomic_json_write(path + ".json", doc)
            with open(path + ".json") as f:
                return json.load(f)
        """)),
    "journal-append": (PKG + "serving/supervisor.py", src("""
        import os
        def append(root, frame):
            with open(os.path.join(root, "seg_000001.wal"), "ab") as f:
                f.write(frame)
        """), src("""
        import os
        def read(root):
            with open(os.path.join(root, "seg_000001.wal"), "rb") as f:
                return f.read()
        """)),
    "declared-counters": (PKG + "serving/somemodule.py", src("""
        class Engine:
            def step(self, registry):
                registry.inc("engine_rebuilds")
        """), src("""
        COUNTERS = ("engine_rebuilds",)
        class Engine:
            def attach(self, registry):
                registry.declare(*COUNTERS, "engine_drops")
            def step(self, registry):
                registry.inc("engine_rebuilds")
                registry.inc("engine_drops")
        """)),
    "exit-taxonomy": (PKG + "tools/sometool.py", src("""
        import sys
        def main(ok):
            sys.exit(0 if ok else 3)
        """), src("""
        import sys
        from cst_captioning_tpu_torch.resilience.exitcodes import (
            EXIT_FAILURE, EXIT_OK)
        def main(ok):
            sys.exit(EXIT_OK if ok else EXIT_FAILURE)
        """)),
    "bare-except-swallow": (PKG + "serving/somemodule.py", src("""
        def pump(conn):
            try:
                conn.send(b"x")
            except Exception:
                pass
        """), src("""
        import logging
        log = logging.getLogger(__name__)
        def pump(conn):
            try:
                conn.send(b"x")
            except Exception:
                log.warning("send failed; dropping the connection")
        """)),
    "guarded-by": (PKG + "telemetry/somemodule.py", src("""
        import threading
        class Ring:
            def __init__(self):
                self._lock = threading.Lock()
                self._rows = []  # cstlint-torch: guarded_by=self._lock
            def add(self, row):
                self._rows.append(row)
            def size(self):
                return len(self._rows)
        """), src("""
        import threading
        class Ring:
            def __init__(self):
                self._lock = threading.Lock()
                self._rows = []  # cstlint-torch: guarded_by=self._lock
            def add(self, row):
                with self._lock:
                    self._rows.append(row)
            def _trim_locked(self):
                del self._rows[:-8]
        """)),
    "thread-ownership": (PKG + "serving/somemodule.py", src("""
        import threading
        class Server:
            def __init__(self):
                self._pending = []  # cstlint-torch: owned_by=scheduler
                self._t = threading.Thread(target=self._reader,
                                           name="reader", daemon=True)
            def _reader(self):
                self._pending.append("line")
        """), src("""
        import queue
        import threading
        class Server:
            def __init__(self):
                self._pending = []  # cstlint-torch: owned_by=scheduler
                self._inbox = queue.Queue()
                self._t = threading.Thread(target=self._reader,
                                           name="reader", daemon=True)
            def _reader(self):
                self._inbox.put("line")
            def tick(self):
                self._pending.append(self._inbox.get())
        """)),
    "lock-order": (PKG + "serving/somemodule.py", src("""
        from cst_captioning_tpu_torch.utils.locksan import named_lock
        LOCK_ORDER = ("t.outer", "t.inner")
        _OUTER = named_lock("t.outer")
        _INNER = named_lock("t.inner")
        def f():
            with _INNER:
                with _OUTER:
                    pass
        """), src("""
        from cst_captioning_tpu_torch.utils.locksan import named_lock
        LOCK_ORDER = ("t.outer", "t.inner")
        _OUTER = named_lock("t.outer")
        _INNER = named_lock("t.inner")
        def f():
            with _OUTER:
                with _INNER:
                    pass
        """)),
    "signal-safe-handler": (PKG + "resilience/somemodule.py", src("""
        import signal
        class Handler:
            def install(self):
                signal.signal(signal.SIGTERM, self._handle)
            def _handle(self, signum, frame):
                self._note(signum)
            def _note(self, signum):
                print("preempted", signum)
        """), src("""
        import os
        import signal
        class Handler:
            requested = False
            def install(self):
                signal.signal(signal.SIGTERM, self._handle)
            def _handle(self, signum, frame):
                self.requested = True
                os.write(2, b"preempted\\n")
        """)),
    "thread-discipline": (PKG + "data/somemodule.py", src("""
        import threading
        def start(fn):
            t = threading.Thread(target=fn)
            t.start()
            return t
        """), src("""
        import threading
        def start(fn):
            t = threading.Thread(target=fn, name="loader-prefetch-0",
                                 daemon=False)
            t.start()
            t.join(timeout=5.0)
        """)),
    "monotonic-deadline": (PKG + "serving/somemodule.py", src("""
        import time
        def wait(poll, timeout_s):
            deadline = time.time() + timeout_s
            while time.time() < deadline:
                poll()
        """), src("""
        import time
        def wait(poll, timeout_s, log):
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                poll()
            log({"ts": time.time(), "event": "waited"})
        """)),
}


def run_rule(rule: str, text: str, relpath: str):
    res = lint_sources([(relpath, text)], rules=[rule])
    return [v for v in res.violations if v.rule == rule]


# -- the registry ------------------------------------------------------------

def test_twelve_rules_registered_in_two_categories():
    assert set(RULES) == set(CORE) | set(CONCURRENCY)
    assert set(SNIPPETS) == set(RULES)
    for name in CORE:
        assert RULES[name].category == "core"
    for name in CONCURRENCY:
        assert RULES[name].category == "concurrency"
    # The reference's jaxpr-level donation audit has no torch counterpart.
    assert "donation-audit" not in RULES


def test_locksan_facade_is_the_runtime_sanitizer():
    for name in ("named_lock", "declare_order", "path_exists", "enabled",
                 "violations", "reset_observed", "LockOrderViolation"):
        assert getattr(locksan, name) is getattr(utils_locksan, name)


# -- every rule: its positive fires, its near miss stays silent --------------

@pytest.mark.parametrize("rule", sorted(SNIPPETS))
def test_positive_fires(rule):
    path, pos, _ = SNIPPETS[rule]
    assert run_rule(rule, pos, path), f"{rule} must fire on its positive"


@pytest.mark.parametrize("rule", sorted(SNIPPETS))
def test_near_miss_is_silent(rule):
    path, _, neg = SNIPPETS[rule]
    hits = run_rule(rule, neg, path)
    assert hits == [], f"{rule} fired on its near miss: {hits}"


FETCHES = ["t.item()", "t.tolist()", "t.cpu()", "t.numpy()", "t.to('cpu')",
           "t.to(device='cpu')", "t.to(torch.device('cpu'))",
           "torch.cuda.synchronize(dev)", "float(t)", "int(t.sum())",
           "bool(t.any())", "np.asarray(t)", "(finish or bool)(t.all())",
           "(finish if finish else float)(t)"]


@pytest.mark.parametrize("fetch", FETCHES)
def test_device_scalar_fetch_forms(fetch):
    """Each host fetch of a tensor fires inside a loop of a hot path, and
    not after the loop."""
    inside = f"def f(ts, dev):\n    for t in ts:\n        x = {fetch}\n"
    after = f"def f(ts, dev):\n    for t in ts:\n        pass\n    x = {fetch}\n"
    path = PKG + "ops/sampling.py"
    assert run_rule("device-scalar-fetch", inside, path)
    assert run_rule("device-scalar-fetch", after, path) == []


@pytest.mark.parametrize("call", ["(finish or bool)(len(t))",
                                  "(finish or str)(t)",
                                  "(finish if finish else repr)(t)"])
def test_device_scalar_fetch_chosen_callee_near_miss(call):
    """A callee chosen at run time fires only where one of its
    alternatives fetches and the argument may be a tensor."""
    inside = f"def f(ts, finish):\n    for t in ts:\n        x = {call}\n"
    assert run_rule("device-scalar-fetch", inside,
                    PKG + "ops/sampling.py") == []


@pytest.mark.parametrize("rel", [
    "training/trainer.py", "training/pipeline.py", "training/rewards.py",
    "training/steps.py", "ops/sampling.py", "serving/engine.py",
    "serving/server.py", "serving/fleet.py", "serving/supervisor.py",
    "serving/journal.py", "serving/autoscale.py", "telemetry/lifecycle.py",
    "telemetry/fleetobs.py", "parallel/dp.py", "parallel/cp.py",
    "data/loader.py", "data/sharding.py"])
def test_device_scalar_fetch_hot_paths(rel):
    _, pos, _ = SNIPPETS["device-scalar-fetch"]
    assert run_rule("device-scalar-fetch", pos, PKG + rel)


def test_device_scalar_fetch_scoped_to_hot_paths():
    """The same loop outside the hot paths (and in the reference's tree)
    is silent: the rule marks where a sync stalls the card's queue."""
    _, pos, _ = SNIPPETS["device-scalar-fetch"]
    for path in (PKG + "metrics/ngrams.py", PKG + "tools/k2_phases.py",
                 "chip_smoke.py", "cst_captioning_tpu/training/trainer.py"):
        assert run_rule("device-scalar-fetch", pos, path) == []


@pytest.mark.parametrize("rule,home", [
    ("atomic-write", "resilience/integrity.py"),
    ("journal-append", "serving/journal.py"),
    ("exit-taxonomy", "resilience/exitcodes.py")])
def test_home_modules_exempt(rule, home):
    path, pos, _ = SNIPPETS[rule]
    assert run_rule(rule, pos, path)
    assert run_rule(rule, pos, PKG + home) == []


def test_bare_except_scoped_to_failure_domains():
    _, pos, _ = SNIPPETS["bare-except-swallow"]
    assert run_rule("bare-except-swallow", pos, PKG + "resilience/x.py")
    assert run_rule("bare-except-swallow", pos, PKG + "metrics/x.py") == []


def test_guarded_by_flags_read_and_write():
    path, pos, _ = SNIPPETS["guarded-by"]
    hits = run_rule("guarded-by", pos, path)
    assert len(hits) == 2
    assert all("guarded_by=self._lock" in h.message for h in hits)


def test_reference_annotations_bind_nothing_here():
    """The port's annotations are ``cstlint-torch:``; a reference-style
    ``# cstlint: guarded_by=`` comment declares nothing to this lint."""
    path, pos, _ = SNIPPETS["guarded-by"]
    ref_style = pos.replace("cstlint-torch:", "cstlint:")
    assert run_rule("guarded-by", ref_style, path) == []


def test_lock_order_inversion_unnamed_and_undeclared():
    path, pos, _ = SNIPPETS["lock-order"]
    assert "INVERTS" in run_rule("lock-order", pos, path)[0].message
    unnamed = src("""
        import threading
        _A = threading.Lock()
        _B_lock = threading.Lock()
        def f():
            with _A_lock:
                with _B_lock:
                    pass
        """)
    assert "unnamed locks" in run_rule("lock-order", unnamed, path)[0].message
    undeclared = src("""
        from cst_captioning_tpu_torch.utils.locksan import named_lock
        _A = named_lock("u.a")
        _B = named_lock("u.b")
        def f():
            with _A:
                with _B:
                    pass
        """)
    assert "not covered" in run_rule("lock-order", undeclared,
                                     path)[0].message


def test_lock_order_cycle_across_conflicting_tables():
    a = src("""
        from cst_captioning_tpu_torch.utils.locksan import named_lock
        LOCK_ORDER = ("cyc.a", "cyc.b")
        _A = named_lock("cyc.a")
        _B = named_lock("cyc.b")
        def f():
            with _A:
                with _B:
                    pass
        """)
    b = 'LOCK_ORDER = ("cyc.b", "cyc.a")\n'
    res = lint_sources([(PKG + "serving/a.py", a), (PKG + "serving/b.py", b)],
                       rules=["lock-order"])
    msgs = " | ".join(v.message for v in res.violations)
    assert "INVERTS" in msgs or "cycle" in msgs


def test_lock_order_reads_the_ports_tables():
    """The port's own tables order its named locks: the loader's plan
    lock before its queue lock, as ``data/loader.py`` declares."""
    with open(os.path.join(REPO, PKG, "data/loader.py")) as f:
        loader = f.read()
    nested = src("""
        from cst_captioning_tpu_torch.utils.locksan import named_lock
        _P = named_lock("data.loader.plan")
        _Q = named_lock("data.loader.queue")
        def ok():
            with _P:
                with _Q:
                    pass
        def bad():
            with _Q:
                with _P:
                    pass
        """)
    res = lint_sources([(PKG + "data/loader.py", loader),
                        (PKG + "data/other.py", nested)],
                       rules=["lock-order"])
    assert [v.line for v in res.violations] == [10]
    assert "INVERTS" in res.violations[0].message


def test_signal_safe_handler_through_a_lambda():
    ok = src("""
        import signal, sys
        from x import EXIT_SIGTERM
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(EXIT_SIGTERM))
        """)
    bad = src("""
        import signal, threading
        EVT = threading.Event()
        signal.signal(signal.SIGTERM, lambda *_: EVT.set())
        """)
    path = PKG + "tools/x.py"
    assert run_rule("signal-safe-handler", ok, path) == []
    assert ".set()" in run_rule("signal-safe-handler", bad, path)[0].message


def test_thread_discipline_three_distinct_failures():
    text = src("""
        import threading
        def start(fn):
            threading.Thread(target=fn, daemon=True).start()
            threading.Thread(target=fn, name="x").start()
            threading.Thread(target=fn, name="y", daemon=False).start()
            return ", ".join(["a", "b"])
        """)
    msgs = [h.message for h in run_rule("thread-discipline", text,
                                        PKG + "data/x.py")]
    assert any("without name=" in m for m in msgs)
    assert any("explicit daemon=" in m for m in msgs)
    assert any("no .join()" in m for m in msgs)


# -- the suppression grammar -------------------------------------------------

def _exit_res(text, rules=("exit-taxonomy",)):
    return lint_sources([(PKG + "tools/x.py", text)], rules=list(rules))


def test_suppression_with_justification_applies():
    res = _exit_res("import sys\n"
                    "# cstlint-torch: disable=exit-taxonomy -- test: typed "
                    "exit held elsewhere\n"
                    "sys.exit(3)\n")
    assert res.clean and len(res.suppressed) == 1
    assert res.suppressed[0][1].justification.startswith("test:")


def test_suppression_without_justification_is_a_violation_and_inert():
    res = _exit_res("import sys\n"
                    "# cstlint-torch: disable=exit-taxonomy\n"
                    "sys.exit(3)\n")
    assert sorted(v.rule for v in res.violations) == [
        "exit-taxonomy", "suppression-format"]
    fmt = [v for v in res.violations if v.rule == "suppression-format"][0]
    assert "cstlint-torch: disable=" in fmt.message


def test_trailing_suppression_applies_to_its_line():
    res = _exit_res("import sys\n"
                    "sys.exit(3)  # cstlint-torch: disable=exit-taxonomy "
                    "-- test ok\n")
    assert res.clean and len(res.suppressed) == 1


def test_suppression_covers_a_multiline_statement():
    res = _exit_res("import sys\n"
                    "# cstlint-torch: disable=exit-taxonomy -- test: spans "
                    "the call\n"
                    "sys.exit(\n"
                    "    3)\n")
    assert res.clean and len(res.suppressed) == 1


def test_stale_suppression_reported():
    res = _exit_res("import sys\n"
                    "# cstlint-torch: disable=exit-taxonomy -- was a "
                    "literal, now fixed\n"
                    "sys.exit()\n")
    assert [v.rule for v in res.violations] == ["stale-suppression"]
    assert "was a literal" in res.violations[0].message


def test_wrong_rule_suppression_does_not_apply():
    res = _exit_res("import sys\n"
                    "# cstlint-torch: disable=atomic-write -- wrong rule on "
                    "purpose\n"
                    "sys.exit(3)\n", rules=("exit-taxonomy", "atomic-write"))
    assert sorted(v.rule for v in res.violations) == [
        "exit-taxonomy", "stale-suppression"]


def test_stale_only_for_rules_that_ran():
    res = _exit_res("import sys\n"
                    "# cstlint-torch: disable=exit-taxonomy -- held under "
                    "full runs\n"
                    "sys.exit(3)\n", rules=("atomic-write",))
    assert res.clean


def test_meta_rules_are_reserved():
    with pytest.raises(ValueError, match="reserved"):
        engine.rule("stale-suppression", "no")


def test_parse_error_is_reported():
    res = lint_sources([(PKG + "x.py", "def f(:\n")])
    assert [v.rule for v in res.violations] == ["parse-error"]


# -- the two lints read none of each other's comments ------------------------

def test_port_suppression_leaves_the_reference_lint_clean():
    """A ``# cstlint-torch:`` comment in a file the reference lints too
    (``chip_smoke.py``) is neither a stale nor a malformed suppression to
    the reference, even for a rule both lints name."""
    text = ("import sys\n"
            "def f(ts):\n"
            "    for t in ts:\n"
            "        # cstlint-torch: disable=device-scalar-fetch -- test\n"
            "        x = 1\n"
            "# cstlint-torch: disable=exit-taxonomy\n"
            "y = 2\n")
    ref = ref_lint_sources([("chip_smoke.py", text)])
    assert ref.violations == [] and ref.suppressed == []


def test_reference_suppression_is_inert_here():
    text = ("import sys\n"
            "# cstlint: disable=exit-taxonomy -- the reference's grammar\n"
            "sys.exit(3)\n")
    res = _exit_res(text)
    assert [v.rule for v in res.violations] == ["exit-taxonomy"]
    assert res.suppressed == []


# -- the clean-tree gate -------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    return lint_tree(REPO)


def test_tree_is_clean(tree):
    """The port and ``chip_smoke.py`` have no unsuppressed violation of
    any rule, and every suppression carries a justification."""
    assert tree.violations == [], "\n".join(
        v.render() for v in tree.violations)
    assert tree.files_scanned > 90
    assert sorted(tree.rules_ran) == sorted(RULES)
    for v, s in tree.suppressed:
        assert s.justification, f"unjustified suppression at {v.path}"


def test_tree_covers_the_port_and_the_smoke_only():
    files = engine.tree_files(REPO)
    assert "chip_smoke.py" in files
    assert PKG + "analysis/engine.py" in files
    assert all(f == "chip_smoke.py" or f.startswith(PKG) for f in files)


def test_tree_carries_the_concurrency_contracts(tree):
    """The port's modules declare their shared state (the reference's
    annotations at the same attributes) and their lock order."""
    from cst_captioning_tpu_torch.analysis.concurrency import (
        _lock_order_table, parse_annotations)

    files = {rel: engine.SourceFile.from_path(os.path.join(REPO, rel), rel)
             for rel in engine.tree_files(REPO)}
    kinds = {}
    for f in files.values():
        for a in parse_annotations(f):
            kinds[a.kind] = kinds.get(a.kind, 0) + 1
    assert kinds.get("guarded_by", 0) >= 25 and kinds.get("owned_by", 0) >= 35
    tables = [rel for rel, f in files.items() if _lock_order_table(f)]
    assert len(tables) >= 8


#: Findings of the first run over the port that were repaired, not
#: suppressed: (file, rule).  Each file now has no finding of the rule and
#: no suppression of it.
REPAIRED = [
    (PKG + "eval.py", "atomic-write"),
    (PKG + "tools/stage_chain.py", "monotonic-deadline"),
    (PKG + "tools/train_steps.py", "exit-taxonomy"),
]


@pytest.mark.parametrize("rel,rule", REPAIRED)
def test_repaired_findings_stay_repaired(rel, rule):
    res = lint_tree(REPO, rules=[rule], paths=[rel])
    assert res.violations == [] and res.suppressed == []


def test_json_report_schema():
    res = lint_tree(REPO, paths=[PKG + "resilience/exitcodes.py"])
    doc = json.loads(render_json(res))
    assert set(doc) == {"schema", "tool", "clean", "files_scanned",
                        "rules_ran", "summary", "violations", "suppressed"}
    assert doc["schema"] == 1 and doc["tool"] == "cstlint-torch"
    assert doc["clean"] is True and doc["files_scanned"] == 1
    assert sorted(doc["rules_ran"]) == sorted(RULES)


def test_json_report_lists_violations_and_suppressions():
    res = _exit_res("import sys\n"
                    "sys.exit(3)\n"
                    "sys.exit(4)  # cstlint-torch: disable=exit-taxonomy "
                    "-- test\n")
    doc = json.loads(render_json(res))
    assert doc["clean"] is False and doc["summary"] == {"exit-taxonomy": 1}
    assert doc["violations"][0]["line"] == 2
    assert doc["suppressed"][0]["line"] == 3
    assert doc["suppressed"][0]["justification"] == "test"


# -- the CLI -------------------------------------------------------------------

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "cst_captioning_tpu_torch.lint", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120)


def test_cli_list_rules_grouped():
    p = _cli("--list-rules")
    assert p.returncode == EXIT_OK
    conc = p.stdout.split("[concurrency]")[1].split("[core]")[0]
    core = p.stdout.split("[core]")[1]
    assert all(name in conc for name in CONCURRENCY)
    assert all(name in core for name in CORE)
    assert "donation-audit" not in p.stdout


def test_cli_whole_tree_json_is_clean():
    p = _cli("--json")
    assert p.returncode == EXIT_OK, p.stdout[-3000:] + p.stderr
    doc = json.loads(p.stdout)
    assert doc["clean"] and len(doc["rules_ran"]) == 12
    assert doc["violations"] == [] and doc["files_scanned"] > 90


def test_cli_clean_subset_exits_ok():
    p = _cli("--rules", "exit-taxonomy,thread-discipline",
             PKG + "lint.py")
    assert p.returncode == EXIT_OK, p.stdout + p.stderr
    assert "clean" in p.stdout


def test_cli_unknown_rule_is_a_usage_error():
    p = _cli("--rules", "no-such-rule")
    assert p.returncode == EXIT_USAGE
    assert "unknown rule" in p.stderr and "no-such-rule" in p.stderr
    assert "Traceback" not in p.stderr


def test_cli_violations_exit_failure(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import sys\nsys.exit(3)\n")
    p = _cli("--rules", "exit-taxonomy", str(bad))
    assert p.returncode == EXIT_FAILURE
    assert "exit-taxonomy" in p.stdout


def test_cli_unreadable_path_is_a_usage_error(tmp_path):
    p = _cli(str(tmp_path / "missing.py"))
    assert p.returncode == EXIT_USAGE
    assert "cannot read lint target" in p.stderr
