"""The port's AST rules: the reference's six core rules (its
``analysis/rules.py``) keyed on this package's paths and on torch.

All are static heuristics.  Where the AST cannot prove that a value is
host-side (Python has no types here), a rule errs toward flagging inside
its scope and the call site carries a justified suppression instead: the
suppression's text documents why the site is safe.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from .engine import Project, SourceFile, Violation, rule

PKG = "cst_captioning_tpu_torch/"

# ---------------------------------------------------------------------------
# device-scalar-fetch
# ---------------------------------------------------------------------------

#: Hot-path files and directories: the port's counterparts of the
#: reference's ``HOT_PATHS`` plus the modules where the port's hot loops
#: live (the fused CST step, the rollout's chunk loop).  A fetch in a loop
#: here waits for the card once per iteration: the host stalls until the
#: queue drains, and the launches behind the fetch start late.
HOT_PATHS = tuple(PKG + p for p in (
    "training/trainer.py",
    "training/pipeline.py",
    "training/rewards.py",
    "training/steps.py",
    "ops/sampling.py",
    "serving/engine.py",
    "serving/server.py",
    "serving/fleet.py",
    "serving/supervisor.py",
    "serving/journal.py",
    "serving/autoscale.py",
    "telemetry/lifecycle.py",
    "telemetry/fleetobs.py",
    "parallel/",
    "data/loader.py",
    "data/sharding.py",
))

#: Conversions that copy a CUDA tensor's value to the host when applied to
#: one; always fetches when called as methods with no arguments.
_FETCH_METHODS = ("item", "tolist", "cpu", "numpy")
#: Builtins that fetch when their argument is a tensor.
_FETCH_NAMES = {"float", "int", "bool"}


def _is_hot(relpath: str) -> bool:
    return any(relpath == p or (p.endswith("/") and relpath.startswith(p))
               for p in HOT_PATHS)


def _dotted(node: ast.AST) -> str:
    """'np.asarray' for Attribute/Name chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _callees(func: ast.AST) -> List[str]:
    """The dotted names a call may resolve to: one for ``f(x)``; each
    alternative for ``(a or b)(x)`` and ``(a if c else b)(x)``."""
    if isinstance(func, ast.BoolOp):
        return [n for v in func.values for n in _callees(v)]
    if isinstance(func, ast.IfExp):
        return _callees(func.body) + _callees(func.orelse)
    return [_dotted(func)]


def _host_safe(node: ast.AST) -> bool:
    """Conservatively true when the expression cannot be a tensor:
    literals, len()/range()/time.* results, ``.shape`` lookups, and
    arithmetic or comparisons built from those (the reference's test)."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Call):
        name = _dotted(node.func)
        if name in ("len", "range", "ord", "str", "repr", "id") or \
                name.startswith("time.") or name.startswith("os."):
            return True
        return False
    if isinstance(node, ast.Attribute) and node.attr in ("shape", "ndim",
                                                         "size", "dtype"):
        return True
    if isinstance(node, ast.Subscript):
        return _host_safe(node.value)
    if isinstance(node, ast.BinOp):
        return _host_safe(node.left) and _host_safe(node.right)
    if isinstance(node, ast.UnaryOp):
        return _host_safe(node.operand)
    if isinstance(node, ast.BoolOp):
        return all(_host_safe(v) for v in node.values)
    return False


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")``, ``x.to(device="cpu")`` or ``x.to(torch.device(
    "cpu"))``."""
    args = list(node.args[:1]) + [kw.value for kw in node.keywords
                                  if kw.arg == "device"]
    for a in args:
        if isinstance(a, ast.Call) and _dotted(a.func) == "torch.device" \
                and a.args:
            a = a.args[0]
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
    return False


class _LoopFetchVisitor(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.relpath = relpath
        self.depth = 0
        self.hits: List[Violation] = []

    def _loop(self, node):
        self.depth += 1
        self.generic_visit(node)
        self.depth -= 1

    visit_For = visit_While = visit_AsyncFor = _loop

    def visit_Call(self, node: ast.Call):
        if self.depth > 0:
            names = _callees(node.func)
            fetch = next((n for n in names if n in _FETCH_NAMES), None)
            attr = node.func.attr if isinstance(node.func,
                                                ast.Attribute) else ""
            msg = None
            if attr in _FETCH_METHODS and not node.args \
                    and not node.keywords:
                msg = f".{attr}() copies a tensor to the host"
            elif attr == "to" and _to_cpu(node):
                msg = ".to('cpu') copies a tensor to the host"
            elif "torch.cuda.synchronize" in names:
                msg = "torch.cuda.synchronize() waits for the card"
            elif fetch is not None and len(node.args) == 1 and \
                    not _host_safe(node.args[0]):
                msg = f"{fetch}() on a possibly-device value forces a sync"
            elif {"np.asarray", "numpy.asarray"} & set(names) \
                    and node.args and not _host_safe(node.args[0]):
                msg = "np.asarray() on a possibly-device value forces a copy"
            if msg is not None:
                self.hits.append(Violation(
                    "device-scalar-fetch", self.relpath, node.lineno,
                    node.col_offset,
                    msg + " inside a hot-path loop: keep values on the "
                    "device and fetch once after the loop (each fetch "
                    "stalls the host until the card's queue drains)"))
        self.generic_visit(node)


@rule("device-scalar-fetch",
      "no per-iteration device fetches (.item()/.tolist()/.cpu()/.numpy()/"
      ".to('cpu')/torch.cuda.synchronize/float/int/bool/np.asarray) in "
      "trainer/steps/rollout/serving/parallel hot-path loops")
def check_device_scalar_fetch(project: Project) -> Iterator[Violation]:
    for f in project.files:
        if f.tree is None or not _is_hot(f.relpath):
            continue
        v = _LoopFetchVisitor(f.relpath)
        v.visit(f.tree)
        yield from v.hits


# ---------------------------------------------------------------------------
# atomic-write
# ---------------------------------------------------------------------------

#: The one module allowed to spell the raw write (it IS the discipline).
_ATOMIC_HOME = PKG + "resilience/integrity.py"


def _json_path_expr(node: ast.AST) -> bool:
    """Does this expression look like a *.json/*.jsonl path?  Literal
    suffixes, f-string tails, os.path.join tails and name hints
    ('...json...'): heuristic by design."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.endswith((".json", ".jsonl"))
    if isinstance(node, ast.JoinedStr) and node.values:
        last = node.values[-1]
        return isinstance(last, ast.Constant) and \
            isinstance(last.value, str) and \
            last.value.endswith((".json", ".jsonl"))
    if isinstance(node, ast.Call) and \
            _dotted(node.func) in ("os.path.join", "posixpath.join") and \
            node.args:
        return _json_path_expr(node.args[-1])
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _json_path_expr(node.right)
    if isinstance(node, (ast.Name, ast.Attribute)):
        tail = node.id if isinstance(node, ast.Name) else node.attr
        return "json" in tail.lower()
    return False


def _open_mode(node: ast.Call) -> Optional[ast.AST]:
    """The mode expression of an ``open()`` call: positional argument 1
    or the ``mode=`` keyword."""
    if len(node.args) >= 2:
        return node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            return kw.value
    return None


def _is_text_write_mode(mode: Optional[ast.AST]) -> bool:
    return (isinstance(mode, ast.Constant) and
            isinstance(mode.value, str) and
            "w" in mode.value and "b" not in mode.value)


@rule("atomic-write",
      "durable *.json/*.jsonl writes go through "
      "resilience.integrity.atomic_json_write (fsync'd tmp + rename + "
      "dir fsync)")
def check_atomic_write(project: Project) -> Iterator[Violation]:
    for f in project.files:
        if f.tree is None or f.relpath == _ATOMIC_HOME:
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if name == "json.dump":
                yield Violation(
                    "atomic-write", f.relpath, node.lineno,
                    node.col_offset,
                    "json.dump to a raw handle can be torn by a crash: "
                    "route durable JSON through "
                    "resilience.integrity.atomic_json_write")
            elif name == "open" and node.args and \
                    _is_text_write_mode(_open_mode(node)) and \
                    _json_path_expr(node.args[0]):
                yield Violation(
                    "atomic-write", f.relpath, node.lineno,
                    node.col_offset,
                    "open(<*.json path>, 'w') bypasses the atomic-write "
                    "discipline: use "
                    "resilience.integrity.atomic_json_write")


# ---------------------------------------------------------------------------
# journal-append
# ---------------------------------------------------------------------------

#: The one module allowed to open a write-ahead segment for writing: its
#: ``_append`` is the single fsync'd frame-stamp-crc path of every record.
_JOURNAL_HOME = PKG + "serving/journal.py"


def _wal_path_expr(node: ast.AST) -> bool:
    """Does this expression look like a journal segment path?  ``*.wal``
    suffixes, f-string tails, os.path.join tails, and name hints
    ('...wal...'/'...journal...')."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.endswith(".wal")
    if isinstance(node, ast.JoinedStr) and node.values:
        last = node.values[-1]
        return isinstance(last, ast.Constant) and \
            isinstance(last.value, str) and last.value.endswith(".wal")
    if isinstance(node, ast.Call) and \
            _dotted(node.func) in ("os.path.join", "posixpath.join") and \
            node.args:
        return _wal_path_expr(node.args[-1])
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _wal_path_expr(node.right)
    if isinstance(node, (ast.Name, ast.Attribute)):
        tail = node.id if isinstance(node, ast.Name) else node.attr
        tail = tail.lower()
        return "wal" in tail or "journal" in tail
    return False


def _is_mutating_mode(mode: Optional[ast.AST]) -> bool:
    return (isinstance(mode, ast.Constant) and
            isinstance(mode.value, str) and
            ("w" in mode.value or "a" in mode.value or
             "+" in mode.value))


@rule("journal-append",
      "write-ahead segments (*.wal) are written ONLY by serving/"
      "journal.py's fsync'd append helper: a raw open elsewhere can tear "
      "the exactly-once record")
def check_journal_append(project: Project) -> Iterator[Violation]:
    for f in project.files:
        if f.tree is None or f.relpath == _JOURNAL_HOME:
            continue
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Call) and \
                    _dotted(node.func) == "open" and node.args and \
                    _is_mutating_mode(_open_mode(node)) and \
                    _wal_path_expr(node.args[0]):
                yield Violation(
                    "journal-append", f.relpath, node.lineno,
                    node.col_offset,
                    "open(<*.wal path>) for writing outside the journal "
                    "module: every journal record must take "
                    "IntakeJournal's one fsync'd append path (frame, "
                    "schema stamp, crc), or replay after a crash sees "
                    "bytes the supervisor never acknowledged")


# ---------------------------------------------------------------------------
# declared-counters
# ---------------------------------------------------------------------------

def _counter_sites(f: SourceFile):
    """-> (declared names, [(incremented name, lineno, col)])."""
    declared: Set[str] = set()
    incs: List[Tuple[str, int, int]] = []
    if f.tree is None:
        return declared, incs
    for node in ast.walk(f.tree):
        if isinstance(node, ast.Assign):
            # A *COUNTERS*-named table of string literals is a declare
            # site (it is splat into registry.declare).
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and "COUNTERS" in tgt.id and \
                        isinstance(node.value, (ast.Tuple, ast.List)):
                    declared.update(e.value for e in node.value.elts
                                    if isinstance(e, ast.Constant)
                                    and isinstance(e.value, str))
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        attr = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else "")
        if attr == "declare":
            for a in node.args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    declared.add(a.value)
        elif attr in ("inc", "_inc") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            incs.append((node.args[0].value, node.lineno, node.col_offset))
    return declared, incs


@rule("declared-counters",
      "every literal counter increment has a declare-at-0 site "
      "(registry.declare or a COUNTERS table) somewhere in the tree")
def check_declared_counters(project: Project) -> Iterator[Violation]:
    declared: Set[str] = set()
    per_file = []
    for f in project.files:
        d, incs = _counter_sites(f)
        declared |= d
        per_file.append((f, incs))
    for f, incs in per_file:
        for name, line, col in incs:
            if name not in declared:
                yield Violation(
                    "declared-counters", f.relpath, line, col,
                    f"counter '{name}' is incremented but never declared "
                    "at 0: add it to the owner's registry.declare() or "
                    "COUNTERS table, so a snapshot tells 'armed, nothing "
                    "happened' from 'feature absent'")


# ---------------------------------------------------------------------------
# exit-taxonomy
# ---------------------------------------------------------------------------

_EXIT_HOME = PKG + "resilience/exitcodes.py"


def _int_literal(node: Optional[ast.AST]) -> bool:
    """True for int literals, the negative spelling ``sys.exit(-1)``
    included."""
    if isinstance(node, ast.UnaryOp) and \
            isinstance(node.op, (ast.USub, ast.UAdd)):
        node = node.operand
    return (isinstance(node, ast.Constant) and
            isinstance(node.value, int) and
            not isinstance(node.value, bool))


@rule("exit-taxonomy",
      "process exits spell a resilience.exitcodes constant, never a bare "
      "int literal (and never a string: that exits 1 untyped)")
def check_exit_taxonomy(project: Project) -> Iterator[Violation]:
    for f in project.files:
        if f.tree is None or f.relpath == _EXIT_HOME:
            continue
        for node in ast.walk(f.tree):
            arg = None
            if isinstance(node, ast.Call) and \
                    _dotted(node.func) in ("sys.exit", "exit", "os._exit"):
                arg = node.args[0] if node.args else None
            elif isinstance(node, ast.Raise) and \
                    isinstance(node.exc, ast.Call) and \
                    _dotted(node.exc.func) == "SystemExit":
                arg = node.exc.args[0] if node.exc.args else None
            else:
                continue
            if _int_literal(arg):
                yield Violation(
                    "exit-taxonomy", f.relpath, node.lineno,
                    node.col_offset,
                    "exit with a bare int literal: name it through "
                    "resilience.exitcodes (EXIT_*) so a harness can "
                    "classify the death")
            elif isinstance(arg, ast.JoinedStr) or (
                    isinstance(arg, ast.Constant) and
                    isinstance(arg.value, str)):
                yield Violation(
                    "exit-taxonomy", f.relpath, node.lineno,
                    node.col_offset,
                    "sys.exit(<string>) exits 1 with the message on "
                    "stderr, outside the taxonomy: use parser.error() "
                    "(usage, EXIT_USAGE) or print and an EXIT_* constant")
            elif isinstance(arg, ast.IfExp) and any(
                    _int_literal(b) for b in (arg.body, arg.orelse)):
                yield Violation(
                    "exit-taxonomy", f.relpath, node.lineno,
                    node.col_offset,
                    "exit with conditional int literals: name both "
                    "branches through resilience.exitcodes (EXIT_*)")


# ---------------------------------------------------------------------------
# bare-except-swallow
# ---------------------------------------------------------------------------

#: Failure-domain code where a silently swallowed exception is itself a
#: fault: one bad line or chunk must be counted or logged.
_SWALLOW_SCOPE = (PKG + "serving/", PKG + "resilience/")


def _broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    return any(isinstance(n, ast.Name) and
               n.id in ("Exception", "BaseException") for n in names)


def _body_accounts(handler: ast.ExceptHandler) -> bool:
    """True when the handler does anything observable (a log call, a
    counter, a re-raise, an assignment); only a body of pass and
    docstrings swallows silently."""
    for stmt in handler.body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     ast.Constant):
            continue
        return True
    return False


@rule("bare-except-swallow",
      "serving/resilience code may not swallow Exception silently: count "
      "it or log it (one bad line must be visible)")
def check_bare_except_swallow(project: Project) -> Iterator[Violation]:
    for f in project.files:
        if f.tree is None or \
                not any(f.relpath.startswith(p) for p in _SWALLOW_SCOPE):
            continue
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ExceptHandler) and \
                    _broad_handler(node) and not _body_accounts(node):
                yield Violation(
                    "bare-except-swallow", f.relpath, node.lineno,
                    node.col_offset,
                    "broad except swallows silently in failure-domain "
                    "code: increment a counter or log before going on "
                    "(a fault nobody counted never happened)")
