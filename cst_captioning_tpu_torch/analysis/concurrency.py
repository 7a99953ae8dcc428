"""Concurrency-contract rules: the port's threading model checked at
analysis time (the port's own copy of the reference's
``analysis/concurrency.py``, its six rules).

The serving plane is multi-threaded (reader threads -> inbox -> one
scheduler that owns intake, the loader's prefetch workers, the watchdog,
the supervisor's tick and restart threads, telemetry locks).  Its
contracts are declared in source annotations and checked by six rules:

Annotation grammar (trailing comments on attribute-declaration sites):

- ``# cstlint-torch: guarded_by=<lock expr>``: the attribute is shared
  state; every read or write outside its declaring function sits
  lexically inside ``with <lock expr>:``.  Functions named ``*_locked``
  are exempt by convention (their contract is "caller holds the lock").
- ``# cstlint-torch: owned_by=<owner>``: the attribute belongs to one
  thread (the scheduler loop, the controlling thread); functions spawned
  as ``threading.Thread(target=...)`` in the same file must not touch it.
- ``LOCK_ORDER = ("<name>", ...)``: a module-level table of canonical
  lock names in allowed acquisition order (hold earlier while acquiring
  later).  Lock expressions resolve to canonical names through
  assignments from ``locksan.named_lock("<name>")``; the same table is
  registered at runtime through ``locksan.declare_order(*LOCK_ORDER)``,
  so the static and the runtime checks read ONE declaration.

The rules consult same-file facts only (plus the project-wide union of
LOCK_ORDER tables): the AST has no types, so cross-file alias analysis
would be guesswork.  Where a heuristic over-fires, the call site carries
a justified suppression.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from .engine import Project, SourceFile, Violation, rule

_ANNOT_RE = re.compile(
    r"#\s*cstlint-torch:\s*(guarded_by|owned_by)=([A-Za-z_][\w.]*)")


def _dotted(node: ast.AST) -> str:
    """'self._lock' / 'threading.Thread' for Attribute/Name chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# -- annotation parsing ------------------------------------------------------


class _Annotation:
    """One ``guarded_by``/``owned_by`` declaration, bound to the
    attribute (``self.X`` -> ``X`` with ``is_self``) or module global
    assigned on the annotated line."""

    __slots__ = ("kind", "arg", "attr", "is_self", "line", "func")

    def __init__(self, kind: str, arg: str, attr: str, is_self: bool,
                 line: int, func: Optional[ast.AST]):
        self.kind = kind
        self.arg = arg
        self.attr = attr
        self.is_self = is_self
        self.line = line
        #: The function owning the declaration site (usually __init__);
        #: accesses inside it are construction, exempt by definition.
        self.func = func


def _assign_target(stmt: ast.stmt) -> Optional[Tuple[str, bool]]:
    """(attr name, is_self) of a single-target Assign/AnnAssign."""
    if isinstance(stmt, ast.AnnAssign):
        targets = [stmt.target]
    elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
        targets = stmt.targets
    else:
        return None
    t = targets[0]
    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
            and t.value.id == "self":
        return t.attr, True
    if isinstance(t, ast.Name):
        return t.id, False
    return None


def _enclosing_functions(tree: ast.AST) -> Dict[int, ast.AST]:
    """lineno -> innermost enclosing FunctionDef (None at module level),
    via a parent-aware walk."""
    owner: Dict[int, ast.AST] = {}

    def walk(node: ast.AST, fn: Optional[ast.AST]):
        for child in ast.iter_child_nodes(node):
            here = fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                here = child
            if hasattr(child, "lineno"):
                owner.setdefault(child.lineno, here)
            walk(child, here)

    walk(tree, None)
    return owner


def _annotation_state(f: SourceFile) -> Tuple[List[_Annotation],
                                              Dict[int, ast.AST]]:
    """(annotations, lineno -> enclosing-function map) for one file,
    memoized on the SourceFile — several rules consult it and the walks
    are whole-tree, so computing once per file per run matters."""
    cached = getattr(f, "_concurrency_state", None)
    if cached is not None:
        return cached
    if f.tree is None:
        f._concurrency_state = ([], {})
        return f._concurrency_state
    stmts_by_line: Dict[int, ast.stmt] = {}
    for node in ast.walk(f.tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            stmts_by_line.setdefault(node.lineno, node)
    owner = _enclosing_functions(f.tree)
    out: List[_Annotation] = []
    for i, text in enumerate(f.lines, start=1):
        m = _ANNOT_RE.search(text)
        if m is None:
            continue
        stmt = stmts_by_line.get(i)
        tgt = _assign_target(stmt) if stmt is not None else None
        if tgt is None:
            continue  # annotation on a non-declaration line: inert
        out.append(_Annotation(m.group(1), m.group(2), tgt[0], tgt[1],
                               i, owner.get(i)))
    f._concurrency_state = (out, owner)
    return f._concurrency_state


def parse_annotations(f: SourceFile) -> List[_Annotation]:
    return _annotation_state(f)[0]


# -- named-lock resolution + LOCK_ORDER tables -------------------------------


def _named_lock_assignments(f: SourceFile) -> Dict[str, str]:
    """Map of lock-holding expression text ('self._lock' / '_LOCK') ->
    canonical sanitizer name, from ``X = [locksan.]named_lock("name")``
    assignments anywhere in the file."""
    out: Dict[str, str] = {}
    if f.tree is None:
        return out
    for node in ast.walk(f.tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        v = node.value
        if not (isinstance(v, ast.Call) and
                _dotted(v.func).split(".")[-1] == "named_lock" and
                v.args and isinstance(v.args[0], ast.Constant) and
                isinstance(v.args[0].value, str)):
            continue
        expr = _dotted(node.targets[0])
        if expr:
            out[expr] = v.args[0].value
    return out


def _lock_order_table(f: SourceFile) -> Optional[Tuple[ast.Assign,
                                                       List[str]]]:
    """The module-level ``LOCK_ORDER = ("a", "b", ...)`` table, if any."""
    if f.tree is None:
        return None
    for node in f.tree.body if isinstance(f.tree, ast.Module) else []:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "LOCK_ORDER" and \
                isinstance(node.value, (ast.Tuple, ast.List)):
            names = [e.value for e in node.value.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str)]
            return node, names
    return None


def _is_lock_expr(expr: str, named: Dict[str, str]) -> bool:
    """Is a ``with`` context expression a lock acquisition?  Canonical
    (assigned from named_lock) or name-hinted ('lock' in the last path
    component: the _lock/_LOCK/_write_lock spellings)."""
    if expr in named:
        return True
    return "lock" in expr.split(".")[-1].lower()


# -- guarded-by --------------------------------------------------------------


class _GuardedVisitor(ast.NodeVisitor):
    """Track the lexical with-lock stack and flag annotated-attribute
    accesses outside their declared lock."""

    def __init__(self, f: SourceFile, annots: Sequence[_Annotation],
                 owner: Dict[int, ast.AST]):
        self.f = f
        self.owner = owner
        self.by_self = {a.attr: a for a in annots
                        if a.kind == "guarded_by" and a.is_self}
        self.by_global = {a.attr: a for a in annots
                          if a.kind == "guarded_by" and not a.is_self}
        self.with_stack: List[List[str]] = [[]]
        self.func_stack: List[ast.AST] = []
        self.hits: List[Violation] = []

    # Each function body starts with an EMPTY lock stack: a nested def
    # inside a `with` block runs later, on whatever thread calls it.
    def _func(self, node):
        self.func_stack.append(node)
        self.with_stack.append([])
        self.generic_visit(node)
        self.with_stack.pop()
        self.func_stack.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = _func

    def visit_With(self, node: ast.With):
        held = [_dotted(item.context_expr) for item in node.items]
        self.with_stack[-1].extend(h for h in held if h)
        self.generic_visit(node)
        for h in held:
            if h:
                self.with_stack[-1].remove(h)

    visit_AsyncWith = visit_With

    def _check(self, annot: _Annotation, node: ast.AST, shown: str):
        if self.func_stack and annot.func is self.func_stack[-1]:
            return  # construction inside the declaring function
        if annot.func is None and not self.func_stack:
            return  # module-level construction (the declaration itself)
        if any(getattr(fn, "name", "").endswith("_locked")
               for fn in self.func_stack):
            return  # *_locked convention: caller holds the lock
        if annot.arg in self.with_stack[-1]:
            return
        self.hits.append(Violation(
            "guarded-by", self.f.relpath, node.lineno, node.col_offset,
            f"'{shown}' is declared guarded_by={annot.arg} "
            f"(line {annot.line}) but is touched outside a "
            f"'with {annot.arg}:' block — shared state races the "
            "moment one access skips the lock"))

    def visit_Attribute(self, node: ast.Attribute):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            annot = self.by_self.get(node.attr)
            if annot is not None:
                self._check(annot, node, f"self.{node.attr}")
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name):
        annot = self.by_global.get(node.id)
        if annot is not None:
            self._check(annot, node, node.id)


@rule("guarded-by",
      "a '# cstlint-torch: guarded_by=<lock>' attribute is only read/written "
      "inside 'with <lock>:' (functions named *_locked are exempt)",
      category="concurrency")
def check_guarded_by(project: Project) -> Iterator[Violation]:
    for f in project.files:
        if f.tree is None:
            continue
        all_annots, owner = _annotation_state(f)
        annots = [a for a in all_annots if a.kind == "guarded_by"]
        if not annots:
            continue
        v = _GuardedVisitor(f, annots, owner)
        v.visit(f.tree)
        yield from v.hits


# -- thread-ownership --------------------------------------------------------


def _functions_by_name(tree: ast.AST) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, node)
    return out


def _thread_calls(tree: ast.AST) -> List[ast.Call]:
    return [node for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and _dotted(node.func) in ("threading.Thread", "Thread")]


def _thread_target_functions(f: SourceFile) -> List[ast.AST]:
    """FunctionDefs passed as ``target=`` to same-file Thread() calls."""
    if f.tree is None:
        return []
    funcs = _functions_by_name(f.tree)
    out: List[ast.AST] = []
    for call in _thread_calls(f.tree):
        for kw in call.keywords:
            if kw.arg != "target":
                continue
            name = _dotted(kw.value).split(".")[-1]
            fn = funcs.get(name)
            if fn is not None and fn not in out:
                out.append(fn)
    return out


def _own_body_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body EXCLUDING nested function bodies: a closure
    defined inside a thread target may legally run on another thread
    (the server's per-connection ``respond`` executes on the scheduler)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


@rule("thread-ownership",
      "a '# cstlint-torch: owned_by=<owner>' attribute is never touched from "
      "functions spawned as threading.Thread(target=...) in the file",
      category="concurrency")
def check_thread_ownership(project: Project) -> Iterator[Violation]:
    for f in project.files:
        if f.tree is None:
            continue
        owned = [a for a in parse_annotations(f) if a.kind == "owned_by"]
        if not owned:
            continue
        targets = _thread_target_functions(f)
        for fn in targets:
            for node in _own_body_nodes(fn):
                for a in owned:
                    if a.is_self:
                        hit = (isinstance(node, ast.Attribute)
                               and node.attr == a.attr
                               and isinstance(node.value, ast.Name)
                               and node.value.id == "self")
                        shown = f"self.{a.attr}"
                    else:
                        hit = (isinstance(node, ast.Name)
                               and node.id == a.attr)
                        shown = a.attr
                    if hit:
                        yield Violation(
                            "thread-ownership", f.relpath, node.lineno,
                            node.col_offset,
                            f"'{shown}' is declared owned_by={a.arg} "
                            f"(line {a.line}) but thread target "
                            f"'{getattr(fn, 'name', '?')}' touches it — "
                            "reader threads hand work to the owner "
                            "(inbox discipline), they never reach into "
                            "its state")


# -- lock-order --------------------------------------------------------------


class _WithEdgeVisitor(ast.NodeVisitor):
    """Lexically nested lock acquisitions -> (outer, inner, node) edges,
    with expressions resolved to canonical names where possible."""

    def __init__(self, f: SourceFile, named: Dict[str, str]):
        self.f = f
        self.named = named
        self.stack: List[List[Tuple[str, bool]]] = [[]]
        self.edges: List[Tuple[str, bool, str, bool, ast.AST]] = []

    def _func(self, node):
        self.stack.append([])
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = _func

    def _resolve(self, expr: str) -> Tuple[str, bool]:
        if expr in self.named:
            return self.named[expr], True
        return expr, False

    def visit_With(self, node: ast.With):
        acquired: List[Tuple[str, bool]] = []
        for item in node.items:
            expr = _dotted(item.context_expr)
            if expr and _is_lock_expr(expr, self.named):
                resolved = self._resolve(expr)
                for outer, outer_canon in self.stack[-1]:
                    self.edges.append((outer, outer_canon,
                                       resolved[0], resolved[1], node))
                acquired.append(resolved)
                self.stack[-1].append(resolved)
        self.generic_visit(node)
        for r in acquired:
            self.stack[-1].remove(r)

    visit_AsyncWith = visit_With


def _declared_graph(project: Project) -> Tuple[Set[Tuple[str, str]],
                                               Dict[str, int]]:
    """Union of every module's LOCK_ORDER table -> declared edge set +
    a name -> declaring-line map for diagnostics."""
    edges: Set[Tuple[str, str]] = set()
    where: Dict[str, int] = {}
    for f in project.files:
        table = _lock_order_table(f)
        if table is None:
            continue
        node, names = table
        for name in names:
            where.setdefault(name, node.lineno)
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                edges.add((names[i], names[j]))
    return edges, where


# One reachability definition for both analyses: the runtime sanitizer
# and this rule must agree on what "declared before" means.
from ..utils.locksan import path_exists as _path_exists  # noqa: E402


def _has_path(edges: Set[Tuple[str, str]], src: str, dst: str) -> bool:
    if src == dst:
        return False  # a lock nested under itself is not "declared"
    return _path_exists(edges, src, dst)


@rule("lock-order",
      "lexically nested lock acquisitions embed into the declared "
      "LOCK_ORDER partial order (canonical names via locksan.named_lock); "
      "inversions, undeclared pairs, and cycles are violations",
      category="concurrency")
def check_lock_order(project: Project) -> Iterator[Violation]:
    declared, _ = _declared_graph(project)
    observed: List[Tuple[str, str, str, ast.AST]] = []  # (path, a, b, node)
    for f in project.files:
        if f.tree is None:
            continue
        v = _WithEdgeVisitor(f, _named_lock_assignments(f))
        v.visit(f.tree)
        for outer, outer_canon, inner, inner_canon, node in v.edges:
            if not (outer_canon and inner_canon):
                yield Violation(
                    "lock-order", f.relpath, node.lineno, node.col_offset,
                    f"nested acquisition '{outer}' -> '{inner}' uses "
                    "unnamed locks — create them via "
                    "locksan.named_lock(...) and declare the pair in a "
                    "LOCK_ORDER table so both analyses can check it")
                continue
            if _has_path(declared, inner, outer):
                yield Violation(
                    "lock-order", f.relpath, node.lineno, node.col_offset,
                    f"acquiring '{inner}' while holding '{outer}' "
                    "INVERTS the declared LOCK_ORDER "
                    f"('{inner}' is declared before '{outer}')")
            elif not _has_path(declared, outer, inner):
                yield Violation(
                    "lock-order", f.relpath, node.lineno, node.col_offset,
                    f"nested acquisition '{outer}' -> '{inner}' is not "
                    "covered by any LOCK_ORDER table — declare it or "
                    "break the nesting")
            else:
                observed.append((f.relpath, outer, inner, node))
    # Cycle check over declared + observed edges: a mis-declared table
    # (or two tables that disagree) must fail even with no inversion at
    # a single site.
    graph = set(declared)
    graph.update((a, b) for _, a, b, _ in observed)
    for path, a, b, node in observed:
        if _has_path(graph - {(a, b)}, b, a):
            yield Violation(
                "lock-order", path, node.lineno, node.col_offset,
                f"acquisition edge '{a}' -> '{b}' closes a cycle in the "
                "combined declared+observed lock graph — the declared "
                "order and the code disagree somewhere on this loop")


# -- signal-safe-handler -----------------------------------------------------

#: Calls that are not async-signal-safe(-ish): anything taking a lock the
#: interrupted thread may hold (logging, print's stdout lock, Event/Lock
#: ops, queues) or allocating heavily.  The shipped handler
#: (resilience/preemption.py) sets a plain-bool flag and calls os.write.
_UNSAFE_METHODS = frozenset(
    {"acquire", "wait", "notify", "notify_all", "set", "clear", "put",
     "debug", "info", "warning", "error", "critical", "exception", "log"})
_UNSAFE_PREFIXES = ("logging.", "threading.", "queue.")
_UNSAFE_NAMES = frozenset({"print"})


def _called_names(fn: ast.AST) -> Iterator[str]:
    """Same-file callables a function invokes: bare names and self.X."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if d.startswith("self."):
                yield d[len("self."):]
            elif d and "." not in d:
                yield d


def _signal_handlers(f: SourceFile) -> List[Tuple[ast.AST, ast.Call]]:
    """(handler function/lambda, registering call) for every same-file
    ``signal.signal(sig, handler)`` site."""
    if f.tree is None:
        return []
    funcs = _functions_by_name(f.tree)
    out: List[Tuple[ast.AST, ast.Call]] = []
    for node in ast.walk(f.tree):
        if not (isinstance(node, ast.Call)
                and _dotted(node.func) == "signal.signal"
                and len(node.args) >= 2):
            continue
        h = node.args[1]
        if isinstance(h, ast.Lambda):
            out.append((h, node))
            continue
        name = _dotted(h).split(".")[-1]
        fn = funcs.get(name)
        if fn is not None:
            out.append((fn, node))
    return out


@rule("signal-safe-handler",
      "functions reachable from a signal.signal handler stay "
      "async-signal-safe: no Event/Lock ops, no logging/print/queue "
      "calls (a flag and os.write only, as resilience/preemption.py does)",
      category="concurrency")
def check_signal_safe_handler(project: Project) -> Iterator[Violation]:
    for f in project.files:
        if f.tree is None:
            continue
        handlers = _signal_handlers(f)
        if not handlers:
            continue
        funcs = _functions_by_name(f.tree)
        for handler, _reg in handlers:
            # Reachability closure over same-file calls (bare names and
            # self.<method>), handler included.
            reach: List[ast.AST] = [handler]
            seen: Set[int] = {id(handler)}
            frontier = [handler]
            while frontier:
                fn = frontier.pop()
                for name in _called_names(fn):
                    callee = funcs.get(name)
                    if callee is not None and id(callee) not in seen:
                        seen.add(id(callee))
                        reach.append(callee)
                        frontier.append(callee)
            hname = getattr(handler, "name", "<lambda>")
            for fn in reach:
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    d = _dotted(node.func)
                    bad = None
                    if d in _UNSAFE_NAMES:
                        bad = f"{d}() takes the interpreter's I/O lock"
                    elif any(d.startswith(p) for p in _UNSAFE_PREFIXES):
                        bad = f"{d}() allocates/locks"
                    elif isinstance(node.func, ast.Attribute) and \
                            node.func.attr in _UNSAFE_METHODS:
                        bad = (f".{node.func.attr}() may take a "
                               "non-reentrant lock the interrupted "
                               "thread already holds")
                    if bad is not None:
                        yield Violation(
                            "signal-safe-handler", f.relpath,
                            node.lineno, node.col_offset,
                            f"{bad} — reachable from signal handler "
                            f"'{hname}'; a nested signal at the next "
                            "bytecode boundary deadlocks the process "
                            "(resilience/preemption.py sets a "
                            "plain-bool flag and calls os.write only)")


# -- thread-discipline -------------------------------------------------------


def _is_thread_join(n: ast.AST) -> bool:
    """A THREAD join, not str.join: Thread.join takes no args, a bare
    numeric timeout, or timeout= — str.join always passes an iterable,
    so requiring numeric/absent arguments keeps 'there is a reap site'
    from being satisfied by a ', '.join(...) somewhere in the file."""
    if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "join"):
        return False
    if len(n.args) > 1:
        return False
    if n.args and not (isinstance(n.args[0], ast.Constant)
                       and isinstance(n.args[0].value, (int, float))
                       and not isinstance(n.args[0].value, bool)):
        return False
    return all(kw.arg == "timeout" for kw in n.keywords)


@rule("thread-discipline",
      "every threading.Thread(...) states name= and daemon=; a "
      "daemon=False thread needs a reachable .join() in the file",
      category="concurrency")
def check_thread_discipline(project: Project) -> Iterator[Violation]:
    for f in project.files:
        if f.tree is None:
            continue
        has_join = any(_is_thread_join(n) for n in ast.walk(f.tree))
        for call in _thread_calls(f.tree):
            kwargs = {kw.arg: kw.value for kw in call.keywords
                      if kw.arg is not None}
            if "name" not in kwargs:
                yield Violation(
                    "thread-discipline", f.relpath, call.lineno,
                    call.col_offset,
                    "threading.Thread(...) without name= — anonymous "
                    "threads are unattributable in trace viewers, "
                    "heartbeats, and sanitizer receipts")
            if "daemon" not in kwargs:
                yield Violation(
                    "thread-discipline", f.relpath, call.lineno,
                    call.col_offset,
                    "threading.Thread(...) without an explicit daemon= — "
                    "state whether process exit may abandon this thread")
            else:
                d = kwargs["daemon"]
                if isinstance(d, ast.Constant) and d.value is False \
                        and not has_join:
                    yield Violation(
                        "thread-discipline", f.relpath, call.lineno,
                        call.col_offset,
                        "daemon=False thread with no .join() anywhere in "
                        "the file — a non-daemon thread that is never "
                        "reaped blocks interpreter shutdown")


# -- monotonic-deadline ------------------------------------------------------


def _walltime_calls(node: ast.AST) -> List[ast.Call]:
    return [n for n in ast.walk(node)
            if isinstance(n, ast.Call) and _dotted(n.func) == "time.time"]


@rule("monotonic-deadline",
      "deadline/timeout arithmetic and comparisons use time.monotonic(), "
      "never time.time() (wall clock steps under NTP; bare timestamp "
      "reads are fine)",
      category="concurrency")
def check_monotonic_deadline(project: Project) -> Iterator[Violation]:
    for f in project.files:
        if f.tree is None:
            continue
        flagged: Set[Tuple[int, int]] = set()
        for node in ast.walk(f.tree):
            if isinstance(node, ast.BinOp) and \
                    isinstance(node.op, (ast.Add, ast.Sub)):
                hits = _walltime_calls(node.left) + \
                    _walltime_calls(node.right)
            elif isinstance(node, ast.Compare):
                hits = _walltime_calls(node.left)
                for cmp in node.comparators:
                    hits.extend(_walltime_calls(cmp))
            else:
                continue
            for call in hits:
                key = (call.lineno, call.col_offset)
                if key in flagged:
                    continue
                flagged.add(key)
                yield Violation(
                    "monotonic-deadline", f.relpath, call.lineno,
                    call.col_offset,
                    "time.time() in deadline/duration arithmetic — an "
                    "NTP step or operator clock change corrupts the "
                    "wait; use time.monotonic() (serving/engine.py's "
                    "clock).  Wall-clock TIMESTAMPS (log records, "
                    "snapshots) are exempt because they do no "
                    "arithmetic")
