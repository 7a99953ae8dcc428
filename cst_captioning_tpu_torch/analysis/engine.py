"""cstlint-torch rule engine: sources, suppressions, registry, runner,
output (the port's own copy of the reference's ``analysis/engine.py``).

The engine is small and uses the standard library only (``ast`` and
``tokenize``).  Rules are registered by name and checked against a
:class:`Project` (every source file parsed once); each raw finding then
passes through the suppression layer:

- ``# cstlint-torch: disable=<rule>[,<rule>...] -- <justification>``
  suppresses the named rule(s) on the comment's own line (trailing
  comment) or on the next non-blank, non-comment line (standalone
  comment), over the whole statement that starts there.
- The justification after ``--`` is REQUIRED: a suppression without one
  is itself a violation (``suppression-format``) and does not apply.
- A suppression that no longer matches any raw finding of its rule is
  reported as ``stale-suppression`` (only for rules that actually ran,
  so a ``--rules`` subset never expires the others' suppressions).

The grammar's tag is ``cstlint-torch:``, not the reference's
``cstlint:``: the reference's lint also reads ``chip_smoke.py``, and a
``# cstlint: disable=`` comment there for a rule that both lints name
(``device-scalar-fetch``, say) would be a stale suppression to the
reference.  Neither lint reads the other's comments.

Meta rules (``parse-error``, ``suppression-format``,
``stale-suppression``) belong to the engine and cannot be suppressed.
"""

from __future__ import annotations

import ast
import glob
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

#: Engine/format version stamped into the JSON report (the reference's).
LINT_SCHEMA = 1
#: The tool's name in the JSON report.
TOOL = "cstlint-torch"
#: The comment tag of suppressions and concurrency annotations.
TAG = "cstlint-torch:"

#: Rule registry: name -> Rule, filled by the @rule decorator when
#: ``analysis.rules`` and ``analysis.concurrency`` are imported.
RULES: Dict[str, "Rule"] = {}

#: Engine-owned finding kinds; never suppressible, always reported.
META_RULES = ("parse-error", "suppression-format", "stale-suppression")

_SUPPRESS_RE = re.compile(
    r"#\s*cstlint-torch:\s*disable=([A-Za-z0-9_-]+(?:\s*,\s*[A-Za-z0-9_-]+)*)"
    r"\s*(?:--\s*(.*\S))?\s*$")


@dataclass(frozen=True)
class Violation:
    """One finding, anchored to a source line."""

    rule: str
    path: str          # repo-relative path (or the virtual path in tests)
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"


@dataclass
class Suppression:
    """One parsed ``cstlint-torch: disable`` comment."""

    rules: Tuple[str, ...]
    path: str
    comment_line: int      # line the comment sits on
    target_line: int       # line the suppression applies to
    justification: str     # "" when missing (-> suppression-format)
    used_rules: set = field(default_factory=set)


class Rule:
    """A registered check.  ``check(project)`` yields raw Violations;
    the engine applies suppressions afterwards."""

    def __init__(self, name: str, doc: str,
                 check: Callable[["Project"], Iterable[Violation]],
                 category: str = "core"):
        self.name = name
        self.doc = doc
        self._check = check
        #: Reporting group ("core" | "concurrency"); ``--list-rules`` and
        #: the human summary line group by it.
        self.category = category

    def check(self, project: "Project") -> Iterable[Violation]:
        return self._check(project)


def rule(name: str, doc: str, category: str = "core"):
    """Decorator registering a check function under ``name``."""
    if name in META_RULES:
        raise ValueError(f"{name!r} is reserved for the engine")

    def deco(fn):
        RULES[name] = Rule(name, doc, fn, category=category)
        return fn

    return deco


class SourceFile:
    """One parsed source: AST, comments and suppression table."""

    def __init__(self, relpath: str, text: str):
        self.relpath = relpath.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.parse_error: Optional[str] = None
        try:
            self.tree: Optional[ast.AST] = ast.parse(text)
        except SyntaxError as e:
            self.tree = None
            self.parse_error = f"{e.msg} (line {e.lineno})"
        self.suppressions: List[Suppression] = self._scan_suppressions()

    @classmethod
    def from_path(cls, path: str, relpath: str) -> "SourceFile":
        with open(path, encoding="utf-8") as f:
            return cls(relpath, f.read())

    # -- suppression comments ---------------------------------------------

    def _scan_suppressions(self) -> List[Suppression]:
        out: List[Suppression] = []
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return out
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if m is None:
                continue
            names = tuple(r.strip() for r in m.group(1).split(","))
            line = tok.start[0]
            standalone = not self.lines[line - 1][:tok.start[1]].strip()
            target = self._next_code_line(line) if standalone else line
            out.append(Suppression(
                rules=names, path=self.relpath, comment_line=line,
                target_line=target, justification=m.group(2) or ""))
        return out

    def _next_code_line(self, after: int) -> int:
        """First non-blank, non-comment line after ``after`` (1-based):
        the line a standalone suppression comment governs."""
        for i in range(after, len(self.lines)):
            stripped = self.lines[i].strip()
            if stripped and not stripped.startswith("#"):
                return i + 1
        return after  # a comment at the end of the file governs itself

    def statement_span(self, line: int) -> Tuple[int, int]:
        """(first, last) physical line of the statement STARTING at
        ``line``: a suppression governs the whole statement, so a
        multi-line call needs one comment, not one per line."""
        if self.tree is None:
            return line, line
        end = line
        for node in ast.walk(self.tree):
            if isinstance(node, ast.stmt) and node.lineno == line:
                # The outermost statement starting here wins (an ``if``'s
                # arms start below its test line).
                body_start = min(
                    (s.lineno for s in ast.iter_child_nodes(node)
                     if isinstance(s, ast.stmt)), default=None)
                stop = node.end_lineno or line
                if body_start is not None and body_start > line:
                    stop = min(stop, body_start - 1)
                end = max(end, stop)
        return line, end


class Project:
    """Every source file of one lint run."""

    def __init__(self, files: Sequence[SourceFile]):
        self.files = list(files)


@dataclass
class LintResult:
    """Outcome of one run.  ``violations`` includes the meta findings
    (stale, format, parse); ``clean`` is the gate."""

    violations: List[Violation]
    suppressed: List[Tuple[Violation, Suppression]]
    rules_ran: List[str]
    files_scanned: int

    @property
    def clean(self) -> bool:
        return not self.violations

    def summary(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v in self.violations:
            out[v.rule] = out.get(v.rule, 0) + 1
        return out


# -- tree discovery ----------------------------------------------------------

#: The port's package (walked recursively) and its top-level entry points,
#: relative to the repo root.  The JAX package, ``scripts/`` and the other
#: top-level files are the reference lint's; the tests are out of scope.
TREE_ROOTS = ("cst_captioning_tpu_torch",)
TREE_FILES = ("chip_smoke.py",)
_EXCLUDE_DIRS = ("__pycache__",)


def tree_files(root: str) -> List[str]:
    """Repo-relative paths of every linted source file under ``root``."""
    out: List[str] = []
    for sub in TREE_ROOTS:
        base = os.path.join(root, sub)
        for path in sorted(glob.glob(os.path.join(base, "**", "*.py"),
                                     recursive=True)):
            rel = os.path.relpath(path, root)
            if any(part in _EXCLUDE_DIRS for part in rel.split(os.sep)):
                continue
            out.append(rel)
    out.extend(rel for rel in TREE_FILES
               if os.path.isfile(os.path.join(root, rel)))
    return out


# -- the runner --------------------------------------------------------------

def _resolve_rules(names: Optional[Sequence[str]]) -> List[Rule]:
    if names is None:
        return [RULES[k] for k in sorted(RULES)]
    missing = [n for n in names if n not in RULES]
    if missing:
        raise KeyError(f"unknown rule(s): {', '.join(missing)}; "
                       f"known: {', '.join(sorted(RULES))}")
    return [RULES[n] for n in names]


def run_rules(project: Project,
              rules: Optional[Sequence[str]] = None) -> LintResult:
    """Check ``project``, apply suppressions, report stale ones."""
    selected = _resolve_rules(rules)
    ran = [r.name for r in selected]

    raw: List[Violation] = []
    for f in project.files:
        if f.parse_error is not None:
            raw.append(Violation("parse-error", f.relpath, 1, 0,
                                 f"cannot parse: {f.parse_error}"))
    for r in selected:
        raw.extend(r.check(project))

    # Index suppressions by (path, rule) -> [(span, suppression)]; one
    # without the required justification is flagged and does not apply.
    visible: List[Violation] = []
    suppressed: List[Tuple[Violation, Suppression]] = []
    sup_index: Dict[Tuple[str, str],
                    List[Tuple[Tuple[int, int], Suppression]]] = {}
    for f in project.files:
        for s in f.suppressions:
            if not s.justification:
                visible.append(Violation(
                    "suppression-format", s.path, s.comment_line, 0,
                    "suppression lacks a justification: write "
                    f"'# {TAG} disable=<rule> -- <why this is safe>'"))
                continue
            span = f.statement_span(s.target_line)
            for name in s.rules:
                sup_index.setdefault((s.path, name), []).append((span, s))

    for v in raw:
        match = None
        if v.rule not in META_RULES:
            for (lo, hi), s in sup_index.get((v.path, v.rule), ()):
                if lo <= v.line <= hi:
                    match = s
                    break
        if match is not None:
            match.used_rules.add(v.rule)
            suppressed.append((v, match))
        else:
            visible.append(v)

    ran_set = set(ran)
    for f in project.files:
        for s in f.suppressions:
            if not s.justification:
                continue
            for name in s.rules:
                if name in ran_set and name not in s.used_rules:
                    visible.append(Violation(
                        "stale-suppression", s.path, s.comment_line, 0,
                        f"'{name}' no longer fires on line "
                        f"{s.target_line}: remove the suppression "
                        f"(justification was: {s.justification})"))

    visible.sort(key=lambda v: (v.path, v.line, v.rule))
    return LintResult(violations=visible, suppressed=suppressed,
                      rules_ran=ran, files_scanned=len(project.files))


def lint_sources(sources: Sequence[Tuple[str, str]],
                 rules: Optional[Sequence[str]] = None) -> LintResult:
    """Lint in-memory (relpath, text) pairs."""
    project = Project([SourceFile(rel, text) for rel, text in sources])
    return run_rules(project, rules=rules)


def lint_tree(root: str, rules: Optional[Sequence[str]] = None,
              paths: Optional[Sequence[str]] = None) -> LintResult:
    """Lint the repo tree (or an explicit repo-relative ``paths`` list)."""
    rels = list(paths) if paths else tree_files(root)
    files = [SourceFile.from_path(os.path.join(root, rel), rel)
             for rel in rels]
    return run_rules(Project(files), rules=rules)


# -- output ------------------------------------------------------------------

def render_human(result: LintResult) -> str:
    lines = [v.render() for v in result.violations]
    counts = result.summary()
    if counts:
        # The per-rule summary grouped by category (core, concurrency).
        groups: Dict[str, List[str]] = {}
        for name, n in sorted(counts.items()):
            cat = RULES[name].category if name in RULES else "meta"
            groups.setdefault(cat, []).append(f"{name}={n}")
        per_rule = " | ".join(
            f"{cat}: " + ", ".join(parts)
            for cat, parts in sorted(groups.items()))
        lines.append(f"{TOOL}: {len(result.violations)} violation(s) "
                     f"[{per_rule}] in {result.files_scanned} file(s)")
    else:
        lines.append(
            f"{TOOL}: clean — {result.files_scanned} file(s), "
            f"{len(result.rules_ran)} rule(s), "
            f"{len(result.suppressed)} justified suppression(s)")
    return "\n".join(lines)


def render_json(result: LintResult) -> str:
    """The reference's JSON report (schema 1, the same keys) plus
    ``tool``."""
    doc = {
        "schema": LINT_SCHEMA,
        "tool": TOOL,
        "clean": result.clean,
        "files_scanned": result.files_scanned,
        "rules_ran": result.rules_ran,
        "summary": result.summary(),
        "violations": [vars(v) for v in result.violations],
        "suppressed": [
            {**vars(v), "justification": s.justification,
             "comment_line": s.comment_line}
            for v, s in result.suppressed
        ],
    }
    return json.dumps(doc, indent=2, sort_keys=True)
