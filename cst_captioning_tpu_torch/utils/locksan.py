"""Runtime lock sanitizer: every acquisition checked against the declared
lock order (own copy of the reference's ``utils/locksan.py``, the same
names, environment variables and receipt).

- :func:`named_lock` is the port's lock factory.  Disarmed (the default)
  it returns a plain ``threading.Lock``.  With ``CST_LOCK_SANITIZER=1``
  in the environment when the lock is CREATED it returns a
  :class:`_SanitizedLock`, which records, per thread, every "acquired B
  while holding A" edge.
- :func:`declare_order` registers a module's ``LOCK_ORDER`` table:
  ``names[i]`` may be held while acquiring ``names[j]`` for ``i < j``.
- Each sanitized acquisition checks its edges BEFORE it blocks.  An edge
  that inverts a declared path, or that no table declares, writes a
  receipt through ``resilience.integrity.atomic_json_write`` (to
  ``CST_LOCK_SANITIZER_RECEIPT``, default
  ``/tmp/cst_locksan_violation.json``) and raises
  :class:`LockOrderViolation`.  An edge is recorded only when the
  declared order covers it, so a cycle across threads always holds an
  edge one of the two checks rejects first.

The sanitizer's own state lock is a plain ``threading.Lock``, taken with
no sanitized lock's state mid-update; the receipt is written outside it.
Standard library only.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Set, Tuple

#: Environment flag read at lock-CREATION time.
ENV_FLAG = "CST_LOCK_SANITIZER"
#: Where the violation receipt lands.
ENV_RECEIPT = "CST_LOCK_SANITIZER_RECEIPT"
DEFAULT_RECEIPT = "/tmp/cst_locksan_violation.json"

#: Receipt format version.
LOCKSAN_SCHEMA = 1


class LockOrderViolation(AssertionError):
    """An acquisition contradicted the declared order.  Raised after the
    receipt is written, so the evidence outlives the deadlock it
    predicts."""


_state_lock = threading.Lock()
_declared_edges: Set[Tuple[str, str]] = set()
_declared_tables: List[Tuple[str, ...]] = []
_observed_edges: Dict[Tuple[str, str], Dict] = {}
_violations: List[Dict] = []
_tls = threading.local()


def enabled() -> bool:
    """Is the sanitizer armed in this environment right now?"""
    return os.environ.get(ENV_FLAG, "") == "1"


def declare_order(*names: str) -> None:
    """Register one ``LOCK_ORDER`` table (idempotent; modules call it at
    import time beside the table)."""
    table = tuple(str(n) for n in names)
    if len(table) < 2:
        return
    with _state_lock:
        if table not in _declared_tables:
            _declared_tables.append(table)
        for i in range(len(table)):
            for j in range(i + 1, len(table)):
                _declared_edges.add((table[i], table[j]))


def path_exists(edges, src: str, dst: str) -> bool:
    """Transitive reachability over an edge set (breadth-first)."""
    if src == dst:
        return True
    seen = {src}
    frontier = [src]
    while frontier:
        here = frontier.pop()
        for a, b in edges:
            if a == here and b not in seen:
                if b == dst:
                    return True
                seen.add(b)
                frontier.append(b)
    return False


def _held_stack() -> List[str]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def violations() -> List[Dict]:
    """The violation records of this process (each also on disk)."""
    with _state_lock:
        return list(_violations)


def reset_observed() -> None:
    """Clear observed edges and violations; declared tables stay (they
    are import-time facts)."""
    with _state_lock:
        _observed_edges.clear()
        _violations.clear()


def _receipt_path() -> str:
    return os.environ.get(ENV_RECEIPT, DEFAULT_RECEIPT)


def _record_violation(kind: str, held: str, acquiring: str,
                      message: str) -> None:
    """Remember the violation, write the receipt durably, raise."""
    with _state_lock:
        doc = {
            "schema": LOCKSAN_SCHEMA,
            "kind": kind,
            "edge": [held, acquiring],
            "thread": threading.current_thread().name,
            "held_stack": list(_held_stack()),
            "message": message,
            "declared_tables": [list(t) for t in _declared_tables],
            "observed_edges": sorted([list(e) for e in _observed_edges]),
        }
        _violations.append(doc)
    try:
        from ..resilience.integrity import atomic_json_write

        atomic_json_write(_receipt_path(), doc, indent=2)
    except OSError:
        pass  # a full disk must not mask the violation raised below
    raise LockOrderViolation(f"lock-order violation ({kind}): {message}")


def _check_edge(held: str, acquiring: str) -> None:
    """Check one acquisition edge before blocking on the target lock."""
    with _state_lock:
        if path_exists(_declared_edges, acquiring, held):
            kind, msg = "inverted-order", (
                f"acquiring '{acquiring}' while holding '{held}' "
                "inverts the declared LOCK_ORDER "
                f"(declared: {acquiring} before {held})")
        elif not path_exists(_declared_edges, held, acquiring):
            kind, msg = "undeclared-edge", (
                f"acquiring '{acquiring}' while holding '{held}' is not "
                "covered by any declared LOCK_ORDER table; declare the "
                "pair or break the nesting")
        else:
            _observed_edges.setdefault(
                (held, acquiring),
                {"thread": threading.current_thread().name})
            return
    _record_violation(kind, held, acquiring, msg)


class _SanitizedLock:
    """``threading.Lock`` twin that checks every acquisition; the subset
    of the Lock API the port uses.  Assumes the acquiring thread releases
    (every use is a ``with`` block)."""

    __slots__ = ("name", "_lk")

    def __init__(self, name: str):
        self.name = str(name)
        self._lk = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        for held in list(_held_stack()):
            _check_edge(held, self.name)
        got = self._lk.acquire(blocking, timeout)
        if got:
            _held_stack().append(self.name)
        return got

    def release(self) -> None:
        stack = _held_stack()
        # The most recent occurrence: same-thread releases may be
        # out of LIFO order.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.name:
                del stack[i]
                break
        self._lk.release()

    def locked(self) -> bool:
        return self._lk.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<SanitizedLock {self.name!r} at {id(self):#x}>"


def named_lock(name: str):
    """The port's lock factory: a plain ``threading.Lock`` unless the
    sanitizer is armed when the lock is created."""
    if enabled():
        return _SanitizedLock(name)
    return threading.Lock()
