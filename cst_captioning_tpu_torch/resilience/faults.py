"""Deterministic fault-injection plans for drilling the trainer (own copy
of the reference's ``resilience/faults.py``: the same grammar and the
same ``KINDS`` table, so a plan string parses to the same specs in both
packages).

A :class:`FaultPlan` is parsed from ``--fault_plan`` (or the
``CST_FAULT_PLAN`` environment variable) and handed explicitly to the
components that host an injection point.  Every site has the shape::

    if plan is not None and plan.fire("kind", index):
        <raise / corrupt / block>

Grammar (comma-separated specs)::

    kind@step=N        fire once when the trainer dispatches step N (0-based)
    kind@batch=N       fire once when the loader assembles batch N (0-based)
    kind@req=N         fire once for the serving engine's Nth request
    kind@replica=K     fleet serving only: fire once inside replica K
    kind@step=N*K      fire on steps N, N+1, ..., N+K-1

The training kinds the port's loop hosts:

===============  =======  ===================================================
kind             keys on  effect at the injection site
===============  =======  ===================================================
``ckpt_torn``    step     truncate the payload of the just-committed
                          checkpoint AFTER its manifest was written
``nan_grad``     step     replace the step's host-side inputs by NaN so the
                          device computes a non-finite loss and gradient
``wedge``        step     block the train loop for ever (the watchdog turns
                          it into exit 124)
``preempt``      step     deliver a real ``SIGTERM`` to this process when
                          step N is dispatched (the next step boundary
                          saves a verified checkpoint and exits 75)
``loader_err``   batch    raise ``InjectedFault`` (a transient ``OSError``)
                          from batch N's feature read; the prefetch
                          worker retries it with backoff
===============  =======  ===================================================

The serving kinds the port's engine hosts (``serving/engine.py``):

================  =======  ==================================================
kind              keys on  effect at the injection site
================  =======  ==================================================
``serve_wedge``   req      raise ``InjectedFault`` from the dispatch of a
                           chunk while request N is resident
``serve_garble``  req      zero request N's row of a chunk's fetch (the
                           garble signature, ``resilience/garble.py``)
``admit_err``     req      raise ``InjectedFault`` from request N's admission
``serve_cache``   req      raise ``InjectedFault`` from request N's
                           result-cache lookup
================  =======  ==================================================

``kind@replica=K`` on a serving kind targets fleet replica K
(``serving/fleet.py``): the parsed plan never fires it; its
:meth:`FaultPlan.for_replica` derivative hands replica K's engine a
single-shot spec that fires at the first index probed.  The process
kinds act on a process fleet's child processes (``serving/supervisor.py``),
from outside, as real signals:

================  =======  ==================================================
kind              keys on  effect at the injection site
================  =======  ==================================================
``proc_kill``     replica  SIGKILL replica K's serve process mid-work (after
                           a ``dump`` op); its in-flight requests are
                           requeued and it restarts (exit 137, resumable)
``proc_wedge``    replica  SIGSTOP replica K's process; the supervisor's
                           wedge timeout kills it as exit 124
``proc_preempt``  replica  SIGTERM replica K's process: it drains, its queue
                           comes back rejected and is requeued, it exits 75
================  =======  ==================================================

The supervisor fires them through :meth:`FaultPlan.fire_replica`, once per
(kind, replica); :meth:`FaultPlan.cli_for_child` gives child K its slice
of the serving kinds as a ``--fault_plan`` of its own.

Firing is single-shot per (kind, index): a plan replayed after a rollback
or a resume does not fire an index twice.  ``bind_state(path)`` persists
the consumed set as JSONL next to the checkpoints, so a drill that kills
its own process (``wedge``, ``preempt``) does not fire again in the run
that resumes it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

log = logging.getLogger(__name__)

#: kind -> the index axis its specs must use.
KINDS: Dict[str, str] = {
    "ckpt_torn": "step",
    "nan_grad": "step",
    "loader_err": "batch",
    "wedge": "step",
    "preempt": "step",
    "serve_wedge": "req",
    "serve_garble": "req",
    "admit_err": "req",
    "serve_cache": "req",
    "proc_kill": "replica",
    "proc_wedge": "replica",
    "proc_preempt": "replica",
}

#: Serving kinds that may instead target a fleet replica (``@replica=K``).
REPLICA_KINDS = frozenset(k for k, axis in KINDS.items() if axis == "req")

#: Process-level kinds: ``@replica=K`` is their only axis.
PROC_KINDS = frozenset(k for k, axis in KINDS.items() if axis == "replica")

#: ``FaultSpec.at`` of a replica-targeted spec (the reference's value).
ANY_INDEX = -1

_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z_]+)@(?P<axis>step|batch|req|replica)=(?P<at>\d+)"
    r"(\*(?P<times>\d+))?$"
)


class InjectedFault(OSError):
    """Raised by injection sites that simulate a transient I/O failure."""


@dataclass(frozen=True)
class FaultSpec:
    """One armed fault: ``kind`` fires at indices ``at .. at+times-1``;
    ``replica`` is set for ``kind@replica=K`` (inert in the plan that
    parsed it).  ``at == ANY_INDEX`` covers every index, once."""

    kind: str
    at: int
    times: int = 1
    replica: Optional[int] = None

    def covers(self, index: int) -> bool:
        if self.at == ANY_INDEX:
            return True
        return self.at <= index < self.at + self.times

    def __str__(self) -> str:
        if self.replica is not None:
            return f"{self.kind}@replica={self.replica}"
        tail = f"*{self.times}" if self.times != 1 else ""
        at = "any" if self.at == ANY_INDEX else self.at
        return f"{self.kind}@{KINDS[self.kind]}={at}{tail}"


@dataclass
class FaultPlan:
    """Parsed, consumable fault plan; ``fire`` is the runtime API."""

    specs: List[FaultSpec]
    _consumed: Set[Tuple[str, int]] = field(default_factory=set)
    _state_path: Optional[str] = None
    _metrics: Optional[object] = field(default=None, repr=False)
    # Prefetch workers fire ``loader_err`` from their own threads.
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)
    # Memoized ``for_replica`` derivatives, by replica.
    _derived: Dict[int, Optional["FaultPlan"]] = field(
        default_factory=dict, repr=False, compare=False)

    def bind_metrics(self, registry) -> "FaultPlan":
        """Count firings into a ``telemetry.registry.MetricsRegistry``
        (``fault_firings`` and ``fault_<kind>``, declared at 0 for every
        armed kind)."""
        self._metrics = registry
        registry.declare("fault_firings",
                         *(f"fault_{s.kind}" for s in self.specs))
        return self

    def bind_state(self, path: str) -> "FaultPlan":
        """Persist consumed firings to ``path`` (JSONL, append-only) and
        load the firings of earlier processes from it.  Best-effort IO:
        the drill's bookkeeping never kills the run it drills."""
        self._state_path = path
        try:
            with open(path) as f:
                for line in f:
                    kind, ix = json.loads(line)
                    self._consumed.add((kind, int(ix)))
        except (OSError, ValueError):
            pass
        return self

    @classmethod
    def parse(cls, text: Optional[str]) -> Optional["FaultPlan"]:
        """``None`` or empty -> ``None`` (disarmed); bad grammar ->
        ValueError naming the offending spec."""
        if not text or not text.strip():
            return None
        specs = []
        for raw in text.split(","):
            raw = raw.strip()
            if not raw:
                continue
            m = _SPEC_RE.match(raw)
            if m is None:
                raise ValueError(
                    f"bad fault spec {raw!r}; expected kind@step=N, "
                    f"kind@batch=N, kind@req=N, or kind@step=N*K with "
                    f"kind in {sorted(KINDS)}")
            kind, axis = m.group("kind"), m.group("axis")
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; registered: {sorted(KINDS)}")
            if axis == "replica":
                if kind not in REPLICA_KINDS and kind not in PROC_KINDS:
                    raise ValueError(
                        f"fault {kind!r} cannot target a fleet replica; "
                        f"@replica=K is valid for "
                        f"{sorted(REPLICA_KINDS | PROC_KINDS)}")
                if m.group("times"):
                    raise ValueError(
                        f"bad fault spec {raw!r}: @replica=K takes no "
                        "*K repeat (one firing per targeted replica)")
                specs.append(FaultSpec(kind, ANY_INDEX,
                                       replica=int(m.group("at"))))
                continue
            if KINDS[kind] != axis:
                raise ValueError(
                    f"fault {kind!r} keys on {KINDS[kind]!r}, not {axis!r}")
            specs.append(FaultSpec(kind, int(m.group("at")),
                                   int(m.group("times") or 1)))
        return cls(specs=specs) if specs else None

    def for_replica(self, replica: int) -> Optional["FaultPlan"]:
        """The plan replica ``replica``'s engine gets: every serving
        ``kind@replica=K`` spec targeting it, as a single-shot spec that
        fires at the engine's first probe of that kind.  Specs on other
        axes are not forwarded (in a fleet the ``@req`` ordinal is per
        engine, so ambiguous).  None when nothing targets the replica.
        The metrics binding is inherited.  Memoized per replica: a
        restarted replica's fresh engine gets the same derived plan, so a
        replica-targeted fault does not fire again after the restart it
        caused.  ``proc_*`` kinds are not materialized (no engine site)."""
        k = int(replica)
        if k in self._derived:
            return self._derived[k]
        specs = [FaultSpec(s.kind, ANY_INDEX) for s in self.specs
                 if s.replica == k and s.kind not in PROC_KINDS]
        derived: Optional[FaultPlan] = None
        if specs:
            derived = FaultPlan(specs=specs)
            derived._metrics = self._metrics
        self._derived[k] = derived
        return derived

    def _consume(self, kind: str, key: Tuple[str, int]) -> None:
        self._consumed.add(key)
        if self._state_path is not None:
            # Recorded BEFORE the fault acts: a wedge kills the process,
            # and the run that resumes it must see the firing spent.
            try:
                with open(self._state_path, "a") as f:
                    f.write(json.dumps([kind, key[1]]) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:
                pass
        if self._metrics is not None:
            self._metrics.inc("fault_firings")
            self._metrics.inc(f"fault_{kind}")

    def fire(self, kind: str, index: int) -> bool:
        """True exactly once per (kind, index) a spec covers; replica-
        targeted specs never fire here (only from a ``for_replica``
        derivative, where they cover any index and consume the
        ``ANY_INDEX`` key)."""
        for spec in self.specs:
            if spec.kind == kind and spec.replica is None \
                    and spec.covers(index):
                key = (kind, ANY_INDEX if spec.at == ANY_INDEX
                       else int(index))
                with self._lock:
                    if key in self._consumed:
                        return False
                    self._consume(kind, key)
                log.warning("FAULT INJECTED: %s fired at %s=%d (spec %s)",
                            kind, KINDS[kind], index, spec)
                return True
        return False

    def fire_replica(self, kind: str, replica: int) -> bool:
        """True exactly once per (``proc_*`` kind, replica): the process
        fleet's firing API.  The supervisor delivers these as signals to
        replica ``replica``'s process, so they never pass an engine's
        ``fire``.  A restarted replica does not fire its own kill again."""
        if KINDS.get(kind) != "replica":
            raise ValueError(
                f"fire_replica is for process-level kinds "
                f"{sorted(PROC_KINDS)}, not {kind!r}")
        k = int(replica)
        for spec in self.specs:
            if spec.kind == kind and spec.replica == k:
                key = (kind, k)
                with self._lock:
                    if key in self._consumed:
                        return False
                    self._consume(kind, key)
                log.warning("FAULT INJECTED: %s fired at replica=%d "
                            "(spec %s)", kind, k, spec)
                return True
        return False

    def cli_for_child(self, replica: int) -> Optional[str]:
        """The ``--fault_plan`` a process fleet passes to replica
        ``replica``'s serve child: every serving ``kind@replica=K`` spec
        targeting it becomes ``kind@req=0``, the child's first request
        (a fresh child's first chance at the kind).  ``proc_*`` kinds are
        not forwarded: the supervisor delivers them.  None when nothing
        serving-level targets the replica."""
        k = int(replica)
        specs = [f"{s.kind}@req=0" for s in self.specs
                 if s.replica == k and s.kind in REPLICA_KINDS]
        return ",".join(specs) or None

    def pending(self, kind: str) -> int:
        """Indices of ``kind`` armed but not yet consumed; a ``proc_*``
        spec counts its (kind, replica) key."""
        n = 0
        for spec in self.specs:
            if spec.kind != kind:
                continue
            if spec.kind in PROC_KINDS and spec.replica is not None:
                n += int((kind, spec.replica) not in self._consumed)
            elif spec.replica is None:
                n += sum(1 for i in range(spec.at, spec.at + spec.times)
                         if (kind, i) not in self._consumed)
        return n

    def __str__(self) -> str:
        return ",".join(str(s) for s in self.specs)


def fault_plan_arg(text: str) -> str:
    """argparse type of ``--fault_plan``: a malformed plan is a usage
    error (exit 2) naming the bad spec, not a start-up traceback."""
    try:
        FaultPlan.parse(text)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    return text
