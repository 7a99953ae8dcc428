"""Request-lifecycle tracing and the flight recorder (own copy of the
reference's ``telemetry/lifecycle.py``: the same event kinds, attribution
and blackbox format).

- **Per-request causal traces.**  Every request carries its id through
  typed events: ``received``, ``queued``, ``routed`` (fleet placement),
  ``cache_hit``, ``admitted``, ``decode_chunk``, ``retry`` / ``rebuild``
  (the recovery ladder, per affected resident), ``killed`` / ``requeued``
  (a fleet replica dying with the request aboard), ``dropped``, ``shed``,
  ``completed``, ``responded``.  Each is stamped from the clock the
  engine schedules by, so the stream reconciles with the engine's own
  latency bookkeeping.  With a ``SpanTracer`` attached, events are
  mirrored as Chrome async events: one Perfetto track per request.
- **Latency attribution.**  :func:`attribute_request` replays one
  request's events and splits its latency into ``queue_wait`` /
  ``admit`` / ``decode`` / ``recovery`` / ``requeue``, which sum to the
  total by construction; :meth:`LifecycleTracer.attribution_report`
  aggregates them into p50/p99, fleet-wide and per completing replica,
  and reconciles each request against its measured latency.
- **Flight recorder.**  Events land in a bounded ring (fixed host
  memory).  :meth:`LifecycleTracer.dump` writes ``blackbox.json``
  through ``atomic_json_write``: the last N events, the attached state
  providers and the accounting verdict.  The front ends dump it on exit
  124, on an aborted drain and on the ``{"op": "dump"}`` wire op.

Disabled, call sites hold ``None`` and pay one is-None check per hook.
Events are host dicts about host decisions; nothing here touches the
device.  Emits come from the scheduler thread; the ring takes a small
named lock so an exit-path dump racing a straggler emit reads a
consistent buffer.  The span forward happens outside it.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.locksan import declare_order, named_lock

#: Event kinds the tracer accepts (the reference's closed set; an unknown
#: kind is a programming error).
EVENT_KINDS = (
    "received",      # intake: the request entered the serving plane
    "queued",        # it joined an engine's admission queue
    "routed",        # fleet placement decision (attrs: replica)
    "cache_hit",     # exact-result cache completed it at submit time
    "admitted",      # one-encoder-pass admission (attrs: slot, admit_ms)
    "decode_chunk",  # one decode chunk advanced it (attrs: k, slot)
    "retry",         # self-healing chunk re-run while it was resident
    "rebuild",       # engine rebuild re-admitted it (replay prefix kept)
    "killed",        # its replica was killed/restarted with it aboard
    "requeued",      # it re-entered admission after a kill/rotation
    "dropped",       # terminal: expired/deadline_shed/admit_failed
    "shed",          # terminal: backpressure shed (queue or fleet edge)
    "completed",     # terminal: caption harvested (attrs: latency_ms)
    "responded",     # the front end wrote the final wire response
    # Kinds of the process fleet's planes (telemetry/fleetobs.py,
    # serving/autoscale.py, serving/supervisor.py's journal replay):
    # their ids are not requests and their chains have no `received`, so
    # accounting counts them truncated, never as a terminal violation.
    "slo_alert",           # a fleet SLO burn-rate alert fired or cleared
    "autoscale_decision",  # an autoscaler scale or brownout decision
    "replayed",            # an intake-journal replay after a relaunch
)

#: The kinds that END a request's story exactly once.  ``responded`` is
#: a supplementary front-end marker (it FOLLOWS a semantic terminal and
#: may legitimately be absent in engine-only callers like the bench
#: probe), so it is not part of the exactly-once accounting set.
TERMINAL_KINDS = ("completed", "dropped", "shed")

#: Attribution component names, in render order.  Every interval of a
#: request's life is assigned to exactly one, so they sum to the total.
COMPONENTS = ("queue_wait", "admit", "decode", "recovery", "requeue")

#: Flight-recorder file format version.
BLACKBOX_SCHEMA = 1

#: Default ring capacity: ~a few thousand requests' worth of events in
#: fixed host memory (one event is a small dict).
DEFAULT_EVENTS = 4096

#: Declared acquisition order (``utils/locksan.py``): the ring lock may be
#: held into the span tracer's buffer lock; the registry stays a leaf of
#: its own, since emit never counts while it holds the ring.
LOCK_ORDER = ("telemetry.lifecycle", "telemetry.spans")
declare_order(*LOCK_ORDER)


def attribute_request(events: List[Dict[str, Any]]
                      ) -> Optional[Dict[str, float]]:
    """Split one request's lifecycle into latency components (seconds).

    ``events`` are the request's events in timestamp order.  Returns
    ``None`` when the stream has no ``received`` or no terminal event
    (an in-flight or malformed chain — the accounting check reports
    those separately).  The returned dict carries every name in
    :data:`COMPONENTS` plus ``total`` (terminal ts - received ts); the
    components partition the total by construction:

    - intervals before admission accrue to ``queue_wait`` (minus the
      measured ``admit_ms`` carved out as ``admit``);
    - intervals while resident accrue to ``decode``;
    - an interval ending at a ``retry``/``rebuild`` event — a failed
      dispatch the self-healing ladder absorbed — and the re-run that
      follows it accrue to ``recovery``;
    - everything between a ``killed`` (or rotation ``requeued``) event
      and the re-admission accrues to ``requeue`` — the fleet-restart
      cost the kill drill asserts is attributed, not hidden.
    """
    comp = {c: 0.0 for c in COMPONENTS}
    t_start = None
    terminal_ts = None
    prev_ts = None
    state = "queue_wait"
    for ev in events:
        kind = ev["kind"]
        ts = ev["ts"]
        if t_start is None:
            if kind != "received":
                # A chain that starts mid-story (ring rotation ate the
                # head): not attributable.
                return None
            t_start = ts
            prev_ts = ts
            continue
        if terminal_ts is not None:
            break  # ignore post-terminal markers (responded)
        span = max(ts - prev_ts, 0.0)
        # Interval classification: ending-event overrides for the
        # failure kinds, the running state otherwise.
        if kind in ("retry", "rebuild"):
            comp["recovery"] += span
            state = "recovery"
        elif kind == "killed":
            comp[state] += span
            state = "requeue"
        elif kind == "requeued":
            comp["requeue"] += span
            state = "requeue"
        elif kind == "admitted":
            # Event attrs are host floats by construction (emit() owns
            # the one coercion), so no per-event conversions here.
            admit_s = ev.get("admit_ms", 0.0) / 1e3
            admit_s = min(max(admit_s, 0.0), span)
            comp[state] += span - admit_s
            comp["admit"] += admit_s
            state = "decode"
        elif kind == "decode_chunk":
            comp[state] += span
            state = "decode"
        elif kind in TERMINAL_KINDS:
            comp[state] += span
            terminal_ts = ts
        else:  # queued / routed / cache_hit: waiting-side bookkeeping
            comp[state] += span
        prev_ts = ts
    if t_start is None or terminal_ts is None:
        return None
    comp["total"] = terminal_ts - t_start
    return comp


class LifecycleTracer:
    """Bounded per-request event ring + attribution + flight recorder.

    ``clock`` must be the SAME callable the engines schedule by (the
    default ``time.monotonic`` matches the engine default), so event
    timestamps reconcile with the engine's latency bookkeeping;
    deterministic tests inject one fake clock into both.  ``tracer``
    (optional, a :class:`telemetry.spans.SpanTracer`) mirrors every
    event into the Chrome trace as an async-track event.  ``registry``
    (optional) counts ``lifecycle_events`` / ``lifecycle_dumps``
    (declared at 0).
    """

    def __init__(self, max_events: int = DEFAULT_EVENTS,
                 *, clock: Callable[[], float] = time.monotonic,
                 tracer=None, registry=None):
        self.max_events = max(16, int(max_events))
        self.clock = clock
        self._tracer = tracer
        self._registry = registry
        self._lock = named_lock("telemetry.lifecycle")
        self._events: deque = deque(maxlen=self.max_events)  # cstlint-torch: guarded_by=self._lock
        self._emitted = 0                                    # cstlint-torch: guarded_by=self._lock
        self._dumps = 0
        #: State providers the blackbox pulls from at dump time (all
        #: optional; attach whatever this deployment has).
        self._providers: Dict[str, Callable[[], Any]] = {}
        if registry is not None:
            registry.declare("lifecycle_events", "lifecycle_dumps")

    # -- wiring -------------------------------------------------------------

    def attach(self, **providers: Callable[[], Any]) -> "LifecycleTracer":
        """Register blackbox state providers by name — e.g.
        ``attach(counters=registry.snapshot, health=router.health,
        kernels=lambda: {...})``.  Later attaches override."""
        for name, fn in providers.items():
            if fn is None:
                self._providers.pop(name, None)
            else:
                self._providers[name] = fn
        return self

    def for_replica(self, replica: int,
                    intake: bool = False) -> "_ReplicaLifecycle":
        """A labeled view for one fleet replica's engine: every emit
        gains ``replica=k``.  With ``intake=False`` (the fleet default)
        the view drops ``received``/``shed`` — the ROUTER owns intake,
        and a per-candidate engine shed is a routing detail, not a
        terminal answer."""
        return _ReplicaLifecycle(self, int(replica), bool(intake))

    # -- recording ----------------------------------------------------------

    def emit(self, kind: str, request_id: Any,
             ts: Optional[float] = None, **attrs: Any) -> None:
        """Record one lifecycle event.  ``ts`` defaults to ``clock()``;
        the engine passes its own already-read clock values (arrival,
        done_at) so the stream and its bookkeeping share timestamps."""
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown lifecycle event kind {kind!r} "
                             f"(expected one of {EVENT_KINDS})")
        ev: Dict[str, Any] = {
            "ts": float(self.clock() if ts is None else ts),
            "id": request_id, "kind": kind,
        }
        if attrs:
            ev.update(attrs)
        with self._lock:
            self._events.append(ev)
            self._emitted += 1
        if self._registry is not None:
            self._registry.inc("lifecycle_events")
        if self._tracer is not None:
            # Async-track mirror: one Perfetto track per request id —
            # begun at intake, ended at the semantic terminal (Chrome
            # matches b/e on name+cat+id, so those share the constant
            # name "request"), every other event an instant step whose
            # name IS the kind.
            if kind == "received":
                self._tracer.async_event("b", "request", request_id,
                                         kind=kind, **attrs)
            elif kind in TERMINAL_KINDS:
                self._tracer.async_event("e", "request", request_id,
                                         kind=kind, **attrs)
            else:
                self._tracer.async_event("n", kind, request_id, **attrs)

    # -- views --------------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of the retained ring (oldest first)."""
        with self._lock:
            return [dict(ev) for ev in self._events]

    def emitted(self) -> int:
        with self._lock:
            return self._emitted

    def _chains(self) -> List[Tuple[Any, List[Dict[str, Any]]]]:
        """(request_id, events) segments in ts order.  A request id a
        client REUSES (allowed on the wire — each submission is a fresh
        stream) yields one segment per ``received``, so a finished
        request followed by its reused id is two clean stories, never a
        fake multi-terminal."""
        by_id: Dict[Any, List[Dict[str, Any]]] = {}
        for ev in self.events():
            by_id.setdefault(ev["id"], []).append(ev)
        segments: List[Tuple[Any, List[Dict[str, Any]]]] = []
        for rid, evs in by_id.items():
            evs.sort(key=lambda e: e["ts"])
            cur: List[Dict[str, Any]] = []
            for ev in evs:
                if ev["kind"] == "received" and cur:
                    segments.append((rid, cur))
                    cur = []
                cur.append(ev)
            if cur:
                segments.append((rid, cur))
        return segments

    def accounting(self) -> Dict[str, Any]:
        """The exactly-one-terminal audit over the retained ring: every
        request id that entered (``received``) must reach exactly one
        semantic terminal (``completed``/``dropped``/``shed``).  Chains
        whose head rotated out of the ring are excluded (noted in
        ``truncated``) — a bounded recorder can prove the window it
        kept, never the window it dropped."""
        submitted = unterminated = multi = 0
        bad_ids: List[str] = []
        truncated = 0
        for rid, evs in self._chains():
            kinds = [e["kind"] for e in evs]
            if kinds[0] != "received":
                truncated += 1
                continue
            submitted += 1
            n_term = sum(1 for k in kinds if k in TERMINAL_KINDS)
            if n_term == 0:
                unterminated += 1
                bad_ids.append(str(rid))
            elif n_term > 1:
                multi += 1
                bad_ids.append(str(rid))
        return {
            "submitted": submitted,
            "truncated": truncated,
            "unterminated": unterminated,
            "multi_terminal": multi,
            "terminal_ok": unterminated == 0 and multi == 0,
            "bad_ids": bad_ids[:16],
        }

    def attribution_report(self, measured_ms: Optional[Dict[Any, float]]
                           = None, tolerance_ms: float = 50.0,
                           tolerance_frac: float = 0.02) -> Dict[str, Any]:
        """Aggregate per-request attribution into per-component p50/p99
        (overall + per completing replica) and reconcile each request's
        component sum against its measured latency.

        ``measured_ms`` maps request id -> the caller's measured latency
        (e.g. the probe's ``Completion.latency_s * 1e3``); when None,
        the ``latency_ms`` attr the engine stamps on ``completed``
        events is used.  A request reconciles when
        ``|sum(components) - measured| <= tolerance_ms +
        tolerance_frac * measured``.
        """
        per_comp: Dict[str, List[float]] = {c: [] for c in COMPONENTS}
        per_replica: Dict[int, Dict[str, List[float]]] = {}
        residuals: List[float] = []
        bad: List[str] = []
        n = 0
        for rid, evs in self._chains():
            comp = attribute_request(evs)
            if comp is None:
                continue
            n += 1
            for c in COMPONENTS:
                per_comp[c].append(comp[c] * 1e3)
            rep = next((e.get("replica") for e in reversed(evs)
                        if e["kind"] in TERMINAL_KINDS
                        and e.get("replica") is not None), None)
            if rep is not None:
                # replica attrs are host ints by construction
                # (for_replica coerces once at view creation).
                rows = per_replica.setdefault(
                    rep, {c: [] for c in COMPONENTS})
                for c in COMPONENTS:
                    rows[c].append(comp[c] * 1e3)
            # The engine stamps its measured latency on `completed`
            # (a host float by construction); a caller-supplied
            # measurement — documented plain-float ms — fills
            # drop/shed terminals.
            measured = next(
                (e["latency_ms"] for e in evs
                 if e["kind"] == "completed" and "latency_ms" in e),
                None)
            if measured is None and measured_ms is not None:
                measured = measured_ms.get(rid)
            if measured is None:
                continue
            got = sum(comp[c] for c in COMPONENTS) * 1e3
            residual = abs(got - measured)
            residuals.append(residual)
            if residual > tolerance_ms + tolerance_frac * measured:
                bad.append(str(rid))

        def pcts(vals: List[float]) -> Dict[str, Optional[float]]:
            if not vals:
                return {"p50_ms": None, "p99_ms": None, "sum_ms": 0.0}
            s = sorted(vals)

            def pick(q: float) -> float:
                ix = min(len(s) - 1, int(round(q * (len(s) - 1))))
                return round(s[ix], 3)

            return {"p50_ms": pick(0.50), "p99_ms": pick(0.99),
                    "sum_ms": round(sum(s), 3)}

        return {
            "requests": n,
            "components": {c: pcts(v) for c, v in per_comp.items()},
            "per_replica": {
                str(k): {c: pcts(v) for c, v in rows.items()}
                for k, rows in sorted(per_replica.items())},
            "reconciled": len(residuals),
            "reconcile_ok": not bad,
            "reconcile_failures": bad[:16],
            "max_residual_ms": (round(max(residuals), 3)
                                if residuals else None),
            "tolerance_ms": float(tolerance_ms),
            "tolerance_frac": float(tolerance_frac),
        }

    # -- the flight recorder ------------------------------------------------

    def blackbox(self, reason: str = "on_demand") -> Dict[str, Any]:
        """The forensic snapshot: last-N events + attached state + the
        accounting/attribution verdicts.  Pure host memory — safe to
        build while the device transport is dead (that is the point)."""
        events = self.events()          # one consistent locked snapshot
        doc: Dict[str, Any] = {
            "schema": BLACKBOX_SCHEMA,
            "reason": str(reason),
            "wall_time": time.time(),
            "clock_now": float(self.clock()),
            "events_retained": len(events),
            "events_emitted": self.emitted(),
            "max_events": self.max_events,
            "accounting": self.accounting(),
            "attribution": self.attribution_report(),
            "events": [
                {**ev, "id": _json_id(ev["id"])} for ev in events
            ],
        }
        for name, fn in self._providers.items():
            try:
                doc[name] = fn()
            except Exception as e:  # a dead provider must not mute the rest
                doc[name] = {"provider_error": repr(e)}
        return doc

    def dump(self, path: str, reason: str = "on_demand") -> Dict[str, Any]:
        """Write ``blackbox.json`` durably (atomic_json_write) and
        return the doc.  Callers on the exit-124 path write FIRST, then
        exit — the evidence outlives the process."""
        from ..resilience.integrity import atomic_json_write

        doc = self.blackbox(reason)
        atomic_json_write(path, doc, indent=2, default=str)
        self._dumps += 1
        if self._registry is not None:
            self._registry.inc("lifecycle_dumps")
        return doc


class _ReplicaLifecycle:
    """A replica-labeled emit view over one shared tracer (see
    :meth:`LifecycleTracer.for_replica`).  Engines hold this exactly as
    they would the base tracer; attribution/accounting stay fleet-wide
    on the base object."""

    __slots__ = ("_base", "replica", "_intake")

    def __init__(self, base: LifecycleTracer, replica: int, intake: bool):
        self._base = base
        self.replica = replica
        self._intake = intake

    @property
    def clock(self):
        return self._base.clock

    def emit(self, kind: str, request_id: Any,
             ts: Optional[float] = None, **attrs: Any) -> None:
        if not self._intake and kind in ("received", "shed"):
            return  # the router owns intake terminals (module docstring)
        self._base.emit(kind, request_id, ts=ts,
                        replica=self.replica, **attrs)


def _json_id(rid: Any) -> Any:
    """Request ids are caller-opaque (ints, strings, tuples); make them
    JSON-stable for the blackbox without losing distinctness."""
    if isinstance(rid, (str, int, float, bool)) or rid is None:
        return rid
    return repr(rid)
