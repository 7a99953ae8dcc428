"""Fleet-wide observability plane of the process fleet (own copy of the
reference's ``telemetry/fleetobs.py``: the same files, rows and alert
records, so the reference's ``scripts/fleet_report.py`` and
``fleet_trace.py`` read the port's run directories).

The process fleet makes the OS process the failure domain; this module
lifts the per-process evidence (spans, the request lifecycle) to the
fleet, in three layers driven from the supervisor's single-owner tick
loop:

- **Clock sync for trace stitching** (:class:`ClockSync`).  The
  supervisor timestamps a ``{"op": "ping"}`` to each live child; the
  echo carries the child's wall clock.  ``offset = child_wall -
  (wall_send + rtt/2)`` is a midpoint estimate whose uncertainty is
  bounded by ``rtt/2``; the best (min-RTT) sample per child *process*
  (keyed by pid, so a restart's fresh process is re-measured from
  scratch) lands in ``clock_sync.json`` — the skew table
  ``fleet_trace.py`` uses to rebase every child trace onto the
  supervisor's timeline and merge one Perfetto file with per-child
  process rows.

- **Continuous aggregation** (:class:`FleetObs` scraper).  On the
  ``--fleet_scrape_ms`` cadence the supervisor's snapshot of every
  replica (live OR restarting OR dead — one row per replica per sample,
  so the series has zero gaps across a child restart) is appended to a
  bounded in-memory ring and to the append-only ``fleet_metrics.jsonl``
  (schema-stamped lines; fsync'd periodically; rotation goes through
  ``os.replace`` + an ``atomic_json_write`` part index, so a crash can
  tear at most the final line of the active part).  Each sample carries
  fleet-wide and per-child p50/p99 latency, queue depth, slot
  occupancy, cache hit rate and attribution-component p99s — the feed
  the autoscaler (``serving/autoscale.py``) consumes.  Stats queries and clock pings are
  paced per child through :class:`serving.policy.QueryPacer`, the SAME
  policy object family the supervisor's health poll uses.

- **SLO burn-rate monitor** (:class:`SLOMonitor`).  Declared
  objectives (p99 latency, availability, error rate) are evaluated
  over sliding fast/slow windows; an objective fires when BOTH windows
  burn the error budget faster than the threshold (the classic
  multi-window guard against one-bad-second pages).  Alerts are typed
  ``slo_alert`` lifecycle events, flip the fleet health worst-of to
  ``degraded`` while firing, append to ``slo_alerts.jsonl``, ride the
  blackbox out on exit, and gate ``serve_report``/``fleet_report``
  with exit 1.

Pure host code — importable by a supervisor process that never touches
the card (it imports no torch).  All time arithmetic goes through injected ``clock``
(monotonic, the supervisor's scheduling clock) and ``wall`` callables,
so tests drive the whole plane with fake clocks and the skew math never
touches ``time.time()`` literals on a deadline path.

Threading: everything here runs on the supervisor's tick thread except
:meth:`FleetObs.series`, which a report/debug caller may invoke from
another thread — hence the ring's named lock.  The ring lock is a near-
leaf: nothing is emitted or counted while holding it (LOCK_ORDER below
permits the registry leaf, and nothing else).
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..utils.locksan import declare_order, named_lock

#: fleet_metrics.jsonl line format version (every line is stamped).
FLEET_METRICS_SCHEMA = 1

#: clock_sync.json format version.
CLOCK_SYNC_SCHEMA = 1

#: Registry counters this plane owns (declared at 0 when a registry is
#: attached; the table is test-pinned in OBSERVABILITY.md "Fleet
#: plane").
FLEETOBS_COUNTERS = (
    "fleet_samples",           # scrape sample rows appended
    "fleet_child_rows",        # per-child rows across all samples
    "fleet_stats_queries",     # {"op": "stats"} scrape queries sent
    "fleet_pings",             # clock-sync pings sent
    "fleet_ping_echoes",       # echoes folded into offset estimates
    "fleet_metric_rotations",  # fleet_metrics.jsonl part rotations
    "slo_alerts_fired",        # objective transitions into firing
    "slo_alerts_cleared",      # objective transitions back to ok
)

#: Declared acquisition order (for the lock sanitizer):
#: the scraper ring lock may in principle be held into the registry
#: leaf; in practice nothing counts under the ring lock — the order is
#: declared so an accidental nesting fails loudly in the right
#: direction instead of deadlocking quietly in the wrong one.
LOCK_ORDER = ("telemetry.fleetobs.ring", "telemetry.registry")
declare_order(*LOCK_ORDER)

#: SLO objective names, in render order.
SLO_OBJECTIVES = ("p99", "availability", "error_rate")


class ClockSync:
    """Midpoint clock-offset estimation over the ping echo.

    One estimate per child *process* (keyed by the pid the echo
    carries): a restarted replica is a new process with a new clock, so
    it is re-measured from scratch — a restarted replica never
    inherits a dead process's skew.  ``wall`` is the supervisor's wall
    clock callable (injectable for tests).
    """

    #: Pending pings are bounded: a child that never echoes must not
    #: grow supervisor memory.
    MAX_PENDING = 256

    def __init__(self, wall: Callable[[], float] = time.time):
        self.wall = wall
        self._pending: Dict[tuple, tuple] = {}  # (index, seq) -> (t0, wall_send)
        self._best: Dict[int, Dict[str, Any]] = {}  # pid -> best sample
        self._seq = 0

    def ping_payload(self, index: int, t0: float) -> Dict[str, Any]:
        """Build the wire ping for replica ``index`` sent at monotonic
        ``t0`` (the supervisor's clock), recording the matching wall
        read for the midpoint estimate."""
        self._seq += 1
        while len(self._pending) >= self.MAX_PENDING:
            self._pending.pop(next(iter(self._pending)))
        self._pending[(int(index), self._seq)] = (float(t0), self.wall())
        return {"op": "ping", "seq": self._seq, "t0": float(t0)}

    def on_echo(self, index: int, obj: Dict[str, Any],
                t1: float) -> Optional[Dict[str, Any]]:
        """Fold one echo received at monotonic ``t1`` into the per-pid
        estimate; returns the sample (or None for an unmatched echo)."""
        key = (int(index), int(obj.get("seq", -1)))
        rec = self._pending.pop(key, None)
        if rec is None:
            return None
        t0, wall_send = rec
        rtt = max(float(t1) - t0, 0.0)
        mid_wall = wall_send + rtt / 2.0
        child_wall = float(obj.get("wall", mid_wall))
        pid = int(obj.get("pid", -1))
        sample = {
            "index": int(index),
            "pid": pid,
            "skew_s": child_wall - mid_wall,
            "uncertainty_s": rtt / 2.0,
            "rtt_s": rtt,
            "samples": 1,
        }
        best = self._best.get(pid)
        if best is None or rtt < best["rtt_s"]:
            sample["samples"] = 1 if best is None else best["samples"] + 1
            self._best[pid] = sample
        else:
            best["samples"] += 1
        return sample

    def drop_pending(self, index: int) -> None:
        """Forget in-flight pings to replica ``index`` — called when
        its process is replaced (the echo would cross generations)."""
        idx = int(index)
        for key in [k for k in self._pending if k[0] == idx]:
            self._pending.pop(key, None)

    def skew_for_pid(self, pid: int) -> Optional[Dict[str, Any]]:
        return self._best.get(int(pid))

    def doc(self) -> Dict[str, Any]:
        """The ``clock_sync.json`` document fleet_trace.py consumes."""
        return {
            "schema": CLOCK_SYNC_SCHEMA,
            "supervisor_pid": os.getpid(),
            "written_wall_s": self.wall(),
            "children": {str(pid): dict(rec)
                         for pid, rec in sorted(self._best.items())},
        }


class SLOMonitor:
    """Sliding-window burn-rate evaluation of declared objectives.

    Objectives (any may be 0 = disabled):

    - ``p99_ms``: target p99 latency.  Error budget: 1% of requests may
      exceed it.  Burn = (fraction over target) / 0.01.
    - ``availability``: target success fraction (e.g. 0.99).  Budget =
      1 - target; burn = (error fraction) / budget.
    - ``error_rate``: max tolerated error fraction.  Burn = (error
      fraction) / target.

    An objective **fires** when both the fast and the slow window burn
    at >= ``burn_threshold`` with at least ``min_requests`` in the fast
    window; it **clears** when the fast window drops back under the
    threshold.  Transitions emit ``slo_alert`` lifecycle events (id is
    ``slo:<objective>`` — an event chain with no ``received``, which
    the accounting audit counts as truncated, never as a terminal
    violation) and are retained in :attr:`alerts` for the alert log and
    the blackbox.
    """

    def __init__(self, *, p99_ms: float = 0.0, availability: float = 0.0,
                 error_rate: float = 0.0, fast_window_s: float = 60.0,
                 slow_window_s: float = 600.0, burn_threshold: float = 2.0,
                 min_requests: int = 12,
                 clock: Callable[[], float] = time.monotonic,
                 lifecycle=None, registry=None, max_outcomes: int = 65536):
        self.p99_ms = max(float(p99_ms), 0.0)
        self.availability = float(availability)
        self.error_rate = float(error_rate)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = max(float(slow_window_s), self.fast_window_s)
        self.burn_threshold = float(burn_threshold)
        self.min_requests = int(min_requests)
        self.clock = clock
        self._lifecycle = lifecycle
        self._registry = registry
        # (ts, ok, latency_ms) outcomes; trimmed to the slow window on
        # observe/evaluate, hard-bounded so a burst cannot grow memory.
        self._outcomes: deque = deque(maxlen=int(max_outcomes))
        self._firing: Dict[str, bool] = {}
        self._last_status: Dict[str, Any] = {"enabled": self.enabled,
                                             "firing": []}
        self.alerts: List[Dict[str, Any]] = []
        self.alerts_fired = 0
        self.alerts_cleared = 0

    @property
    def enabled(self) -> bool:
        return bool(self.p99_ms > 0 or self.availability > 0
                    or self.error_rate > 0)

    @property
    def alerting(self) -> bool:
        """True while any objective is firing — the fleet-health
        degraded flip reads this (a plain bool: no lock nesting)."""
        return any(self._firing.values())

    def observe(self, ok: bool, latency_ms: Optional[float],
                now: Optional[float] = None) -> None:
        """Record one request outcome (terminal answer at the
        supervisor: completed => ok, shed/expired/errored => not ok)."""
        if not self.enabled:
            return
        t = float(self.clock() if now is None else now)
        self._outcomes.append(
            (t, bool(ok),
             None if latency_ms is None else float(latency_ms)))
        self._trim(t)

    def _trim(self, now: float) -> None:
        horizon = now - self.slow_window_s
        while self._outcomes and self._outcomes[0][0] < horizon:
            self._outcomes.popleft()

    def _window(self, window_s: float, now: float) -> Dict[str, float]:
        lo = now - window_s
        n = errs = over = 0
        for ts, ok, lat in self._outcomes:
            if ts < lo:
                continue
            n += 1
            if not ok:
                errs += 1
            if self.p99_ms > 0 and lat is not None and lat > self.p99_ms:
                over += 1
        return {"n": n,
                "err_frac": (errs / n) if n else 0.0,
                "over_frac": (over / n) if n else 0.0}

    def _burn(self, objective: str, win: Dict[str, float]) -> float:
        if objective == "p99":
            return win["over_frac"] / 0.01 if self.p99_ms > 0 else 0.0
        if objective == "availability":
            budget = 1.0 - self.availability
            return (win["err_frac"] / budget
                    if 0.0 < self.availability < 1.0 else 0.0)
        budget = self.error_rate
        return win["err_frac"] / budget if budget > 0 else 0.0

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Recompute burns, run the firing state machine, return (and
        retain) the status doc the scrape rows and reports embed."""
        t = float(self.clock() if now is None else now)
        if not self.enabled:
            self._last_status = {"enabled": False, "firing": []}
            return self._last_status
        self._trim(t)
        fast = self._window(self.fast_window_s, t)
        slow = self._window(self.slow_window_s, t)
        objectives: Dict[str, Any] = {}
        for name in SLO_OBJECTIVES:
            target = {"p99": self.p99_ms, "availability": self.availability,
                      "error_rate": self.error_rate}[name]
            if not target:
                continue
            fast_burn = self._burn(name, fast)
            slow_burn = self._burn(name, slow)
            was = self._firing.get(name, False)
            if (not was and fast["n"] >= self.min_requests
                    and fast_burn >= self.burn_threshold
                    and slow_burn >= self.burn_threshold):
                self._transition(name, "firing", fast_burn, slow_burn,
                                 target, t)
            elif was and fast_burn < self.burn_threshold:
                self._transition(name, "cleared", fast_burn, slow_burn,
                                 target, t)
            objectives[name] = {
                "target": target,
                "fast_burn": round(fast_burn, 4),
                "slow_burn": round(slow_burn, 4),
                "firing": self._firing.get(name, False),
            }
        self._last_status = {
            "enabled": True,
            "burn_threshold": self.burn_threshold,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "window_n": fast["n"],
            "objectives": objectives,
            "firing": sorted(k for k, v in self._firing.items() if v),
            "alerts_fired": self.alerts_fired,
            "alerts_cleared": self.alerts_cleared,
        }
        return self._last_status

    def _transition(self, name: str, state: str, fast_burn: float,
                    slow_burn: float, target: float, t: float) -> None:
        firing = state == "firing"
        self._firing[name] = firing
        if firing:
            self.alerts_fired += 1
        else:
            self.alerts_cleared += 1
        alert = {"kind": "slo_alert", "objective": name, "state": state,
                 "target": target, "fast_burn": round(fast_burn, 4),
                 "slow_burn": round(slow_burn, 4), "t": t}
        self.alerts.append(alert)
        if self._registry is not None:
            self._registry.inc("slo_alerts_fired" if firing
                               else "slo_alerts_cleared")
        if self._lifecycle is not None:
            self._lifecycle.emit(
                "slo_alert", f"slo:{name}", ts=t, objective=name,
                state=state, target=target,
                fast_burn=round(fast_burn, 4),
                slow_burn=round(slow_burn, 4))

    def status(self) -> Dict[str, Any]:
        """The last evaluated status (blackbox provider)."""
        return dict(self._last_status)


class FleetObs:
    """The supervisor-side plane: scraper + clock sync + SLO monitor.

    Held by the supervisor as an optional collaborator (``None`` when
    unarmed — the house disabled-path rule: one is-None check per
    hook).  The supervisor calls, all from its tick thread:

    - :meth:`tick` once per supervisor tick (pings + scrape + SLO
      evaluation);
    - :meth:`on_ping` when a ping echo arrives on the wire;
    - :meth:`on_stats` when a stats reply arrives (marks the pacer ok);
    - :meth:`observe_request` at every terminal answer;
    - :meth:`on_child_assigned` when a replica gets a fresh process;
    - :meth:`close` on shutdown (final fsync + clock_sync.json).

    ``sup`` in :meth:`tick` is duck-typed: anything with
    ``scrape_snapshot()``, ``query_child(index, payload) -> bool`` and
    ``clock`` works — tests drive the plane with a stub.
    """

    def __init__(self, out_dir: str, *, scrape_interval_s: float = 1.0,
                 slo: Optional[SLOMonitor] = None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 registry=None, lifecycle=None, ring_len: int = 512,
                 rotate_rows: int = 100_000, fsync_every: int = 64):
        from ..serving.policy import QueryPacer

        self.out_dir = os.path.abspath(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.metrics_path = os.path.join(self.out_dir, "fleet_metrics.jsonl")
        self.alerts_path = os.path.join(self.out_dir, "slo_alerts.jsonl")
        self.sync_path = os.path.join(self.out_dir, "clock_sync.json")
        self.scrape_interval_s = max(float(scrape_interval_s), 1e-6)
        self.slo = slo
        self.clock = clock
        self.wall = wall
        self._registry = registry
        self._lifecycle = lifecycle
        # One pacing policy family for everything timed: stats scrapes and clock pings each get a pacer on
        # the scrape cadence; the supervisor's health poll holds its own
        # QueryPacer on the health cadence.
        self.stats_pacer = QueryPacer(self.scrape_interval_s)
        self.ping_pacer = QueryPacer(self.scrape_interval_s)
        self.clock_sync = ClockSync(wall)
        self._ring_lock = named_lock("telemetry.fleetobs.ring")
        self._ring: deque = deque(maxlen=max(int(ring_len), 8))  # cstlint-torch: guarded_by=self._ring_lock
        # Scrape/file state below is tick-thread-only (the supervisor
        # loop is the single owner; reports read files, not handles).
        self._seq = 0  # cstlint-torch: owned_by=supervisor_tick
        self._rows_in_part = 0  # cstlint-torch: owned_by=supervisor_tick
        self._part = 0  # cstlint-torch: owned_by=supervisor_tick
        self._fh = None  # cstlint-torch: owned_by=supervisor_tick
        self._alerts_written = 0  # cstlint-torch: owned_by=supervisor_tick
        self._sync_dirty = False  # cstlint-torch: owned_by=supervisor_tick
        self._closed = False  # cstlint-torch: owned_by=supervisor_tick
        self.rotate_rows = max(int(rotate_rows), 16)
        self.fsync_every = max(int(fsync_every), 1)
        if registry is not None:
            registry.declare(*FLEETOBS_COUNTERS)
        if lifecycle is not None and slo is not None:
            lifecycle.attach(fleet_slo=slo.status)

    # -- supervisor hooks ---------------------------------------------------

    def tick(self, sup, now: float) -> None:
        """One observability turn: ping due children, scrape on the
        cadence, evaluate SLOs, drain alerts."""
        if self._closed:
            return
        snap = sup.scrape_snapshot()
        for child in snap["children"]:
            idx = child["index"]
            if not child["live"]:
                continue
            if self.ping_pacer.due(idx, now):
                payload = self.clock_sync.ping_payload(idx, t0=sup.clock())
                self.ping_pacer.sent(idx, now)
                if sup.query_child(idx, payload):
                    if self._registry is not None:
                        self._registry.inc("fleet_pings")
                else:
                    self.ping_pacer.failed(idx)
        if self.stats_pacer.due("#scrape", now):
            self.stats_pacer.sent("#scrape", now)
            if self.slo is not None:
                self.slo.evaluate(now)
            self._sample(snap, now)
            for child in snap["children"]:
                idx = child["index"]
                if not child["live"]:
                    continue
                if self.stats_pacer.due(idx, now):
                    self.stats_pacer.sent(idx, now)
                    if sup.query_child(idx, {"op": "stats"}):
                        if self._registry is not None:
                            self._registry.inc("fleet_stats_queries")
                    else:
                        self.stats_pacer.failed(idx)
            self._drain_alerts()
            if self._sync_dirty:
                self._write_clock_sync()

    def on_ping(self, index: int, obj: Dict[str, Any], t1: float) -> None:
        sample = self.clock_sync.on_echo(index, obj, t1)
        if sample is not None:
            self.ping_pacer.ok(index)
            self._sync_dirty = True
            if self._registry is not None:
                self._registry.inc("fleet_ping_echoes")

    def on_stats(self, index: int) -> None:
        self.stats_pacer.ok(index)

    def observe_request(self, ok: bool, latency_ms: Optional[float],
                        now: Optional[float] = None) -> None:
        if self.slo is not None:
            self.slo.observe(ok, latency_ms, now)

    def on_child_assigned(self, index: int) -> None:
        """A replica got a fresh OS process: its clocks, pacing history
        and in-flight pings belong to the dead one — reset, so the new
        process is pinged and scraped immediately (zero-gap contract)."""
        self.ping_pacer.forget(index)
        self.stats_pacer.forget(index)
        self.clock_sync.drop_pending(index)

    @property
    def alerting(self) -> bool:
        return self.slo is not None and self.slo.alerting

    def slo_status(self) -> Dict[str, Any]:
        return self.slo.status() if self.slo is not None else {
            "enabled": False, "firing": []}

    # -- sampling -----------------------------------------------------------

    def _sample(self, snap: Dict[str, Any], now: float) -> None:
        self._seq += 1
        children = [self._child_row(c) for c in snap["children"]]
        row = {
            "schema": FLEET_METRICS_SCHEMA,
            "kind": "fleet_sample",
            "seq": self._seq,
            "t": float(now),
            "wall": self.wall(),
            "interval_ms": self.scrape_interval_s * 1e3,
            "fleet": snap.get("fleet", {}),
            "children": children,
            "slo": self.slo_status(),
        }
        with self._ring_lock:
            self._ring.append(row)
        self._append_row(row)
        if self._registry is not None:
            self._registry.inc("fleet_samples")
            self._registry.inc("fleet_child_rows", len(children))

    @staticmethod
    def _child_row(child: Dict[str, Any]) -> Dict[str, Any]:
        """Shape one replica's scrape row from the supervisor snapshot
        (tolerant of missing stats — a child that has not answered yet
        still gets a row; the zero-gap contract is per replica, not per
        answer)."""
        st = child.get("stats") or {}
        row = {
            "index": child["index"],
            "state": child.get("state"),
            "live": bool(child.get("live")),
            "restarts": child.get("restarts", 0),
            "inflight": child.get("inflight", 0),
            "retiring": bool(child.get("retiring")),
            "queue_depth": st.get("queue_depth"),
            "latency_p50_ms": st.get("latency_p50_ms"),
            "latency_p99_ms": st.get("latency_p99_ms"),
            "compiles": st.get("compiles"),
        }
        slots = st.get("slots")
        residents = st.get("residents")
        if isinstance(slots, (int, float)) and slots:
            row["slot_occupancy"] = round(float(residents or 0)
                                          / float(slots), 4)
        hits = st.get("cache_hits")
        misses = st.get("cache_misses")
        if isinstance(hits, (int, float)) and isinstance(misses,
                                                         (int, float)):
            total = float(hits) + float(misses)
            row["cache_hit_rate"] = (round(float(hits) / total, 4)
                                     if total else None)
        attrib = st.get("attribution")
        if isinstance(attrib, dict):
            comps = attrib.get("components")
            if isinstance(comps, dict):
                row["attribution_p99_ms"] = {
                    c: v.get("p99_ms") for c, v in comps.items()
                    if isinstance(v, dict)}
        return row

    # -- durable output -----------------------------------------------------

    def _append_row(self, row: Dict[str, Any]) -> None:
        # Append-only JSONL: a crash tears at most the final line of
        # the active part; whole-file atomicity is reserved for the
        # rotation index and clock_sync.json (atomic_json_write).
        if self._fh is None:
            self._fh = open(self.metrics_path, "a", encoding="utf-8")
        self._fh.write(json.dumps(row, default=str) + "\n")
        self._fh.flush()
        self._rows_in_part += 1
        if self._rows_in_part % self.fsync_every == 0:
            os.fsync(self._fh.fileno())
        if self._rows_in_part >= self.rotate_rows:
            self._rotate()

    def _rotate(self) -> None:
        from ..resilience.integrity import atomic_json_write, durable_rename

        if self._fh is not None:
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None
        part_path = os.path.join(
            self.out_dir, f"fleet_metrics_part{self._part}.jsonl")
        # durable_rename, not bare os.replace: the advisor-flagged
        # straggler — a crash between the rename and the index write
        # could journal the part's directory entry away.
        durable_rename(self.metrics_path, part_path)
        self._part += 1
        self._rows_in_part = 0
        atomic_json_write(
            os.path.join(self.out_dir, "fleet_metrics_index.json"),
            {"schema": FLEET_METRICS_SCHEMA,
             "parts": [f"fleet_metrics_part{k}.jsonl"
                       for k in range(self._part)],
             "active": os.path.basename(self.metrics_path)},
            indent=2)
        if self._registry is not None:
            self._registry.inc("fleet_metric_rotations")

    def _drain_alerts(self) -> None:
        if self.slo is None:
            return
        fresh = self.slo.alerts[self._alerts_written:]
        if not fresh:
            return
        with open(self.alerts_path, "a", encoding="utf-8") as f:
            for alert in fresh:
                f.write(json.dumps({**alert, "wall": self.wall()}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._alerts_written = len(self.slo.alerts)

    def _write_clock_sync(self) -> None:
        from ..resilience.integrity import atomic_json_write

        atomic_json_write(self.sync_path, self.clock_sync.doc(), indent=2)
        self._sync_dirty = False

    # -- views / shutdown ---------------------------------------------------

    def series(self) -> List[Dict[str, Any]]:
        """Snapshot of the in-memory sample ring (oldest first) — the
        autoscaler-facing view; reports read the JSONL instead."""
        with self._ring_lock:
            return [dict(r) for r in self._ring]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._drain_alerts()
        if self._sync_dirty or self.clock_sync._best:
            self._write_clock_sync()
        if self._fh is not None:
            try:
                os.fsync(self._fh.fileno())
            except OSError:
                pass
            self._fh.close()
            self._fh = None
