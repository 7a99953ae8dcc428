"""Attribution-driven autoscaler + overload brownout of the process fleet
(own copy of the reference's ``serving/autoscale.py``: the same signals,
rules, ladder and ``autoscale_decisions.jsonl`` records).

The fleet-observability plane (telemetry/fleetobs.py) was built as "the
autoscaler-facing view"; this module closes the loop.  An
:class:`Autoscaler` rides the supervisor tick right after the scraper
and decides from LATENCY ATTRIBUTION, not from raw latency:

- **scale up** when the per-child ``queue_wait`` p99 burns over the
  ``queue_hi_ms`` threshold in BOTH the fast and the slow sample window
  while the ``decode`` p99 stays flat — requests are waiting for a
  replica, not for the model, so a replica helps;
- **scale down** when ``queue_wait`` p99 sits at/under ``queue_lo_ms``
  for the ENTIRE slow window (hysteresis: ``queue_lo_ms <
  queue_hi_ms``) and no SLO objective is firing — there is provably
  nothing for the extra replica to absorb.

Thrash damping is the SLO monitor's own dual-window discipline plus
per-direction cooldowns and the requirement that the fleet is SETTLED
(no replica starting, backing off, or draining out) before any
decision.  Decisions act through the supervisor: ``sup.add_replica()``
spawns through the existing warm child recipe; ``sup.retire_worst()``
drains the worst-ranked child via ``policy.rank_key`` — in-flight work
finishes, nothing is requeued by the scale-down itself, and a child
that dies mid-drain falls through the supervisor's existing requeue
path.

When the fleet is pinned at ``max_replicas`` and the up-signal keeps
burning, a **brownout ladder** replaces collapse — three rungs, entered
one at a time on sustained burn and exited one at a time on sustained
calm:

1. tighten fleet-edge deadline admission (``deadline_unmeetable`` with
   an inflated service-floor margin);
2. cap the parked-request depth (overflow answered with a typed shed);
3. reject new stream ops at intake.

Each rung's sheds are typed (``why: brownout_*``) and counted, so the
overflow is shed honestly while admitted requests keep bounded p99.

Every decision (scale_up / scale_down / brownout_enter / brownout_exit)
is a typed lifecycle event AND one fsync'd line in the durable
``autoscale_decisions.jsonl`` (the slo_alerts.jsonl appender
discipline) — the evidence trail fleet_report/serve_report gate and
collect_evidence bundles.

Threading: :meth:`tick` and the shed hooks run on the supervisor's
scheduler thread; :meth:`brownout_rung` / :meth:`status` may be read
from a health/heartbeat thread — hence the named state lock.  Nothing
is emitted, counted, or written while holding it (the fleetobs ring-
lock rule).  Pure host code, all time through injected clocks.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..utils.locksan import declare_order, named_lock

#: autoscale_decisions.jsonl line format version (every line stamped).
AUTOSCALE_SCHEMA = 1

#: Registry counters this plane owns (declared at 0; the table is
#: test-pinned in SERVING.md "Autoscaling & brownout").
AUTOSCALE_COUNTERS = (
    "autoscale_ticks",            # scrape samples ingested for decisions
    "autoscale_scale_ups",        # replicas added
    "autoscale_scale_downs",      # replicas retired (drain-based)
    "autoscale_holds_cooldown",   # signal present, per-direction cooldown held
    "autoscale_holds_bounds",     # signal present, min/max bound held
    "brownout_entries",           # ladder rung escalations
    "brownout_exits",             # ladder rung de-escalations
    "brownout_shed_deadline",     # rung-1 sheds (tightened admission)
    "brownout_shed_parked",       # rung-2 sheds (parked-depth cap)
    "brownout_shed_stream",       # rung-3 sheds (stream intake rejected)
)

#: Declared acquisition order (for the lock sanitizer):
#: the autoscaler state lock is a near-leaf read from the health thread;
#: it may in principle reach the registry leaf, never the reverse — in
#: practice nothing counts under it (the fleetobs ring-lock rule).
LOCK_ORDER = ("serving.autoscale.state", "telemetry.registry")
declare_order(*LOCK_ORDER)

#: Brownout ladder rungs, in escalation order (RESILIENCE.md row).
BROWNOUT_RUNGS = ("deadline", "parked", "stream")


class Autoscaler:
    """Grow/shrink the process fleet from the scraped attribution feed.

    ``fleet_obs`` supplies :meth:`~telemetry.fleetobs.FleetObs.series`
    (the sample ring); the supervisor passed to :meth:`tick` is
    duck-typed — anything with ``add_replica() -> int`` and
    ``retire_worst() -> Optional[int]`` works, so tests drive the
    decision engine with stubs.  All thresholds are attribution
    milliseconds; cooldowns are seconds on the supervisor's injected
    monotonic clock (``now`` flows in through :meth:`tick`).
    """

    def __init__(self, fleet_obs, *, min_replicas: int = 1,
                 max_replicas: int = 4, queue_hi_ms: float = 50.0,
                 queue_lo_ms: float = 5.0, fast_samples: int = 3,
                 slow_samples: int = 9, up_cooldown_s: float = 2.0,
                 down_cooldown_s: float = 10.0,
                 decode_flat_factor: float = 2.0,
                 brownout_patience: int = 3,
                 deadline_margin: float = 4.0, parked_cap: int = 8,
                 out_dir: Optional[str] = None,
                 wall: Callable[[], float] = time.time,
                 registry=None, lifecycle=None):
        if int(min_replicas) < 1:
            raise ValueError(
                f"autoscale min must be >= 1, got {min_replicas}")
        if int(max_replicas) < int(min_replicas):
            raise ValueError(
                f"autoscale max ({max_replicas}) must be >= min "
                f"({min_replicas})")
        if float(queue_lo_ms) >= float(queue_hi_ms):
            raise ValueError(
                f"hysteresis needs queue_lo_ms ({queue_lo_ms}) < "
                f"queue_hi_ms ({queue_hi_ms})")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_hi_ms = float(queue_hi_ms)
        self.queue_lo_ms = float(queue_lo_ms)
        self.fast_samples = max(1, int(fast_samples))
        self.slow_samples = max(self.fast_samples, int(slow_samples))
        self.up_cooldown_s = max(0.0, float(up_cooldown_s))
        self.down_cooldown_s = max(0.0, float(down_cooldown_s))
        self.decode_flat_factor = max(1.0, float(decode_flat_factor))
        self.brownout_patience = max(1, int(brownout_patience))
        self.deadline_margin = max(1.0, float(deadline_margin))
        self.parked_cap = max(0, int(parked_cap))
        self.wall = wall
        self._fleet_obs = fleet_obs
        self._registry = registry
        self._lifecycle = lifecycle
        self.decisions_path = (
            os.path.join(os.path.abspath(out_dir),
                         "autoscale_decisions.jsonl")
            if out_dir else None)
        # Decision state below is tick-thread-only...
        self._window: deque = deque(maxlen=self.slow_samples)  # cstlint-torch: owned_by=supervisor_tick
        self._last_seq = 0  # cstlint-torch: owned_by=supervisor_tick
        self._last_up_t: Optional[float] = None  # cstlint-torch: owned_by=supervisor_tick
        self._last_down_t: Optional[float] = None  # cstlint-torch: owned_by=supervisor_tick
        self._sat_ticks = 0  # cstlint-torch: owned_by=supervisor_tick
        self._calm_ticks = 0  # cstlint-torch: owned_by=supervisor_tick
        self._seq = 0  # cstlint-torch: owned_by=supervisor_tick
        self.decisions: List[Dict[str, Any]] = []  # cstlint-torch: owned_by=supervisor_tick
        # ...except the brownout rung, which the health/heartbeat thread
        # may read through brownout_rung()/status() while the tick
        # thread escalates — hence the named state lock (LOCK_ORDER).
        self._state_lock = named_lock("serving.autoscale.state")
        self._rung = 0  # cstlint-torch: guarded_by=self._state_lock
        self._c = {name: 0 for name in AUTOSCALE_COUNTERS}
        if registry is not None:
            registry.declare(*AUTOSCALE_COUNTERS)

    # -- counters ----------------------------------------------------------

    def _inc(self, name: str, n: int = 1) -> None:
        self._c[name] += n
        if self._registry is not None:
            self._registry.inc(name, n)

    def counters(self) -> Dict[str, int]:
        """The ONE definition of the autoscaler's audit view (the
        supervisor_counters discipline)."""
        return dict(self._c)

    # -- brownout hooks (read by the supervisor's shed paths) --------------

    def brownout_rung(self) -> int:
        """Current ladder rung (0 = no brownout).  Safe from any
        thread."""
        with self._state_lock:
            return self._rung

    def note_shed(self, rung: str) -> None:
        """Count one typed brownout shed (``deadline``/``parked``/
        ``stream``) — called by the supervisor at the shed site."""
        self._inc(f"brownout_shed_{rung}")

    # -- the decision tick -------------------------------------------------

    def tick(self, sup, now: float) -> None:
        """One decision turn, on the supervisor tick right after the
        scraper: ingest fresh samples from the ring, evaluate the
        dual-window signals, act at most once."""
        fresh = [s for s in self._fleet_obs.series()
                 if s.get("seq", 0) > self._last_seq]
        if not fresh:
            return
        self._last_seq = fresh[-1]["seq"]
        for s in fresh:
            self._window.append(self._digest(s))
            self._inc("autoscale_ticks")
        self._decide(sup, now)

    @staticmethod
    def _digest(sample: Dict[str, Any]) -> Dict[str, Any]:
        """Reduce one scrape sample to the decision inputs: the WORST
        live child's queue_wait/decode attribution p99 (the starving
        child is the one a new replica relieves), plus settledness and
        the SLO firing set."""
        qws: List[float] = []
        dcs: List[float] = []
        settled = True
        for c in sample.get("children", []):
            state = c.get("state")
            if state in ("starting", "backoff") or c.get("retiring"):
                settled = False
            if not c.get("live"):
                continue
            attr = c.get("attribution_p99_ms") or {}
            qw = attr.get("queue_wait")
            dc = attr.get("decode")
            # The child's attribution p99 is ring-cumulative (it never
            # decays after a burst), so a child with NO current work —
            # empty admission queue, nothing in flight — contributes
            # zero queue pressure: the down-signal reads "is anything
            # waiting NOW", the up-signal reads "how long did waiting
            # take" — both from the same scraped row.
            idle = (not c.get("inflight")
                    and not (c.get("queue_depth") or 0))
            if qw is not None and not idle:
                qws.append(qw)
            if dc is not None:
                dcs.append(dc)
        return {
            "queue_wait_ms": float(max(qws)) if qws else 0.0,
            "decode_ms": float(max(dcs)) if dcs else 0.0,
            "settled": settled,
            "slo_firing": bool((sample.get("slo") or {}).get("firing")),
        }

    def _signals(self) -> Dict[str, Any]:
        """The dual-window burn view over the ingested samples."""
        win = list(self._window)
        fast = win[-self.fast_samples:]

        def mean(rows, key):
            return (sum(r[key] for r in rows) / len(rows)) if rows else 0.0

        fast_qw = mean(fast, "queue_wait_ms")
        slow_qw = mean(win, "queue_wait_ms")
        fast_dc = mean(fast, "decode_ms")
        slow_dc = mean(win, "decode_ms")
        # Decode "flat": the fast-window decode p99 has not outgrown the
        # slow baseline — queueing is rising on its own, so capacity
        # (not the model) is the bottleneck.  An empty baseline (no
        # completions yet) counts as flat.
        decode_flat = (slow_dc <= 0.0
                       or fast_dc <= self.decode_flat_factor * slow_dc)
        up = (len(win) >= self.fast_samples
              and fast_qw >= self.queue_hi_ms
              and slow_qw >= self.queue_hi_ms
              and decode_flat)
        down = (len(win) == self.slow_samples
                and all(r["queue_wait_ms"] <= self.queue_lo_ms
                        for r in win)
                and not any(r["slo_firing"] for r in win))
        return {
            "up": up, "down": down,
            "settled": bool(win and win[-1]["settled"]),
            "queue_wait_fast_ms": round(fast_qw, 3),
            "queue_wait_slow_ms": round(slow_qw, 3),
            "decode_fast_ms": round(fast_dc, 3),
            "decode_slow_ms": round(slow_dc, 3),
            "decode_flat": decode_flat,
        }

    def _decide(self, sup, now: float) -> None:
        sig = self._signals()
        n = sup.active_replicas()
        if sig["up"]:
            self._calm_ticks = 0
            if n >= self.max_replicas:
                self._inc("autoscale_holds_bounds")
                self._sat_ticks += 1
                if self._sat_ticks >= self.brownout_patience:
                    self._sat_ticks = 0
                    self._escalate(sup, now, sig, n)
                return
            self._sat_ticks = 0
            if not sig["settled"]:
                return   # a spawn/drain is already in flight: let it land
            if (self._last_up_t is not None
                    and now - self._last_up_t < self.up_cooldown_s):
                self._inc("autoscale_holds_cooldown")
                return
            added = sup.add_replica()
            self._last_up_t = now
            self._inc("autoscale_scale_ups")
            self._record(sup, now, "scale_up", sig, n, n + 1,
                         replica=added)
            return
        self._sat_ticks = 0
        if self.brownout_rung() > 0:
            self._calm_ticks += 1
            if self._calm_ticks >= self.brownout_patience:
                self._calm_ticks = 0
                self._deescalate(sup, now, sig, n)
            return
        if sig["down"]:
            if n <= self.min_replicas:
                self._inc("autoscale_holds_bounds")
                return
            if not sig["settled"]:
                return
            if (self._last_down_t is not None
                    and now - self._last_down_t < self.down_cooldown_s):
                self._inc("autoscale_holds_cooldown")
                return
            retired = sup.retire_worst()
            if retired is None:
                return
            self._last_down_t = now
            self._inc("autoscale_scale_downs")
            self._record(sup, now, "scale_down", sig, n, n - 1,
                         replica=retired)
            # A shrink empties the window's claim to a full quiet slow
            # window at the NEW size — re-earn it before the next one.
            self._window.clear()

    # -- the brownout ladder -----------------------------------------------

    def _escalate(self, sup, now: float, sig: Dict[str, Any],
                  n: int) -> None:
        with self._state_lock:
            if self._rung >= len(BROWNOUT_RUNGS):
                return
            self._rung += 1
            rung = self._rung
        self._inc("brownout_entries")
        self._record(sup, now, "brownout_enter", sig, n, n, rung=rung,
                     rung_name=BROWNOUT_RUNGS[rung - 1])

    def _deescalate(self, sup, now: float, sig: Dict[str, Any],
                    n: int) -> None:
        with self._state_lock:
            if self._rung <= 0:
                return
            left = BROWNOUT_RUNGS[self._rung - 1]
            self._rung -= 1
            rung = self._rung
        self._inc("brownout_exits")
        self._record(sup, now, "brownout_exit", sig, n, n, rung=rung,
                     rung_name=left)

    # -- the decisions log -------------------------------------------------

    def _record(self, sup, now: float, action: str, sig: Dict[str, Any],
                before: int, after: int, **attrs) -> None:
        self._seq += 1
        rec = {
            "schema": AUTOSCALE_SCHEMA,
            "kind": "autoscale_decision",
            "seq": self._seq,
            "action": action,
            "t": float(now),
            "wall": self.wall(),
            "replicas_before": int(before),
            "replicas_after": int(after),
            "rung": self.brownout_rung(),
            "reason": {k: sig[k] for k in
                       ("queue_wait_fast_ms", "queue_wait_slow_ms",
                        "decode_fast_ms", "decode_slow_ms",
                        "decode_flat")},
            "thresholds": {"queue_hi_ms": self.queue_hi_ms,
                           "queue_lo_ms": self.queue_lo_ms},
            **attrs,
        }
        self.decisions.append(rec)
        if self.decisions_path is not None:
            # The slo_alerts.jsonl appender discipline: append-only
            # JSONL, fsync'd per decision (decisions are rare by
            # construction — the cooldowns bound the rate).
            with open(self.decisions_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
        if self._lifecycle is not None:
            self._lifecycle.emit(
                "autoscale_decision", f"autoscale:{self._seq}",
                action=action, replicas_before=int(before),
                replicas_after=int(after), rung=rec["rung"],
                queue_wait_fast_ms=sig["queue_wait_fast_ms"],
                queue_wait_slow_ms=sig["queue_wait_slow_ms"])

    # -- views --------------------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The embedded status doc (scrape rows, stats, the probe
        record).  Safe from any thread."""
        return {
            "enabled": True,
            "min": self.min_replicas,
            "max": self.max_replicas,
            "rung": self.brownout_rung(),
            "queue_hi_ms": self.queue_hi_ms,
            "queue_lo_ms": self.queue_lo_ms,
            "scale_ups": self._c["autoscale_scale_ups"],
            "scale_downs": self._c["autoscale_scale_downs"],
            "brownout_entries": self._c["brownout_entries"],
            "brownout_exits": self._c["brownout_exits"],
            "decisions": len(self.decisions),
            "counters": self.counters(),
        }
