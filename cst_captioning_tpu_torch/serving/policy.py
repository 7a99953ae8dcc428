"""Fleet routing policy (own copy of the reference's
``serving/policy.py``): one definition that the in-process
:class:`serving.fleet.FleetRouter` uses, and the process fleet will.

- **Healthy tier first** (:func:`rank_key`): candidates sort into the
  healthy tier before the degraded one, least-loaded within a tier, the
  replica index breaking ties;
- **worst-of health** (:func:`worst_status`): the fleet's one-word
  status is its sickest replica's;
- **the fleet-edge deadline shed** (:func:`deadline_unmeetable`): a
  deadline provably below every candidate's p99 chunk is shed at the
  edge with an explicit answer;
- **paced queries** (:class:`QueryPacer`): the interval-and-backoff
  policy of a supervisor's timed queries to its children.

Standard library only: importable by a process that never touches a
device.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

#: Worst-of ordering for the fleet health status:
#: a rotating replica makes the honest worst-of view ``draining``; the
#: per-replica detail disambiguates.  ``dead`` replicas (and any status
#: outside the table — ``restarting``, ``starting``) rank as
#: ``degraded`` fleet-wide: capacity lost, the survivors still serve.
STATUS_RANK = {"ok": 0, "degraded": 1, "draining": 2}


def rank_key(degraded: bool, load: int, index: int) -> Tuple[int, int, int]:
    """Candidate sort key: healthy tier first, least-loaded within a
    tier, index as the deterministic tiebreak.  ``load`` is whatever the
    caller can measure cheaply (queue + residents for an in-process
    engine; the supervisor's own in-flight count over a socket)."""
    return (1 if degraded else 0, int(load), int(index))


def worst_status(statuses: Iterable[str]) -> str:
    """The fleet's one-word health: the worst replica status under
    :data:`STATUS_RANK` (unknown statuses rank as ``degraded``); an
    empty fleet is ``degraded``, never silently ``ok``."""
    ranks = [STATUS_RANK.get(s, STATUS_RANK["degraded"]) for s in statuses]
    worst = max(ranks) if ranks else STATUS_RANK["degraded"]
    return next(k for k, v in STATUS_RANK.items() if v == worst)


def deadline_unmeetable(ttl_ms: float,
                        floors_s: Iterable[Optional[float]],
                        margin: float = 1.0) -> bool:
    """True when ``ttl_ms`` is provably below every candidate's service
    floor (one p99 decode chunk, seconds) — the fleet-edge shed test.
    Conservative: any unknown floor (``None``, a replica whose latency
    window is not yet honest) makes the answer False — never shed on a
    guess.  ``margin`` inflates the floors (brownout rung 1 tightens
    admission by demanding margin-x headroom); the default 1.0 is the
    plain provably-unmeetable test."""
    floors = list(floors_s)
    if not floors or any(f is None for f in floors):
        return False
    return float(ttl_ms) / 1e3 < min(floors) * float(margin)


class QueryPacer:
    """Per-key interval pacing with failure backoff: the one policy
    behind every timed supervisor-to-child query.

    A key (replica index, or any hashable) is **due** when its interval
    has elapsed since the last :meth:`sent`; a never-queried key is due
    immediately (the supervisor's first tick polls everything).  Consecutive :meth:`failed` marks
    double the key's effective interval (capped at ``backoff_cap``
    multiples) so a wedged child is poked gently; one :meth:`ok` snaps
    it back.  :meth:`forget` resets a key entirely — call it when a
    replica restarts, so the fresh process is queried immediately.

    Pure host bookkeeping around a caller-supplied ``now`` (the
    supervisor's injected clock) — no threads, no time reads of its own,
    deterministic under a fake clock.
    """

    def __init__(self, interval_s: float, backoff_cap: int = 8):
        self.interval_s = max(float(interval_s), 0.0)
        self.backoff_cap = max(int(backoff_cap), 1)
        self._last: dict = {}      # key -> last sent `now`
        self._failures: dict = {}  # key -> consecutive failures

    def due(self, key, now: float) -> bool:
        last = self._last.get(key)
        if last is None:
            return True
        mult = min(2 ** self._failures.get(key, 0), self.backoff_cap)
        return (now - last) >= self.interval_s * mult

    def sent(self, key, now: float) -> None:
        self._last[key] = float(now)

    def ok(self, key) -> None:
        self._failures.pop(key, None)

    def failed(self, key) -> None:
        self._failures[key] = self._failures.get(key, 0) + 1

    def forget(self, key) -> None:
        self._last.pop(key, None)
        self._failures.pop(key, None)
