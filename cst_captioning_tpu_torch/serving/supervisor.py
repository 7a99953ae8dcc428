"""Process-fleet supervisor: serve-CLI child processes, the exit-taxonomy
lifecycle, crash-proof requeue and the blackbox harvest from dead
replicas (own copy of the reference's ``serving/supervisor.py``: the same
classes, counters, wire and records).

The in-process fleet (``serving/fleet.py``) heals N engine replicas
inside one process, so a native abort in any replica kills them all.
This module moves the failure domain to the OS process: the supervisor
owns N **child processes**, each a real ``python -m
cst_captioning_tpu_torch.serve`` speaking the JSONL wire over its
localhost socket front end (``serving/server.py``).  The wire format,
streaming, deadlines and result semantics are unchanged: a client of
``python -m cst_captioning_tpu_torch.serve_supervisor`` cannot tell a
process fleet from one engine except by what survives a kill.  Only the
children touch the card: this module imports no torch.

**Lifecycle is the exit taxonomy** (``resilience/exitcodes.classify``):

- ``resumable`` (75 preempted, 137 SIGKILL, 143 SIGTERM) and ``wedge``
  (124) child exits → restart with bounded exponential backoff
  (``backoff_ms`` base, doubling, capped) and **requeue of the dead
  replica's in-flight requests**: arrival clocks are preserved (the
  supervisor measures latency from its own intake, and forwards the
  REMAINING TTL to the new owner), and the re-decode is the same
  deterministic program on the same inputs — captions bit-identical to
  a fault-free twin.  The restart does not consume budget: resumable is
  the taxonomy's "try again" verdict.
- ``fatal`` (1, 130, uncatalogued) child exits consume the
  ``restart_limit`` budget; a replica past budget is ``dead``.  When
  EVERY replica is dead, :class:`SupervisorUnrecoverable` maps onto
  exit 124 at the front end — supervised restart one level up, exactly
  the signal this supervisor consumes from its own children.
- A replica that goes line-silent with work owed for longer than
  ``wedge_timeout_s`` is wedge-killed from OUTSIDE and classified as
  exit 124: a SIGSTOP'd child cannot run its own watchdog (every
  thread is frozen), so the supervisor enforces the same timeout the
  child's ``--wedge_timeout`` enforces internally — both roads lead to
  the one ``wedge`` classification and the one restart path.  A child
  that is still starting is not live, so the timer never counts it.

**Streaming across a process death** stays prefix-consistent via
supervisor-level watermarks: per request, ``sent_tokens`` counts tokens
already forwarded to the client and ``cur_tokens`` counts tokens
received from the CURRENT owner; a requeued request re-decodes from
step 0 on its new child, the replayed tokens fall inside the watermark
and are sliced off (tokens and text in lockstep — ``Vocab.decode`` is
one word per non-zero token, so the text fragments concatenate to the
final caption bit for bit), and ``seq`` is re-issued supervisor-side.

**Every child death leaves evidence**: on a DELIBERATE kill the
supervisor first issues ``{"op": "dump"}`` (the child's flight recorder
lands ``blackbox.json``) with a bounded grace, then SIGKILLs; after any
death it harvests the child workdir's ``blackbox.json`` /
``heartbeat.json`` / ``telemetry.json`` / ``stderr.log`` into a
per-incident directory ``incidents/<NNN>_replica<K>_rc<RC>/`` with an
``incident.json`` index.

**One fleet health plane**: the supervisor polls ``{"op": "health"}``
per child, folds its own lifecycle view (restarts, backoff, budget) on
top, and serves worst-of-replicas + per-replica detail — the policies
(healthy-tier-first placement, route-around-degraded, fleet-edge
deadline shed) are those of :mod:`serving.policy`, shared with
:class:`fleet.FleetRouter`.

**The fleet observability plane rides the tick**
(:mod:`telemetry.fleetobs`): when the supervisor is armed with a
``fleet_obs`` collaborator it stamps per-request trace context onto the
child wire (children echo it through their lifecycle events, so a
merged trace can stitch one track across the process boundary),
answers timestamped ``{"op": "ping"}`` echoes into a per-process
clock-skew table, scrapes every replica slot's stats/health on a
cadence into ``fleet_metrics.jsonl``, and evaluates SLO burn rates
whose firing alerts degrade the fleet health view.  All child-facing
queries — health polls included — go through the ONE paced
:meth:`ProcessFleetSupervisor.query_child` path with
:class:`serving.policy.QueryPacer` interval/backoff policy.

**Chaos**: ``proc_kill@replica=K`` → SIGKILL (dump-before-kill),
``proc_wedge@replica=K`` → SIGSTOP until the wedge timeout fires the
124 path, ``proc_preempt@replica=K`` → SIGTERM (the child's own drain
contract: residents complete, its queue comes back
``rejected_draining`` and is REQUEUED — the fleet is not draining —
then exit 75).  Each fires once, at the first tick where the target
replica has in-flight work and has emitted at least one response line
(deterministically "mid-work").

Threading mirrors the server: reader threads (one per child socket, one
per client connection) only move lines; the single scheduler loop owns
every replica and request.  Shared with the watchdog/heartbeat thread
are ONLY the snapshot table (``serving.supervisor.health`` lock) and
the parked-request list (``serving.supervisor.requeue`` lock), in the
declared LOCK_ORDER below.  Restart spawns run on short-lived helper
threads that touch nothing but the launcher and a thread-safe hatch
queue — a mid-traffic restart (seconds of torch import, CUDA context
and model build in the child) never stalls the scheduler loop.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set

from ..resilience.exitcodes import (EXIT_OK, EXIT_PREEMPTED, EXIT_SIGTERM,
                                    EXIT_WEDGE, classify, describe, normalize)
from ..resilience.integrity import atomic_json_write
from ..utils.locksan import declare_order, named_lock
from .policy import (QueryPacer, deadline_unmeetable, rank_key,
                     worst_status)

log = logging.getLogger(__name__)

#: Supervisor-level counters (declared at 0 — registry.declare; the
#: reference's names).
SUPERVISOR_COUNTERS = (
    "sup_requests",           # client caption/stream requests accepted
    "sup_routed",             # successful placements at a child
    "sup_rerouted",           # placed at a non-first candidate / re-placed
    "sup_requeued",           # in-flight moved off a dead/draining child
    "sup_parked",             # held while no live child could take work
    "sup_shed",               # fleet-edge sheds (incl. deadline shed)
    "sup_replica_restarts",   # child restarts performed
    "sup_replica_deaths",     # replicas dead past the fatal-exit budget
    "sup_wedge_kills",        # line-silent children killed as exit 124
    "sup_incidents",          # incident bundles harvested
    "sup_bad_lines",          # unparseable/unattributable child lines
    "sup_replicas_added",     # autoscale grow: new replica slots spawned
    "sup_replicas_retired",   # autoscale shrink: slots drained out
    "sup_journal_appends",    # intake-journal records fsync'd
    "sup_journal_replayed",   # pre-crash requests re-submitted at relaunch
    "sup_journal_dup_hits",   # duplicate ids answered from the journal
    "sup_journal_attached",   # duplicate ids attached to an open stream
    "sup_journal_torn",       # torn journal records dropped at recovery
)

#: Declared acquisition order (for the lock sanitizer): the health snapshot lock may nest the parked-list lock
#: (a health render that reads the parked depth), and either may reach
#: the registry's project-wide leaf — never the reverse.
LOCK_ORDER = ("serving.supervisor.health", "serving.supervisor.requeue",
              "telemetry.registry")
declare_order(*LOCK_ORDER)

#: The front end's write-before-conn law, same as serving/server.py:
#: whole response lines serialize under the server-wide write lock,
#: then the per-connection send lock.
FRONTEND_LOCK_ORDER = ("serving.supervisor.write",
                       "serving.supervisor.conn")
declare_order(*FRONTEND_LOCK_ORDER)

#: The socket child's startup announcement (serving/server.run_socket).
_PORT_RE = re.compile(r"serve: listening on 127\.0\.0\.1:(\d+)")


class SupervisorUnrecoverable(RuntimeError):
    """Every replica is dead and the fatal-exit budget is spent: this
    supervisor's supervision is exhausted.  The front end maps this
    onto ``exitcodes.EXIT_WEDGE`` (124) — the same supervised-restart
    signal the supervisor consumes from its own children."""


class ChildStartupError(RuntimeError):
    """A child exited or never announced its port during startup."""


# ---------------------------------------------------------------------------
# the real child transport
# ---------------------------------------------------------------------------


class ServeChild:
    """One serve.py OS process + its line transport: the duck-typed
    child handle the supervisor drives (tests substitute an in-process
    fake with the same surface).  The surface: ``send_line`` /
    ``lines`` / ``poll`` / ``terminate`` / ``kill`` / ``stop`` /
    ``cont`` / ``close``, plus ``workdir`` and ``pid``.  A reader
    thread moves socket lines into a thread-safe inbox; everything
    else runs on the supervisor's scheduler loop."""

    def __init__(self, proc: subprocess.Popen, sock: socket.socket,
                 workdir: str, replica: int, stderr_path: str):
        self.proc = proc
        self.workdir = workdir
        self.replica = int(replica)
        self.stderr_path = stderr_path
        self._sock = sock
        self._inbox: "queue.Queue[str]" = queue.Queue()
        threading.Thread(target=self._read,
                         name=f"sup-child-{replica}", daemon=True).start()

    @property
    def pid(self) -> int:
        return self.proc.pid

    def _read(self) -> None:
        """Move the child's lines into the inbox until its socket closes.
        The socket keeps its connect timeout, so that a send to a stopped
        child cannot block the scheduler for good; a read that times out
        only means the child had nothing to say (a child started first
        waits, silent, while the supervisor starts the others), and the
        reader waits again."""
        buf = b""
        while True:
            try:
                chunk = self._sock.recv(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                return  # socket died with the child; poll() reports it
            if not chunk:
                return
            *lines, buf = (buf + chunk).split(b"\n")
            for line in lines:
                self._inbox.put(line.decode("utf-8", "replace") + "\n")

    def send_line(self, line: str) -> None:
        """Raises OSError when the child's socket is gone — the caller
        routes around and the next poll reaps the exit."""
        self._sock.sendall(line.encode() + b"\n")

    def lines(self) -> List[str]:
        out: List[str] = []
        while True:
            try:
                out.append(self._inbox.get_nowait())
            except queue.Empty:
                return out

    def poll(self) -> Optional[int]:
        rc = self.proc.poll()
        return None if rc is None else normalize(rc)

    def terminate(self) -> None:
        self.proc.terminate()

    def kill(self) -> None:
        self.proc.kill()

    def stop(self) -> None:
        os.kill(self.proc.pid, signal.SIGSTOP)

    def cont(self) -> None:
        os.kill(self.proc.pid, signal.SIGCONT)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        try:
            # Reap the zombie; bounded — a stuck child was SIGKILLed
            # by the caller before close.
            self.proc.wait(timeout=10)
        except (subprocess.TimeoutExpired, OSError):
            pass


def spawn_serve_child(argv: List[str], workdir: str, replica: int, *,
                      env: Optional[Dict[str, str]] = None,
                      startup_timeout_s: float = 180.0,
                      new_session: bool = False) -> ServeChild:
    """Spawn one serve.py child in socket mode and connect to it.

    The child's stderr goes to ``<workdir>/stderr.log`` (harvestable
    after a crash — no pipe to drain, no reader thread to leak); the
    ephemeral port (``--serve_port -1``) is scraped from that file's
    ``serve: listening on 127.0.0.1:<port>`` announcement.  Raises
    :class:`ChildStartupError` when the child exits or stays silent
    past ``startup_timeout_s`` (torch import, the CUDA context, the model
    and the kernel library's load dominate).
    ``new_session=True`` gives the child its own process group — the
    journal drill spawns a whole SUPERVISOR this way so one
    ``killpg`` takes the coordinator and its children down together,
    the worst-case death the intake journal must survive."""
    os.makedirs(workdir, exist_ok=True)
    stderr_path = os.path.join(workdir, "stderr.log")
    with open(stderr_path, "w") as errf:
        proc = subprocess.Popen(argv, stdin=subprocess.DEVNULL,
                                stdout=subprocess.DEVNULL, stderr=errf,
                                env=env, start_new_session=new_session)
    deadline = time.monotonic() + startup_timeout_s
    port = None
    while time.monotonic() < deadline:
        rc = proc.poll()
        if rc is not None:
            raise ChildStartupError(
                f"replica {replica} exited {normalize(rc)} "
                f"({describe(normalize(rc))}) during startup; see "
                f"{stderr_path}")
        try:
            with open(stderr_path) as f:
                m = _PORT_RE.search(f.read())
        except OSError:
            m = None
        if m:
            port = m.group(1)
            break
        time.sleep(0.05)
    if port is not None:
        port = int(port)
    else:
        proc.kill()
        raise ChildStartupError(
            f"replica {replica} never announced its port within "
            f"{startup_timeout_s:.0f}s; see {stderr_path}")
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    log.info("supervisor: replica %d up (pid %d, port %d)", replica,
             proc.pid, port)
    return ServeChild(proc, sock, workdir, replica, stderr_path)


# ---------------------------------------------------------------------------
# supervisor bookkeeping
# ---------------------------------------------------------------------------


@dataclass
class ProxyRequest:
    """One client request in flight across the fleet."""

    sup_id: str                 # supervisor-unique wire id (child-facing)
    client_id: Any              # the client's id, restored on every answer
    video_id: str
    stream: bool
    respond: Callable[[Dict[str, Any]], None]
    arrival: float              # supervisor-intake monotonic clock
    ttl_ms: Optional[float]     # client TTL; remaining is forwarded
    no_cache: bool = False
    replica: Optional[int] = None
    tried: Set[int] = field(default_factory=set)
    sent_tokens: int = 0        # stream watermark: tokens the client has
    cur_tokens: int = 0         # tokens received from the CURRENT owner
    seq_out: int = 0            # supervisor-issued stream sequence
    requeues: int = 0
    key: Optional[str] = None   # intake-journal idempotency key
    attached: bool = True       # False: journal-replayed, no live client

    def remaining_ms(self, now: float) -> Optional[float]:
        if self.ttl_ms is None:
            return None
        return self.ttl_ms - (now - self.arrival) * 1e3


class ProcReplica:
    """Supervisor-side bookkeeping for one OS-process replica slot.
    ``state``: ``starting`` (spawn in flight) → ``ok`` (serving) →
    ``backoff`` (dead, restart scheduled) → ``dead`` (budget spent) —
    plus ``drained`` once a fleet drain retires it, and ``retired``
    once an autoscale scale-down drains the slot out of service
    (terminal like ``dead``, but deliberate: it never degrades fleet
    health and is never restarted)."""

    def __init__(self, index: int):
        self.index = int(index)
        self.child = None
        self.workdir: Optional[str] = None
        self.state = "starting"
        self.restarts = 0          # restarts performed
        self.fatal_spent = 0       # fatal exits charged against budget
        self.kills = 0             # deliberate supervisor kills
        self.backoff_level = 0     # consecutive deaths since a completion
        self.backoff_until = 0.0
        self.last_line_t = 0.0     # wedge detection: last line seen
        self.lines_seen = 0        # response lines since (re)start
        self.inflight: Set[str] = set()
        self.health: Dict[str, Any] = {}
        self.compiles0: Optional[int] = None   # first post-warm compile count
        self.last_stats: Optional[Dict[str, Any]] = None
        self.last_rc: Optional[int] = None
        self.completed = 0
        self.kill_at: Optional[float] = None   # pending deliberate-kill
                                               # deadline (real monotonic)
        self.retiring = False      # autoscale drain-out in progress

    @property
    def live(self) -> bool:
        return self.state == "ok" and self.child is not None


class ProcessFleetSupervisor:
    """Own N serve.py OS-process replicas (module docstring).

    ``launcher(replica_index) -> child`` builds one replica's child
    handle (:func:`spawn_serve_child` for the real CLI; tests pass a
    fake factory).  All child-facing state is single-owner on the
    scheduler loop; see LOCK_ORDER for the two shared structures."""

    def __init__(self, launcher: Callable[[int], Any], replicas: int, *,
                 restart_limit: int = 3, backoff_ms: float = 200.0,
                 backoff_cap_ms: float = 5000.0,
                 wedge_timeout_s: float = 0.0,
                 health_interval_s: float = 0.5,
                 dump_grace_s: float = 2.0,
                 incident_dir: Optional[str] = None,
                 fault_plan=None, registry=None, lifecycle=None,
                 fleet_obs=None, autoscaler=None, journal=None,
                 clock: Callable[[], float] = time.monotonic,
                 spawn_async: bool = True):
        n = int(replicas)
        if n < 1:
            raise ValueError(f"a process fleet needs >= 1 replica, got {n}")
        self._launcher = launcher
        self.restart_limit = max(0, int(restart_limit))
        self.backoff_ms = max(0.0, float(backoff_ms))
        self.backoff_cap_ms = max(self.backoff_ms, float(backoff_cap_ms))
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.health_interval_s = float(health_interval_s)
        self.dump_grace_s = float(dump_grace_s)
        self.incident_dir = incident_dir
        self._plan = fault_plan
        self._registry = registry
        self._lifecycle = lifecycle
        # Optional fleet observability plane (telemetry/fleetobs.py):
        # trace-context stamping, clock pings, the metrics
        # scraper and the SLO monitor all hang off this one hook —
        # None costs one is-None check per call site (the house rule),
        # and keeps the wire byte-identical for unarmed fleets.
        self._fleet_obs = fleet_obs
        # Optional autoscaler (serving/autoscale.py): rides
        # the tick right after the scraper, grows/shrinks the slot list
        # through add_replica()/retire_worst(), and its brownout rung
        # tightens the shed paths — same one-is-None-check-per-site
        # rule as fleet_obs.
        self._autoscaler = autoscaler
        # Optional durable intake journal (serving/journal.py): accepts are fsync'd BEFORE placement, stream chunks and
        # terminals at send time, so the supervisor process itself
        # becomes a survivable failure domain — same one-is-None-check-
        # per-site rule as fleet_obs/autoscaler.
        self._journal = journal
        self.clock = clock
        self.spawn_async = spawn_async
        # Single-owner scheduler state (the module-docstring contract).
        self._replicas: List[ProcReplica] = [  # cstlint-torch: owned_by=scheduler
            ProcReplica(k) for k in range(n)]
        self._pending: Dict[str, ProxyRequest] = {}  # cstlint-torch: owned_by=scheduler
        # Journal idempotency keys of OPEN requests -> their in-flight
        # ProxyRequest (duplicate submits attach here).
        self._inflight_keys: Dict[str, ProxyRequest] = {}  # cstlint-torch: owned_by=scheduler
        self._incidents: List[Dict[str, Any]] = []  # cstlint-torch: owned_by=scheduler
        self._seq = 0
        self._completed = 0
        self._latencies_ms: List[float] = []  # cstlint-torch: owned_by=scheduler
        self._draining = False  # cstlint-torch: owned_by=scheduler
        # Health polling rides the SHARED child-query pacing policy
        # (serving/policy.QueryPacer): the
        # same interval/backoff object family the fleet scraper uses,
        # so "how often do we poke a child" cannot fork between the
        # health plane and the metrics plane.  A never-polled child is
        # due immediately (first-tick semantics preserved).
        self._health_pacer = QueryPacer(self.health_interval_s)
        self._dirty = True
        # Restart spawns hatch through a thread-safe queue: the helper
        # thread touches ONLY the launcher and this queue.
        self._hatch: "queue.Queue" = queue.Queue()
        self._spawning: Set[int] = set()  # cstlint-torch: owned_by=scheduler
        # Shared with the watchdog/heartbeat thread, in LOCK_ORDER.
        self._health_lock = named_lock("serving.supervisor.health")
        self._requeue_lock = named_lock("serving.supervisor.requeue")
        self._snapshots: List[Dict[str, Any]] = []  # cstlint-torch: guarded_by=self._health_lock
        self._totals: Dict[str, Any] = {}  # cstlint-torch: guarded_by=self._health_lock
        self._parked: List[ProxyRequest] = []  # cstlint-torch: guarded_by=self._requeue_lock
        self._c = {name: 0 for name in SUPERVISOR_COUNTERS}
        if registry is not None:
            registry.declare(*SUPERVISOR_COUNTERS)
        # Boot the fleet serially and synchronously: deterministic, and
        # a replica that cannot even START is a configuration error the
        # operator must see immediately, not a backoff loop.
        for rep in self._replicas:
            self._assign_child(rep, self._launcher(rep.index))
        self._update_snapshots()

    # -- counters ----------------------------------------------------------

    def _inc(self, name: str, n: int = 1) -> None:
        self._c[name] += n
        if self._registry is not None:
            self._registry.inc(name, n)

    def supervisor_counters(self) -> Dict[str, int]:
        """The ONE definition of the supervisor's audit view (the
        fleet_counters discipline: stats, health, the probe record, and
        serve_report all render exactly this dict)."""
        return dict(self._c)

    # -- lifecycle: spawn / death / restart --------------------------------

    def _assign_child(self, rep: ProcReplica, child) -> None:
        rep.child = child
        rep.workdir = getattr(child, "workdir", None)
        rep.state = "ok"
        rep.last_line_t = self.clock()
        rep.lines_seen = 0
        rep.health = {}
        rep.compiles0 = None
        rep.last_stats = None
        # A fresh OS process: poll it immediately, and let the fleet
        # plane drop the dead generation's pacing history and in-flight
        # clock pings (skew is per process — re-measured per restart).
        self._health_pacer.forget(rep.index)
        if self._fleet_obs is not None:
            self._fleet_obs.on_child_assigned(rep.index)
        self._dirty = True

    def _spawn_failed(self, rep: ProcReplica, err: BaseException) -> None:
        """A restart that could not even start is charged like a fatal
        exit — a replica crash-looping in its launcher must not spin
        free forever."""
        log.error("supervisor: replica %d failed to start: %s",
                  rep.index, err)
        rep.fatal_spent += 1
        if rep.fatal_spent > self.restart_limit:
            self._mark_dead(rep)
        else:
            self._schedule_restart(rep)

    def _schedule_restart(self, rep: ProcReplica) -> None:
        """Bounded exponential backoff: ``backoff_ms * 2^level`` capped
        at ``backoff_cap_ms``; the level resets when the replica next
        completes a request (it is healthy again)."""
        rep.state = "backoff"
        rep.backoff_level += 1
        delay_ms = min(self.backoff_ms * (2 ** (rep.backoff_level - 1)),
                       self.backoff_cap_ms)
        rep.backoff_until = self.clock() + delay_ms / 1e3
        self._dirty = True
        log.warning("supervisor: replica %d restarting in %.0fms "
                    "(death %d since last healthy completion)",
                    rep.index, delay_ms, rep.backoff_level)

    def _mark_dead(self, rep: ProcReplica) -> None:
        rep.state = "dead"
        self._inc("sup_replica_deaths")
        log.error("supervisor: replica %d exhausted its fatal-exit "
                  "budget (%d) and is removed from service", rep.index,
                  self.restart_limit)
        self._dirty = True
        self._check_unrecoverable()

    def _check_unrecoverable(self) -> None:
        if self._draining:
            return
        if all(r.state in ("dead", "drained", "retired")
               for r in self._replicas):
            raise SupervisorUnrecoverable(
                "every replica is dead (fatal-exit budget "
                f"{self.restart_limit} exhausted fleet-wide)")

    def _restart_due(self, now: float) -> None:
        for rep in self._replicas:
            if rep.state != "backoff" or now < rep.backoff_until:
                continue
            if rep.index in self._spawning:
                continue
            rep.restarts += 1
            self._inc("sup_replica_restarts")
            rep.state = "starting"
            self._dirty = True
            if not self.spawn_async:
                try:
                    child = self._launcher(rep.index)
                except Exception as e:
                    self._spawn_failed(rep, e)
                else:
                    self._assign_child(rep, child)
                continue
            self._spawning.add(rep.index)

            def run(ix: int = rep.index) -> None:
                # Helper-thread body: ONLY the launcher and the hatch
                # queue — no supervisor state (thread-ownership law).
                try:
                    child = self._launcher(ix)
                except Exception as e:  # hatched as a failed start
                    self._hatch.put((ix, None, e))
                else:
                    self._hatch.put((ix, child, None))

            threading.Thread(target=run, name=f"sup-spawn-{rep.index}",
                             daemon=True).start()

    def _hatch_ready(self) -> None:
        while True:
            try:
                ix, child, err = self._hatch.get_nowait()
            except queue.Empty:
                return
            rep = self._replicas[ix]
            self._spawning.discard(ix)
            if self._draining:
                if child is not None:
                    try:
                        child.kill()
                    except OSError:
                        pass
                    child.close()
                rep.state = "drained"
                continue
            if err is not None:
                self._spawn_failed(rep, err)
                continue
            self._assign_child(rep, child)

    # -- autoscale: grow / shrink the slot list ----------------------------

    def active_replicas(self) -> int:
        """Slots still in service or coming up — the autoscaler's
        notion of fleet size (terminal slots don't count)."""
        return sum(1 for r in self._replicas
                   if r.state not in ("dead", "drained", "retired"))

    def add_replica(self) -> int:
        """Append one replica slot and spawn it through the existing
        warm child recipe (the launcher IS `spawn_serve_child` in real
        fleets, so the new child pays zero post-warmup compiles).
        Mirrors `_restart_due`'s sync/async split; returns the new slot
        index immediately — the child lands via `_hatch_ready` (async)
        or inline (sync)."""
        rep = ProcReplica(len(self._replicas))
        self._replicas.append(rep)
        self._inc("sup_replicas_added")
        self._dirty = True
        log.info("supervisor: autoscale adding replica %d", rep.index)
        if not self.spawn_async:
            try:
                child = self._launcher(rep.index)
            except Exception as e:
                self._spawn_failed(rep, e)
            else:
                self._assign_child(rep, child)
            return rep.index
        self._spawning.add(rep.index)

        def run(ix: int = rep.index) -> None:
            # Helper-thread body: ONLY the launcher and the hatch
            # queue — no supervisor state (thread-ownership law).
            try:
                child = self._launcher(ix)
            except Exception as e:  # hatched as a failed start
                self._hatch.put((ix, None, e))
            else:
                self._hatch.put((ix, child, None))

        threading.Thread(target=run, name=f"sup-spawn-{rep.index}",
                         daemon=True).start()
        return rep.index

    def retire_worst(self) -> Optional[int]:
        """Drain the worst-ranked live child out of service (autoscale
        scale-down).  Strictly drain-based: ``terminate()`` flips the
        child to draining, in-flight work finishes, queue rejections
        flow back as ``rejected_draining`` and requeue elsewhere, and
        the eventual exit lands in `_on_death`'s retiring path.  Picks
        via the SHARED ``policy.rank_key`` (degraded first, then most
        loaded, then highest index) so "worst" cannot fork between
        placement and retirement.  Refuses (returns None) when it
        would leave no serving candidate."""
        cands = [r for r in self._replicas
                 if r.live and not r.retiring and r.kill_at is None]
        if len(cands) <= 1:
            return None
        worst = max(cands, key=lambda r: rank_key(
            r.health.get("status") == "degraded",
            len(r.inflight), r.index))
        worst.retiring = True
        self._dirty = True
        log.info("supervisor: autoscale retiring replica %d (drain, "
                 "%d in flight)", worst.index, len(worst.inflight))
        try:
            worst.child.terminate()
        except OSError:
            pass
        return worst.index

    def _reap_exits(self) -> None:
        for rep in self._replicas:
            if rep.child is None:
                continue
            rc = rep.child.poll()
            if rc is not None:
                self._on_death(rep, rc)

    def _on_death(self, rep: ProcReplica, rc: int, *,
                  wedged: bool = False) -> None:
        """The one exit path for a dead child: harvest evidence, move
        its in-flight requests, classify, schedule what comes next."""
        child = rep.child
        # Drain the last buffered lines BEFORE declaring the requests
        # orphaned: a drained child's final completions/rejections are
        # already in the inbox and must reach their clients.
        self._pump_one(rep)
        rep.last_rc = rc
        cls = "wedge" if wedged else classify(rc)
        log.warning("supervisor: replica %d exited %d (%s -> %s) with "
                    "%d in flight", rep.index, rc, describe(rc), cls,
                    len(rep.inflight))
        child.close()
        rep.child = None
        rep.kill_at = None
        self._dirty = True
        expected = ((self._draining or rep.retiring)
                    and cls in ("ok", "resumable"))
        if not expected:
            self._harvest_incident(rep, rc, cls)
        orphans = [self._pending[i] for i in sorted(rep.inflight)
                   if i in self._pending]
        rep.inflight.clear()
        if self._draining:
            # Mid-drain the fleet accepts no work: a child that died
            # before finishing answers its orphans the drain way.
            rep.state = "drained"
            for pr in orphans:
                self._answer_reject_draining(pr)
            return
        if rep.retiring:
            # A deliberate autoscale drain-out: the exit is the POINT,
            # so no restart and no budget charge.  A clean/resumable
            # exit retires the slot quietly; anything else already
            # harvested an incident above.  Orphans (a child that died
            # MID-drain with work aboard) fall through the ordinary
            # requeue below — exactly-once is preserved by the same
            # path a crash uses.
            rep.state = "retired"
            rep.retiring = False
            self._inc("sup_replicas_retired")
            log.info("supervisor: replica %d retired (autoscale "
                     "scale-down, rc=%d)", rep.index, rc)
            for pr in orphans:
                pr.requeues += 1
                pr.cur_tokens = 0
                pr.tried = {rep.index}
                self._inc("sup_requeued")
                if self._lifecycle is not None:
                    self._lifecycle.emit("killed", pr.sup_id,
                                         replica=rep.index, rc=rc)
                    self._lifecycle.emit("requeued", pr.sup_id)
                self._place(pr, reroute=True)
            return
        # Classify-then-schedule BEFORE requeue, so placement sees this
        # replica in its true (non-candidate) state.
        if cls == "fatal":
            rep.fatal_spent += 1
            if rep.fatal_spent > self.restart_limit:
                self._mark_dead(rep)
            else:
                self._schedule_restart(rep)
        else:
            # ok / resumable / wedge: restart free of budget — the
            # taxonomy's own "try again" verdict (an unexpected clean
            # exit 0 is restarted too: the fleet owes N replicas).
            self._schedule_restart(rep)
        for pr in orphans:
            pr.requeues += 1
            pr.cur_tokens = 0          # new owner re-decodes from step 0
            pr.tried = {rep.index}
            self._inc("sup_requeued")
            if self._lifecycle is not None:
                self._lifecycle.emit("killed", pr.sup_id,
                                     replica=rep.index, rc=rc)
                self._lifecycle.emit("requeued", pr.sup_id)
            self._place(pr, reroute=True)

    # -- evidence ----------------------------------------------------------

    def _harvest_incident(self, rep: ProcReplica, rc: int,
                          cls: str) -> None:
        """Bundle whatever the dead child left durable into a
        per-incident directory (RESILIENCE.md "Process faults"):
        blackbox.json (dumped before a deliberate kill, or written by
        the child's own 124/abort paths), heartbeat.json,
        telemetry.json, stderr.log, plus an incident.json index."""
        self._inc("sup_incidents")
        entry: Dict[str, Any] = {
            "replica": rep.index, "rc": rc, "classification": cls,
            "inflight": len(rep.inflight), "files": [],
        }
        if self.incident_dir and rep.workdir:
            name = (f"{len(self._incidents):03d}_replica{rep.index}"
                    f"_rc{rc}")
            d = os.path.join(self.incident_dir, name)
            try:
                os.makedirs(d, exist_ok=True)
                for fn in ("blackbox.json", "heartbeat.json",
                           "telemetry.json", "stderr.log"):
                    src = os.path.join(rep.workdir, fn)
                    if os.path.exists(src):
                        shutil.copyfile(src, os.path.join(d, fn))
                        entry["files"].append(fn)
                entry["dir"] = d
                atomic_json_write(os.path.join(d, "incident.json"),
                                  entry, indent=2)
            except OSError as e:
                # Evidence collection must never kill supervision.
                log.error("supervisor: incident harvest failed: %s", e)
        self._incidents.append(entry)

    def _dump_then_kill(self, rep: ProcReplica) -> None:
        """The deliberate-kill protocol: ask the child's flight
        recorder to land blackbox.json first (``{"op": "dump"}``),
        bounded grace, then SIGKILL.  The grace does NOT block the
        tick loop — a pending deadline is stamped and
        :meth:`_finish_pending_kills` lands the kill once the blackbox
        appears or the grace expires, so the health/scrape planes keep
        running through a deliberate kill (the fleet_report blackout
        gate caught the blocking version going dark).  Real wall-clock
        for the grace — a frozen test clock must not turn it into a
        wait that never expires."""
        try:
            rep.child.send_line(json.dumps({"op": "dump"}))
        except OSError:
            pass
        rep.kill_at = time.monotonic() + self.dump_grace_s

    def _finish_pending_kills(self) -> None:
        for rep in self._replicas:
            if rep.kill_at is None:
                continue
            if rep.child is None:
                rep.kill_at = None
                continue
            bb = (os.path.join(rep.workdir, "blackbox.json")
                  if rep.workdir else None)
            if (bb and os.path.exists(bb)) \
                    or time.monotonic() >= rep.kill_at:
                rep.kill_at = None
                rep.child.kill()    # reaped as 137 next tick

    # -- chaos -------------------------------------------------------------

    def _fire_proc_faults(self) -> None:
        if self._plan is None:
            return
        for rep in self._replicas:
            if not rep.live or not rep.inflight or rep.lines_seen == 0:
                # "Mid-work", deterministically: at least one request
                # in flight AND at least one response line emitted.
                continue
            if self._plan.fire_replica("proc_kill", rep.index):
                rep.kills += 1
                self._dump_then_kill(rep)       # reaped as 137 next tick
            elif self._plan.fire_replica("proc_wedge", rep.index):
                rep.child.stop()                # the wedge timer takes it
            elif self._plan.fire_replica("proc_preempt", rep.index):
                rep.child.terminate()           # child drains, exits 75

    def _check_wedges(self, now: float) -> None:
        """Line-silence wedge detection: a live child OWING work that
        has produced nothing for ``wedge_timeout_s`` is killed and
        classified exit 124 — the supervisor-side mirror of the child's
        own ``--wedge_timeout`` (which a SIGSTOP'd child cannot run)."""
        if self.wedge_timeout_s <= 0:
            return
        for rep in self._replicas:
            if not rep.live or not rep.inflight:
                continue
            if now - rep.last_line_t <= self.wedge_timeout_s:
                continue
            self._inc("sup_wedge_kills")
            rep.kills += 1
            log.error("supervisor: replica %d line-silent %.1fs with %d "
                      "in flight — wedge kill (-> %d)", rep.index,
                      now - rep.last_line_t, len(rep.inflight),
                      EXIT_WEDGE)
            try:
                rep.child.kill()   # SIGKILL works on a stopped process
            except OSError:
                pass
            self._on_death(rep, EXIT_WEDGE, wedged=True)

    # -- health plane ------------------------------------------------------

    def query_child(self, index: int, payload: Dict[str, Any]) -> bool:
        """The ONE child-query send path every timed poller routes
        through (health poll, fleet scraper, clock pings): serialize, send, report success.  A
        dead socket answers False — the caller's pacer backs off and
        the next reap classifies the exit."""
        rep = self._replicas[int(index)]
        if not rep.live:
            return False
        try:
            rep.child.send_line(json.dumps(payload))
        except OSError:
            return False
        return True

    def _health_poll(self, now: float) -> None:
        for rep in self._replicas:
            if not rep.live:
                continue
            if not self._health_pacer.due(rep.index, now):
                continue
            self._health_pacer.sent(rep.index, now)
            if not self.query_child(rep.index, {"op": "health"}):
                self._health_pacer.failed(rep.index)

    def request_stats(self, index: int) -> bool:
        """Ask replica ``index`` for ``{"op": "stats"}``; the reply
        lands in its ``last_stats`` on a later tick (probe use)."""
        return self.query_child(index, {"op": "stats"})

    def dump_children(self) -> int:
        """Forward ``{"op": "dump"}`` to every live child (the fleet
        forensic snapshot behind the front end's dump op); returns how
        many children were asked."""
        n = 0
        for rep in self._replicas:
            if not rep.live:
                continue
            try:
                rep.child.send_line('{"op": "dump"}')
                n += 1
            except OSError:
                pass
        return n

    def scrape_snapshot(self) -> Dict[str, Any]:
        """The fleet scraper's per-tick view (telemetry/fleetobs.py):
        one entry per replica SLOT regardless of state — live,
        restarting or dead — so the scraped series has zero per-replica
        gaps across a child restart; the latest health/stats replies
        ride along.  Scheduler thread only."""
        with self._requeue_lock:
            parked = len(self._parked)
        lat = sorted(self._latencies_ms)

        def pct(q: float) -> Optional[float]:
            if not lat:
                return None
            ix = min(len(lat) - 1, int(round(q / 100 * (len(lat) - 1))))
            return round(lat[ix], 3)

        children = []
        for rep in self._replicas:
            children.append({
                "index": rep.index, "state": rep.state, "live": rep.live,
                "restarts": rep.restarts,
                "inflight": len(rep.inflight),
                "retiring": rep.retiring,
                "pid": (rep.child.pid if rep.child is not None else None),
                "health": dict(rep.health),
                "stats": (dict(rep.last_stats)
                          if rep.last_stats is not None else None),
            })
        fleet = {
            "replicas": len(self._replicas),
            "active": self.active_replicas(),
            "in_service": sum(1 for r in self._replicas if r.live),
            "outstanding": len(self._pending),
            "parked": parked,
            "completed": self._completed,
            "latency_p50_ms": pct(50),
            "latency_p99_ms": pct(99),
            "supervisor": self.supervisor_counters(),
        }
        if self._autoscaler is not None:
            fleet["autoscale"] = self._autoscaler.status()
        return {"fleet": fleet, "children": children}

    def _update_snapshots(self) -> None:
        snaps: List[Dict[str, Any]] = []
        for rep in self._replicas:
            h = rep.health
            if rep.state == "ok":
                status = h.get("status", "ok")
            elif rep.state in ("starting", "backoff"):
                status = "restarting"
            elif rep.state == "retired":
                status = "retired"
            else:
                status = "dead"
            snaps.append({
                "replica": rep.index, "status": status,
                "state": rep.state,
                "queue_depth": h.get("queue_depth") or 0,
                "residents": h.get("residents") or 0,
                "inflight": len(rep.inflight),
                "completed": rep.completed,
                "restarts": rep.restarts, "kills": rep.kills,
                "fatal_spent": rep.fatal_spent,
                "last_rc": rep.last_rc,
                "compiles": h.get("compiles"),
                # The post-warm baseline (first health after (re)start):
                # compiles - compiles0 is the replica's recompile count,
                # readable over the wire by the journal drill.
                "compiles0": rep.compiles0,
                "min_service_ms": h.get("min_service_ms"),
                "pid": (rep.child.pid if rep.child is not None
                        else None),
            })
        totals = {
            "outstanding": len(self._pending),
            "completed": self._completed,
            "incidents": len(self._incidents),
        }
        with self._health_lock:
            self._snapshots = snaps
            self._totals = totals

    def health_payload(self) -> Dict[str, Any]:
        """The fleet health view: worst-of-replicas plus per-replica
        detail, the supervisor's lifecycle folded in.  Snapshot-backed
        — safe from the watchdog's heartbeat thread while the
        scheduler owns the children (LOCK_ORDER: health then requeue,
        never the reverse)."""
        with self._health_lock:
            per = [dict(s) for s in self._snapshots]
            totals = dict(self._totals)
            with self._requeue_lock:
                parked = len(self._parked)
        # A retired slot is a DELIBERATE absence (autoscale scale-down)
        # — it must never degrade the worst-of view the way a dead or
        # restarting slot does.  All-retired cannot outlive a tick
        # (_check_unrecoverable), so the filtered view stays honest.
        status = worst_status(s["status"] for s in per
                              if s["status"] != "retired")
        out: Dict[str, Any] = {}
        if self._fleet_obs is not None:
            if self._fleet_obs.alerting:
                # A fast-burning SLO is a fleet-health fact: the
                # worst-of view degrades while the alert is firing
                # even when every replica reports ok.
                status = worst_status((status, "degraded"))
            out["slo"] = self._fleet_obs.slo_status()
        return {
            **out,
            "status": status,
            "replicas": len(per),
            "in_service": sum(1 for s in per
                              if s["status"] in ("ok", "degraded")),
            "queue_depth": sum(s["queue_depth"] for s in per),
            "residents": sum(s["residents"] for s in per),
            "outstanding": totals.get("outstanding", 0),
            "parked": parked,
            "completed": totals.get("completed", 0),
            "supervisor": self.supervisor_counters(),
            "per_replica": per,
        }

    def stats(self) -> Dict[str, Any]:
        """The probe/report view (scheduler thread)."""
        self._update_snapshots()
        with self._health_lock:
            per = [dict(s) for s in self._snapshots]
        with self._requeue_lock:
            parked = len(self._parked)
        lat = sorted(self._latencies_ms)

        def pct(q: float) -> Optional[float]:
            if not lat:
                return None
            ix = min(len(lat) - 1, int(round(q / 100 * (len(lat) - 1))))
            return round(lat[ix], 3)

        out = {
            "replicas": len(self._replicas),
            "active": self.active_replicas(),
            "in_service": sum(1 for r in self._replicas if r.live),
            "outstanding": len(self._pending),
            "parked": parked,
            "completed": self._completed,
            "latency_p50_ms": pct(50),
            "latency_p99_ms": pct(99),
            "supervisor": self.supervisor_counters(),
            "per_replica": per,
            "incidents": [dict(i) for i in self._incidents],
        }
        if self._fleet_obs is not None:
            out["slo"] = self._fleet_obs.slo_status()
        if self._autoscaler is not None:
            out["autoscale"] = self._autoscaler.status()
        if self._journal is not None:
            out["journal"] = self._journal.stats()
        return out

    # -- routing -----------------------------------------------------------

    def submit(self, client_id: Any, video_id: str, *,
               respond: Callable[[Dict[str, Any]], None],
               stream: bool = False, deadline_ms: Optional[float] = None,
               no_cache: bool = False, idem: Optional[str] = None,
               have_seq: Optional[int] = None) -> None:
        """Accept one client request; every path answers eventually
        (immediate shed/expiry answers now, through ``respond``).

        With the intake journal armed every request carries
        an idempotency key — the wire's ``idem`` field, or
        ``"<id>|<video_id>"`` when the client sent none.  A duplicate
        of an already-TERMINAL key is answered from the journal with
        zero decode work (``idempotent: true``); a duplicate of an
        OPEN key attaches this channel to the in-flight request,
        catching it up from the journaled chunk marks past
        ``have_seq``.  Fresh accepts are fsync'd BEFORE placement."""
        key = None
        if self._journal is not None:
            key = str(idem) if idem is not None \
                else f"{client_id}|{video_id}"
            prev = self._journal.terminal_for(key)
            if prev is not None:
                self._inc("sup_journal_dup_hits")
                out = dict(prev)
                out["id"] = client_id
                out["idempotent"] = True
                respond(out)
                return
            live = self._inflight_keys.get(key)
            if live is not None:
                self._attach(live, respond, have_seq)
                return
        self._seq += 1
        pr = ProxyRequest(
            sup_id=f"s{self._seq}", client_id=client_id,
            video_id=str(video_id), stream=bool(stream), respond=respond,
            arrival=self.clock(),
            ttl_ms=(None if deadline_ms is None else float(deadline_ms)),
            no_cache=bool(no_cache), key=key)
        self._inc("sup_requests")
        self._pending[pr.sup_id] = pr
        if key is not None:
            # Accept-before-placement: once this append returns, a
            # supervisor crash cannot lose the request.
            self._inflight_keys[key] = pr
            self._journal.accept(
                key, client_id, pr.video_id, stream=pr.stream,
                ttl_ms=pr.ttl_ms, no_cache=pr.no_cache)
            self._inc("sup_journal_appends")
        if self._lifecycle is not None:
            self._lifecycle.emit("received", pr.sup_id,
                                 client_id=client_id, video_id=video_id)
        if self._draining:
            self._answer_reject_draining(pr)
            return
        if (pr.stream and self._autoscaler is not None
                and self._autoscaler.brownout_rung() >= 3):
            # Brownout rung 3 (the last before collapse): new stream
            # ops — the long-held, token-by-token kind — are rejected
            # at intake with a typed shed; one-shot captions still
            # flow through admission.
            self._autoscaler.note_shed("stream")
            self._inc("sup_shed")
            self._finish(pr, {"id": pr.client_id, "error": "shed",
                              "video_id": pr.video_id,
                              "why": "brownout_stream"},
                         "shed", where="fleet",
                         reason="brownout_stream")
            return
        self._place(pr)

    def _attach(self, pr: ProxyRequest, respond: Callable[[Dict[str, Any]],
                None], have_seq: Optional[int]) -> None:
        """A duplicate submit of an OPEN key adopts the new channel:
        the journaled chunk marks past ``have_seq`` (all of them when
        the client sent none) are replayed first, then live chunks and
        the terminal flow to this channel — a prefix-consistent
        continuation no matter where the reconnect fell."""
        self._inc("sup_journal_attached")
        pr.respond = respond
        pr.attached = True
        if pr.stream and pr.key is not None:
            floor = -1 if have_seq is None else int(have_seq)
            for m in self._journal.marks_for(pr.key):
                if m["seq"] <= floor:
                    continue
                pr.respond({"id": pr.client_id, "video_id": pr.video_id,
                            "stream": True, "seq": m["seq"],
                            "tokens": list(m["tokens"]),
                            "text": m["text"], "final": False})
        if self._lifecycle is not None:
            self._lifecycle.emit("queued", pr.sup_id,
                                 where="journal_attach")

    def replay_journal(self) -> Dict[str, Any]:
        """Re-enter every accepted-but-unanswered pre-crash request
        into the serving plane (called once by the front end right
        after construction, children already live).  Arrival clocks
        and remaining TTLs are preserved across the process death via
        the journal's wall clock; stream watermarks are primed from
        the journaled marks so continuation chunks start exactly where
        the dead supervisor stopped sending.  Returns the recovery
        ledger document (auditable via the blackbox/incident
        machinery)."""
        if self._journal is None:
            return {"schema": 1, "enabled": False}
        rec = self._journal.recovery
        if rec.torn_records:
            self._inc("sup_journal_torn", rec.torn_records)
        now = self.clock()
        replayed: List[Dict[str, Any]] = []
        for acc in self._journal.open_requests():
            key = acc["key"]
            self._seq += 1
            # Wall-clock delta is the ONLY clock that survives the
            # dead process (monotonic-deadline's exemption: the
            # journal's injected wall clock, not bare time.time()); it
            # rebases the arrival into THIS incarnation's monotonic
            # domain, never into a deadline comparison directly.
            elapsed_s = max(
                self._journal.wall() - acc["arrival_wall"], 0.0)
            # cstlint-torch: disable=device-scalar-fetch -- journaled JSON accept fields: host values, never tensors (the supervisor imports no torch)
            pr = ProxyRequest(
                sup_id=f"s{self._seq}", client_id=acc["client_id"],
                video_id=acc["video_id"], stream=bool(acc["stream"]),
                respond=lambda obj: None,   # detached until a client
                arrival=now - elapsed_s,    # re-submits the same key
                ttl_ms=acc["ttl_ms"], no_cache=bool(acc["no_cache"]),
                key=key, attached=False)
            marks = self._journal.marks_for(key)
            if marks:
                last = marks[-1]
                # cstlint-torch: disable=device-scalar-fetch -- journaled JSON mark fields: host ints, never tensors
                pr.sent_tokens = int(last["sent_tokens"])
                # cstlint-torch: disable=device-scalar-fetch -- journaled JSON mark fields: host ints, never tensors
                pr.seq_out = int(last["seq"]) + 1
            self._inc("sup_requests")
            self._inc("sup_journal_replayed")
            self._pending[pr.sup_id] = pr
            self._inflight_keys[key] = pr
            if self._lifecycle is not None:
                # No "received" — intake happened in the DEAD process;
                # the replayed-headed chain is accounted truncated
                # (telemetry/lifecycle.EVENT_KINDS).
                self._lifecycle.emit("replayed", pr.sup_id,
                                     key=key, video_id=pr.video_id,
                                     seq_out=pr.seq_out,
                                     sent_tokens=pr.sent_tokens)
            # cstlint-torch: disable=device-scalar-fetch -- journaled JSON accept field: a host value, never a tensor
            replayed.append({"key": key, "sup_id": pr.sup_id,
                             "video_id": pr.video_id,
                             "stream": bool(acc["stream"]),
                             "sent_tokens": pr.sent_tokens,
                             "seq_out": pr.seq_out})
            self._place(pr)
        self._dirty = True
        return {
            "schema": 1,
            "enabled": True,
            "replayed": replayed,
            "recovered_terminals": len(rec.terminals),
            "torn_records": rec.torn_records,
            "segments_scanned": rec.segments_scanned,
            "high_water": self._journal.high_water(),
        }

    def _candidates(self, tried: Set[int]) -> List[ProcReplica]:
        """Live replicas not yet tried for this placement, in the
        SHARED policy order (serving/policy.rank_key): healthy tier
        first (the child's own health status), the supervisor's
        in-flight count as the load, index tiebreak."""
        active = [r for r in self._replicas
                  if r.live and r.kill_at is None
                  and not r.retiring and r.index not in tried]
        return sorted(active, key=lambda r: rank_key(
            r.health.get("status") == "degraded",
            len(r.inflight), r.index))

    def _place(self, pr: ProxyRequest, reroute: bool = False) -> None:
        now = self.clock()
        rem = pr.remaining_ms(now)
        if rem is not None and rem <= 0:
            self._answer_expired(pr)
            return
        cands = self._candidates(pr.tried)
        if not cands:
            if any(r.state in ("starting", "backoff")
                   or r.kill_at is not None
                   for r in self._replicas):
                # Momentarily no live child (restarts in flight): HOLD
                # — the request outlives the replica that owned it.
                self._park(pr)
                return
            if not any(r.live for r in self._replicas):
                self._check_unrecoverable()
            self._answer_shed(pr)
            return
        if rem is not None:
            floors = [None if s.health.get("min_service_ms") is None
                      else float(s.health["min_service_ms"]) / 1e3
                      for s in cands]
            if deadline_unmeetable(rem, floors):
                # Provably unmeetable EVERYWHERE: shed at the fleet edge
                # with an explicit answer (SERVING.md "Fleet").
                self._answer_expired(pr, why="deadline_unmeetable")
                return
            if (self._autoscaler is not None
                    and self._autoscaler.brownout_rung() >= 1
                    and deadline_unmeetable(
                        rem, floors,
                        margin=self._autoscaler.deadline_margin)):
                # Brownout rung 1: the fleet is pinned at max and still
                # burning, so admission tightens — a deadline without
                # margin-x headroom over every service floor is shed
                # NOW rather than admitted to miss (SERVING.md
                # "Autoscaling & brownout").
                self._autoscaler.note_shed("deadline")
                self._answer_expired(pr, why="brownout_deadline")
                return
        msg: Dict[str, Any] = {"id": pr.sup_id, "video_id": pr.video_id,
                               "op": "stream" if pr.stream else "caption"}
        if rem is not None:
            msg["deadline_ms"] = rem
        if pr.no_cache:
            msg["no_cache"] = True
        if self._fleet_obs is not None:
            # Cross-process trace context (SERVING.md wire addendum):
            # the child threads this through its lifecycle events, so
            # fleet_trace.py can join its async track to the
            # supervisor's.  `recv_s` is the supervisor's intake clock
            # (its own monotonic domain — context, not a timestamp the
            # child may compare against its clocks).
            msg["trace"] = {"id": pr.sup_id, "recv_s": pr.arrival}
        line = json.dumps(msg)
        for i, rep in enumerate(cands):
            try:
                rep.child.send_line(line)
            except OSError:
                pr.tried.add(rep.index)   # dying child; reaped next tick
                continue
            pr.replica = rep.index
            rep.inflight.add(pr.sup_id)
            self._inc("sup_routed")
            if i or reroute:
                self._inc("sup_rerouted")
            if self._lifecycle is not None:
                self._lifecycle.emit("routed", pr.sup_id,
                                     replica=rep.index, candidate=i)
            self._dirty = True
            return
        # Every candidate's socket failed mid-send: hold for the reaper.
        self._park(pr)

    def _park(self, pr: ProxyRequest) -> None:
        if (self._autoscaler is not None
                and self._autoscaler.brownout_rung() >= 2):
            with self._requeue_lock:
                depth = len(self._parked)
            if depth >= self._autoscaler.parked_cap:
                # Brownout rung 2: the hold queue is capacity the fleet
                # no longer has — overflow is shed honestly with a
                # typed answer instead of parking into a miss.
                self._autoscaler.note_shed("parked")
                self._inc("sup_shed")
                self._finish(pr, {"id": pr.client_id, "error": "shed",
                                  "video_id": pr.video_id,
                                  "why": "brownout_parked"},
                             "shed", where="fleet",
                             reason="brownout_parked")
                return
        pr.replica = None
        pr.tried = set()   # a fresh attempt reconsiders everyone
        self._inc("sup_parked")
        if self._lifecycle is not None:
            self._lifecycle.emit("queued", pr.sup_id, where="supervisor")
        with self._requeue_lock:
            self._parked.append(pr)

    def _retry_parked(self, now: float) -> None:
        with self._requeue_lock:
            if not self._parked:
                return
            parked, self._parked = self._parked, []
        for pr in parked:
            rem = pr.remaining_ms(now)
            if rem is not None and rem <= 0:
                self._answer_expired(pr)
                continue
            if self._draining:
                self._answer_reject_draining(pr)
                continue
            self._place(pr, reroute=True)

    # -- child line handling -----------------------------------------------

    def _pump_children(self) -> int:
        n = 0
        for rep in self._replicas:
            n += self._pump_one(rep)
        return n

    def _pump_one(self, rep: ProcReplica) -> int:
        child = rep.child
        if child is None:
            return 0
        moved = 0
        for raw in child.lines():
            moved += 1
            rep.last_line_t = self.clock()
            try:
                obj = json.loads(raw)
            except ValueError:
                self._inc("sup_bad_lines")
                continue
            if not isinstance(obj, dict):
                self._inc("sup_bad_lines")
                continue
            op = obj.get("op")
            if op == "health":
                rep.health = obj
                self._health_pacer.ok(rep.index)
                if rep.compiles0 is None and "compiles" in obj:
                    # First health after (re)start: the post-warm
                    # compile baseline the probe's zero-recompile
                    # check is measured against.
                    rep.compiles0 = obj.get("compiles")
                self._dirty = True
                continue
            if op == "stats":
                rep.last_stats = obj
                if self._fleet_obs is not None:
                    self._fleet_obs.on_stats(rep.index)
                continue
            if op == "ping":
                # Clock-sync echo: only the fleet plane
                # sends pings, so an unarmed supervisor never sees one.
                if self._fleet_obs is not None:
                    self._fleet_obs.on_ping(rep.index, obj,
                                            t1=self.clock())
                continue
            if op == "dump":
                continue   # the child announced where its blackbox went
            if "id" in obj:
                rep.lines_seen += 1
                self._on_response(rep, obj)
                continue
            self._inc("sup_bad_lines")
        return moved

    def _on_response(self, rep: ProcReplica, obj: Dict[str, Any]) -> None:
        pr = self._pending.get(obj.get("id"))
        if pr is None or pr.replica != rep.index:
            # Stale: a line from an owner this request already left
            # (answered, requeued, or expired) — drop, never double-
            # answer a client id.
            return
        err = obj.get("error")
        if err is None and obj.get("stream") and not obj.get("final"):
            self._forward_chunk(pr, obj)
            return
        if err == "shed":
            # The child's bounded queue shed it: route around.
            rep.inflight.discard(pr.sup_id)
            pr.tried.add(rep.index)
            pr.replica = None
            self._place(pr, reroute=True)
            return
        if err == "rejected_draining" and not self._draining:
            # The CHILD is draining (proc_preempt / external SIGTERM)
            # but the fleet is not: the client must never see a drain
            # it did not cause — requeue.
            rep.inflight.discard(pr.sup_id)
            pr.tried.add(rep.index)
            pr.replica = None
            pr.cur_tokens = 0
            pr.requeues += 1
            self._inc("sup_requeued")
            if self._lifecycle is not None:
                self._lifecycle.emit("requeued", pr.sup_id,
                                     replica=rep.index)
            self._place(pr, reroute=True)
            return
        self._terminal(rep, pr, obj)

    def _forward_chunk(self, pr: ProxyRequest, obj: Dict[str, Any]) -> None:
        """The supervisor-level stream watermark (module docstring):
        only tokens beyond ``sent_tokens`` reach the client, text
        sliced in lockstep, ``seq`` re-issued supervisor-side."""
        toks = obj.get("tokens") or []
        start = pr.cur_tokens
        pr.cur_tokens = start + len(toks)
        if pr.cur_tokens <= pr.sent_tokens:
            return   # fully inside the watermark: a replayed chunk
        skip = max(pr.sent_tokens - start, 0)
        out_toks = toks[skip:]
        # Vocab.decode is one word per non-zero token (zeros only pad
        # the tail), so the word list is a prefix-aligned mirror of the
        # token list and slices at the same offset.
        words = str(obj.get("text") or "").split()
        out_text = " ".join(words[skip:]) if skip < len(words) else ""
        pr.sent_tokens = pr.cur_tokens
        out = {"id": pr.client_id, "video_id": pr.video_id,
               "stream": True, "seq": pr.seq_out,
               "tokens": [int(t) for t in out_toks],
               "text": out_text, "final": False}
        pr.seq_out += 1
        if self._journal is not None and pr.key is not None:
            # Watermark + chunk journaled at send time: a relaunch
            # resumes exactly past what this append proves was sent,
            # and a reconnecting client is caught up from the record.
            self._journal.mark(pr.key, out["seq"], out["tokens"],
                               out["text"], pr.sent_tokens)
            self._inc("sup_journal_appends")
        pr.respond(out)

    def _terminal(self, rep: ProcReplica, pr: ProxyRequest,
                  obj: Dict[str, Any]) -> None:
        """Forward a child's terminal answer with the client's id (and
        the client's clocks) restored."""
        rep.inflight.discard(pr.sup_id)
        self._pending.pop(pr.sup_id, None)
        self._dirty = True
        out = dict(obj)
        out["id"] = pr.client_id
        if "latency_ms" in out:
            # The ARRIVAL clock is the supervisor's intake: a requeued
            # request's latency spans its whole story, not only its
            # final owner's share.
            lat = (self.clock() - pr.arrival) * 1e3
            out["latency_ms"] = round(lat, 3)
            self._latencies_ms.append(lat)
        if pr.stream and out.get("final") and "chunks" in out:
            out["chunks"] = pr.seq_out   # chunks the CLIENT saw
        err = out.get("error")
        if self._fleet_obs is not None:
            self._fleet_obs.observe_request(
                err is None and "caption" in out,
                out.get("latency_ms"), self.clock())
        if err is None and "caption" in out:
            rep.completed += 1
            rep.backoff_level = 0   # healthy again: backoff resets
            self._completed += 1
            if self._lifecycle is not None:
                self._lifecycle.emit("completed", pr.sup_id,
                                     replica=rep.index,
                                     requeues=pr.requeues)
        elif self._lifecycle is not None:
            self._lifecycle.emit("dropped", pr.sup_id,
                                 reason=str(err), replica=rep.index)
        self._journal_terminal(pr, out)
        pr.respond(out)
        if self._lifecycle is not None:
            self._lifecycle.emit("responded", pr.sup_id,
                                 status=(err or "ok"))

    # -- terminal answers the supervisor itself writes ---------------------

    def _journal_terminal(self, pr: ProxyRequest,
                          obj: Dict[str, Any]) -> None:
        """Journal a terminal at send time and retire the open key —
        EVERY terminal path (child answer, shed, expiry, drain reject)
        funnels through here before ``respond``."""
        if self._journal is None or pr.key is None:
            return
        self._inflight_keys.pop(pr.key, None)
        self._journal.terminal(pr.key, obj)
        self._inc("sup_journal_appends")

    def _finish(self, pr: ProxyRequest, obj: Dict[str, Any],
                kind: str, **attrs) -> None:
        if self._fleet_obs is not None:
            # Every supervisor-written terminal (shed/expired/drain
            # reject) is a failed outcome in the SLO books.
            self._fleet_obs.observe_request(False, None, self.clock())
        self._pending.pop(pr.sup_id, None)
        if pr.replica is not None:
            self._replicas[pr.replica].inflight.discard(pr.sup_id)
        if pr.stream:
            obj["stream"] = True
            obj["final"] = True   # the _mark_stream_terminal invariant
        if self._lifecycle is not None:
            self._lifecycle.emit(kind, pr.sup_id, **attrs)
            self._lifecycle.emit("responded", pr.sup_id,
                                 status=obj.get("error", "ok"))
        self._journal_terminal(pr, obj)
        pr.respond(obj)

    def _answer_shed(self, pr: ProxyRequest) -> None:
        self._inc("sup_shed")
        self._finish(pr, {"id": pr.client_id, "error": "shed",
                          "video_id": pr.video_id,
                          "queue_depth": len(self._pending)},
                     "shed", where="fleet")

    def _answer_expired(self, pr: ProxyRequest,
                        why: Optional[str] = None) -> None:
        obj = {"id": pr.client_id, "video_id": pr.video_id,
               "error": "expired", "where": "fleet"}
        if why is not None:
            obj["why"] = why
            self._inc("sup_shed")
        self._finish(pr, obj, "dropped",
                     reason=(why or "expired"), where="fleet")

    def _answer_reject_draining(self, pr: ProxyRequest) -> None:
        self._finish(pr, {"id": pr.client_id, "video_id": pr.video_id,
                          "error": "rejected_draining"},
                     "dropped", reason="rejected_draining",
                     where="fleet_drain")

    # -- the scheduler tick ------------------------------------------------

    def tick(self) -> int:
        """One supervision step, called by the front-end loop: hatch
        finished spawns, reap exits, restart what is due, move child
        lines, fire armed chaos, wedge-check, health-poll, retry
        parked.  Returns an activity count (0 = idle)."""
        now = self.clock()
        self._hatch_ready()
        self._reap_exits()
        self._restart_due(now)
        moved = self._pump_children()
        self._fire_proc_faults()
        self._finish_pending_kills()
        self._check_wedges(now)
        self._health_poll(now)
        if self._fleet_obs is not None:
            self._fleet_obs.tick(self, now)
        if self._autoscaler is not None and not self._draining:
            # Right after the scraper: the autoscaler decides from the
            # sample the scraper may just have appended, same tick.
            self._autoscaler.tick(self, now)
        self._retry_parked(now)
        if self._dirty:
            self._dirty = False
            self._update_snapshots()
        return moved

    @property
    def quiet(self) -> bool:
        """Nothing owed: no pending requests, nothing parked, no spawn
        in flight (EOF may exit)."""
        with self._requeue_lock:
            parked = len(self._parked)
        return (not self._pending and not parked
                and not self._spawning and self._hatch.empty())

    @property
    def outstanding(self) -> int:
        return len(self._pending)

    # -- drain / shutdown --------------------------------------------------

    def begin_drain(self) -> None:
        """First-signal semantics: TERM every child (each runs its OWN
        drain contract — residents complete, queues reject), answer
        everything parked, accept nothing new.  Children exiting 75/0
        during the drain are expected: no incident, no restart."""
        self._draining = True
        self._dirty = True
        for rep in self._replicas:
            if rep.child is None:
                continue
            try:
                rep.child.terminate()
            except OSError:
                pass
        with self._requeue_lock:
            parked, self._parked = self._parked, []
        for pr in parked:
            self._answer_reject_draining(pr)

    def drain_done(self) -> bool:
        return (not self._pending
                and all(r.child is None for r in self._replicas)
                and not self._spawning and self._hatch.empty())

    def hard_abort(self) -> None:
        """Second-signal semantics: SIGKILL every child NOW and answer
        every outstanding id ``rejected_draining`` — lost in-flight
        work is honest, a silent drop never is."""
        for rep in self._replicas:
            if rep.child is None:
                continue
            try:
                rep.child.kill()
            except OSError:
                pass
            rep.child.close()
            rep.child = None
            rep.state = "drained"
        with self._requeue_lock:
            self._parked = []
        # A parked request is still pending: each is answered once (the
        # reference answers a parked one twice here).
        for pr in list(self._pending.values()):
            self._answer_reject_draining(pr)
        self._update_snapshots()

    def shutdown(self, timeout_s: float = 60.0) -> None:
        """EOF shutdown: nothing is owed (``quiet``) — TERM children,
        bounded wait for their clean 75s, SIGKILL stragglers."""
        self._draining = True
        for rep in self._replicas:
            if rep.child is None:
                continue
            try:
                rep.child.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(r.child is None or r.child.poll() is not None
                   for r in self._replicas):
                break
            time.sleep(0.05)
        for rep in self._replicas:
            if rep.child is None:
                continue
            if rep.child.poll() is None:
                try:
                    rep.child.kill()
                except OSError:
                    pass
            rep.child.close()
            rep.child = None
            rep.state = "drained"
        if self._journal is not None:
            self._journal.close()
        self._update_snapshots()


# ---------------------------------------------------------------------------
# the client front end
# ---------------------------------------------------------------------------


class SupervisorServer:
    """The supervisor's own JSONL front end — the CaptionServer wire
    (stdin or localhost socket), proxied: caption/stream requests route
    through the :class:`ProcessFleetSupervisor`; ``health`` answers the
    aggregated fleet plane; ``stats`` the supervisor view;
    ``dump`` writes the supervisor's own blackbox AND forwards the op
    to every child.  Same shutdown contract as serve.py: first signal
    drains (children first), second hard-stops with every outstanding
    id answered ``rejected_draining``; stdin EOF finishes everything
    and exits 0."""

    def __init__(self, sup: ProcessFleetSupervisor, *, handler=None,
                 out=None, idle_sleep: float = 0.002, watchdog=None,
                 registry=None, lifecycle=None, blackbox_path=None):
        self.sup = sup
        self.handler = handler
        self.out = out if out is not None else sys.stdout
        self.idle_sleep = idle_sleep
        self.watchdog = watchdog
        self.registry = registry
        self._lifecycle = lifecycle
        self.blackbox_path = blackbox_path
        if registry is not None:
            registry.declare("serve_bad_lines", "serve_health_queries",
                             "serve_stats_queries", "serve_dump_queries")
        self._inbox: "queue.Queue" = queue.Queue()
        self._eof = threading.Event()
        self._write_lock = named_lock("serving.supervisor.write")
        self._draining = False  # cstlint-torch: owned_by=scheduler
        self.bound_port: Optional[int] = None

    # -- responses ---------------------------------------------------------

    def _write(self, respond: Callable[[str], None],
               obj: Dict[str, Any]) -> None:
        with self._write_lock:
            respond(json.dumps(obj))

    def _stdout_respond(self, line: str) -> None:
        self.out.write(line + "\n")
        self.out.flush()

    def _count(self, name: str) -> None:
        if self.registry is not None:
            self.registry.inc(name)

    def health_payload(self) -> Dict[str, Any]:
        h = self.sup.health_payload()
        if self._draining and h["status"] != "draining":
            h["status"] = "draining"
        h["op"] = "health"
        return h

    # -- intake ------------------------------------------------------------

    def _handle_line(self, line: str,
                     respond: Callable[[str], None]) -> None:
        try:
            self._handle_line_inner(line, respond)
        except SupervisorUnrecoverable:
            raise   # the front end's 124 path, never a bad_request
        except Exception as e:  # one bad line must never kill the loop
            self._count("serve_bad_lines")
            try:
                self._write(respond, {"id": None, "error": "bad_request",
                                      "detail":
                                          f"line handling failed: {e}"})
            except Exception as werr:
                log.debug("error response write failed: %r", werr)

    def _handle_line_inner(self, line: str,
                           respond: Callable[[str], None]) -> None:
        line = line.strip()
        if not line:
            return
        try:
            req = json.loads(line)
        except ValueError:
            self._count("serve_bad_lines")
            self._write(respond, {"id": None, "error": "bad_request",
                                  "detail": "unparseable JSON line"})
            return
        if not isinstance(req, dict):
            self._count("serve_bad_lines")
            self._write(respond, {"id": None, "error": "bad_request",
                                  "detail": "expected {'id', 'video_id'}"})
            return
        op = req.get("op", "caption")
        if op == "health":
            self._count("serve_health_queries")
            self._write(respond, self.health_payload())
            return
        if op == "stats":
            self._count("serve_stats_queries")
            self._write(respond, {"op": "stats", **self.sup.stats()})
            return
        if op == "dump":
            self._count("serve_dump_queries")
            asked = self.sup.dump_children()
            if self._lifecycle is None:
                self._write(respond, {"op": "dump", "error": "no_recorder",
                                      "children_asked": asked,
                                      "detail": "lifecycle tracing is "
                                                "disarmed"})
                return
            path = req.get("path") or self.blackbox_path
            if not path:
                self._write(respond, {"op": "dump", "error": "no_path",
                                      "children_asked": asked,
                                      "detail": "no blackbox path "
                                                "configured or supplied"})
                return
            doc = self._lifecycle.dump(path, reason="wire_dump")
            self._write(respond, {"op": "dump", "path": str(path),
                                  "children_asked": asked,
                                  "events": doc["events_retained"],
                                  "emitted": doc["events_emitted"]})
            return
        if op not in ("caption", "stream"):
            self._count("serve_bad_lines")
            self._write(respond, {"id": req.get("id"),
                                  "error": "unknown_op", "op": op,
                                  "detail": "expected op 'caption', "
                                            "'stream', 'health', 'stats' "
                                            "or 'dump'"})
            return
        rid = req.get("id")
        vid = req.get("video_id")
        if vid is None:
            self._count("serve_bad_lines")
            self._write(respond, {"id": rid, "error": "bad_request",
                                  "detail": "expected {'id', 'video_id'}"})
            return
        deadline_ms = req.get("deadline_ms")
        if deadline_ms is not None:
            try:
                deadline_ms = float(deadline_ms)
                if deadline_ms < 0:
                    raise ValueError
            except (TypeError, ValueError):
                self._count("serve_bad_lines")
                self._write(respond, {"id": rid, "error": "bad_request",
                                      "detail": "deadline_ms must be a "
                                                "number >= 0"})
                return
        idem = req.get("idem")
        if idem is not None and not isinstance(idem, str):
            self._count("serve_bad_lines")
            self._write(respond, {"id": rid, "error": "bad_request",
                                  "detail": "idem must be a string"})
            return
        have_seq = req.get("have_seq")
        if have_seq is not None:
            try:
                have_seq = int(have_seq)
            except (TypeError, ValueError):
                self._count("serve_bad_lines")
                self._write(respond, {"id": rid, "error": "bad_request",
                                      "detail": "have_seq must be an "
                                                "integer"})
                return
        # Unknown-video stays the CHILD's verdict (it owns the feature
        # table) — the error comes back as a terminal and is forwarded,
        # so the wire semantics match serve.py exactly.
        self.sup.submit(
            rid, vid,
            respond=lambda obj: self._write(respond, obj),
            stream=(op == "stream"), deadline_ms=deadline_ms,
            no_cache=bool(req.get("no_cache")),
            idem=idem, have_seq=have_seq)

    # -- scheduler loop ----------------------------------------------------

    def _drain_and_exit(self) -> int:
        self._draining = True
        count0 = getattr(self.handler, "signal_count", 0)

        def aborted() -> bool:
            return getattr(self.handler, "signal_count", 0) > count0

        alive = sum(1 for r in self.sup._replicas if r.child is not None)
        print(f"serve_supervisor: draining {self.sup.outstanding} "
              f"outstanding across {alive} child(ren); a second signal "
              "aborts", file=sys.stderr)
        sys.stderr.flush()
        self.sup.begin_drain()
        while not self.sup.drain_done():
            if aborted():
                break
            if self.watchdog is not None:
                self.watchdog.beat()
            if not self.sup.tick():
                time.sleep(self.idle_sleep)
        if aborted():
            unfinished = self.sup.outstanding
            self.sup.hard_abort()
            if self._lifecycle is not None and self.blackbox_path:
                self._lifecycle.dump(self.blackbox_path,
                                     reason="drain_abort")
            print(f"serve_supervisor: drain aborted by a second signal "
                  f"with {unfinished} outstanding; exiting "
                  f"{EXIT_SIGTERM} (sigterm_unwind)", file=sys.stderr)
            return EXIT_SIGTERM
        print(f"serve_supervisor: drained; exiting {EXIT_PREEMPTED} "
              "(preempted/resumable)", file=sys.stderr)
        return EXIT_PREEMPTED

    def _loop(self) -> int:
        while True:
            if self.watchdog is not None:
                self.watchdog.beat()
            if self.handler is not None and self.handler.requested:
                return self._drain_and_exit()
            moved = False
            while True:
                try:
                    line, respond = self._inbox.get_nowait()
                except queue.Empty:
                    break
                self._handle_line(line, respond)
                moved = True
            if self.sup.tick():
                moved = True
            if self._eof.is_set() and self.sup.quiet \
                    and self._inbox.empty():
                self.sup.shutdown()
                return EXIT_OK
            if not moved:
                time.sleep(self.idle_sleep)

    # -- stdin front end ---------------------------------------------------

    def run_stdin(self, lines=None) -> int:
        src = lines if lines is not None else sys.stdin

        def read():
            try:
                for line in src:
                    self._inbox.put((line, self._stdout_respond))
            finally:
                self._eof.set()

        threading.Thread(target=read, name="sup-stdin",
                         daemon=True).start()
        return self._loop()

    # -- localhost socket front end ----------------------------------------

    def run_socket(self, port: int) -> int:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", int(port)))
        srv.listen()
        srv.settimeout(0.2)
        bound = srv.getsockname()[1]
        self.bound_port = bound
        print(f"serve: listening on 127.0.0.1:{bound}", file=sys.stderr)
        sys.stderr.flush()
        conns: List[socket.socket] = []

        def reader(conn: socket.socket) -> None:
            lock = named_lock("serving.supervisor.conn")

            def respond(line: str) -> None:
                with lock:
                    try:
                        conn.sendall(line.encode() + b"\n")
                    except OSError:
                        pass  # client went away; the caption is dropped

            try:
                with conn.makefile("r", encoding="utf-8",
                                   errors="replace") as f:
                    for line in f:
                        self._inbox.put((line, respond))
            except OSError:
                pass

        def accept() -> None:
            while not self._eof.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                conns.append(conn)
                threading.Thread(target=reader, args=(conn,),
                                 name="sup-conn", daemon=True).start()

        threading.Thread(target=accept, name="sup-accept",
                         daemon=True).start()
        try:
            return self._loop()
        finally:
            self._eof.set()
            for conn in conns:
                try:
                    conn.close()
                except OSError:
                    pass
            srv.close()
