"""Health-aware fleet router over N self-healing serving engines (own
port of the reference's ``serving/fleet.py``).

The router spreads requests across N engine replicas in one process, each
a ``ServingEngine`` as it is, and speaks the engine's scheduler surface
(``submit`` / ``step`` / ``drain`` / ``pop_dropped`` /
``pop_stream_chunks`` / ``stats`` / ``health`` / ``idle`` ...), so
``serving.server.CaptionServer`` drives a fleet exactly like one engine.

- **Routing** (``submit``): the in-service replicas (not draining, not
  dead), healthy tier first, then least-loaded (``serving/policy.py``).
  A ``degraded`` replica gets work only when no ``ok`` one can take it; a
  ``draining`` one gets none.  A replica whose bounded queue sheds is
  skipped for the next (``fleet_rerouted``); only when every candidate
  sheds does the fleet shed (``fleet_shed``).
- **The fleet-edge deadline shed**: a deadline below every candidate's
  p99 chunk is answered ``Dropped(reason="deadline_shed",
  where="fleet")`` before it queues anywhere.
- **Supervised restarts**: an engine whose ladder is exhausted raises
  ``ServingUnrecoverable`` (the in-process exit 124); the router restarts
  the replica (a fresh engine, warmed, loading no kernel library) and
  re-queues its residents onto the replicas in service.  A re-queued
  request keeps its arrival clock and deadline, and decodes again from
  step 0 to the same caption (K2 computes each row on its own, so the
  bits do not depend on the slot or the bucket).  ``kill_replica`` is
  the drill's hard kill, the same path counted apart.  A replica past
  ``restart_limit`` is removed (``dead``); with none left,
  :class:`FleetUnrecoverable` is the fleet front end's exit 124.
- **Rotation** (``rotate``): a replica drains (no new work, its queue
  moved now, its residents finish), then is rebuilt warm and returns.
- **One result cache** shared by every replica (``serving/cache.py``).
- **Health snapshots**: after every step the router refreshes a
  per-replica table under ``named_lock("serving.fleet.health")``;
  ``health()`` renders the worst-of view from it, safe to call from the
  watchdog's thread without touching an engine.
- **Streams across a restart**: per-request watermarks
  (``_stream_sent`` / ``_stream_cur``) filter the tokens a re-decode
  derives again, so a client never sees a token twice and the chunks
  still concatenate to the caption.

Devices: ``devices`` (``torch.device`` objects) are assigned round-robin;
every engine call runs under ``torch.cuda.device(dev)`` for a CUDA
device.  On one card every replica shares it (and its stream).  A replica
never moves to the CPU on its own.

Threading: the router is single-owner like the engine (the server's
scheduler loop); only the snapshot table is shared, under the declared
``serving.fleet.health`` lock, a leaf towards the registry.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.locksan import declare_order, named_lock
from .engine import (Completion, Dropped, Request, ServingEngine,
                     ServingUnrecoverable, StreamChunk)
from .policy import deadline_unmeetable, rank_key, worst_status

log = logging.getLogger(__name__)

#: Fleet-level counters, declared at 0 in the registry (the reference's).
FLEET_COUNTERS = ("fleet_routed", "fleet_rerouted", "fleet_shed",
                  "fleet_replica_restarts", "fleet_replica_kills")

#: Declared acquisition order (``utils/locksan.py``): the snapshot lock
#: may be held while the registry's lock is taken, never the reverse.
LOCK_ORDER = ("serving.fleet.health", "telemetry.registry")
declare_order(*LOCK_ORDER)

class FleetUnrecoverable(RuntimeError):
    """Every replica is out of service and the restart budget is spent.
    The fleet front end exits ``exitcodes.EXIT_WEDGE`` (124), as a lone
    engine's :class:`ServingUnrecoverable` does."""


class Replica:
    """One supervised engine replica: the engine and its bookkeeping
    (draining flag, restart and kill counts, completions across engine
    generations).  ``device`` (a ``torch.device``, optional) runs every
    engine call under ``torch.cuda.device`` when it is a CUDA device."""

    def __init__(self, index: int, factory: Callable[[int], ServingEngine],
                 device=None):
        self.index = int(index)
        self.device = device
        self._factory = factory
        self.engine: Optional[ServingEngine] = None
        self.draining = False
        self.dead = False
        self.restarts = 0
        self.kills = 0
        #: Completions harvested by engines this replica has since
        #: retired (restart/rotation) — per-replica lifetime totals.
        self.completed_prior = 0
        #: Decode steps and their seconds, likewise (the launch checks
        #: count K2's launches against every executed step).
        self.steps_prior = 0
        self.decode_ms_prior = 0.0

    def on_device(self):
        if self.device is None or self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(self.device)

    def start(self, warm: bool = False) -> None:
        with self.on_device():
            self.engine = self._factory(self.index)
            if warm:
                self.engine.warm()

    @property
    def in_service(self) -> bool:
        return self.engine is not None and not self.draining \
            and not self.dead

    def completed_total(self) -> int:
        live = (self.engine.health()["completed"]
                if self.engine is not None else 0)
        return self.completed_prior + live

    def decode_totals(self) -> Tuple[int, float]:
        """(decode steps, their milliseconds) over every engine
        generation of this replica."""
        steps, ms = self.steps_prior, self.decode_ms_prior
        if self.engine is not None:
            st = self.engine.stats()
            steps += st["decode_steps"]
            ms += (st["decode_ms_per_step"] or 0.0) * st["decode_steps"]
        return steps, ms

    def retire(self) -> None:
        """Fold the live engine's totals into the replica's, before the
        engine is replaced or removed."""
        steps, ms = self.decode_totals()
        self.completed_prior = self.completed_total()
        self.steps_prior, self.decode_ms_prior = steps, ms


class FleetRouter:
    """Route requests across N supervised :class:`Replica` instances.

    ``engine_factory(replica_index) -> ServingEngine`` builds one
    replica's engine; the caller bakes the shared ``ResultCache``, the
    per-replica fault plan (``FaultPlan.for_replica``) and lifecycle view
    (``LifecycleTracer.for_replica``) into it, and the router keeps it so
    a restarted replica rebuilds the same way.  ``devices`` (a sequence
    of ``torch.device``, optional) is assigned round-robin;
    ``restart_limit`` bounds unplanned restarts per replica (rotations
    do not spend it).  All engines share one configuration (the router
    reports replica 0's as its own).  ``lifecycle`` is the base tracer:
    the router emits the intake events (received, routed, the fleet-edge
    shed and drop, killed).
    """

    def __init__(self, engine_factory: Callable[[int], ServingEngine],
                 replicas: int, *, devices: Optional[Sequence] = None,
                 restart_limit: int = 3, registry=None, lifecycle=None,
                 clock: Callable[[], float] = time.monotonic):
        n = int(replicas)
        if n < 1:
            raise ValueError(f"a fleet needs >= 1 replica, got {n}")
        devs = ([None] * n if not devices
                else [devices[k % len(devices)] for k in range(n)])
        self.restart_limit = max(0, int(restart_limit))
        self._registry = registry
        self._lifecycle = lifecycle
        self.clock = clock
        # Scheduler-owned state (the module docstring's contract).
        self._replicas: List[Replica] = [  # cstlint-torch: owned_by=scheduler
            Replica(k, engine_factory, devs[k]) for k in range(n)]
        self._dropped: List[Dropped] = []  # cstlint-torch: owned_by=scheduler
        self._stream_chunks: List[StreamChunk] = []  # cstlint-torch: owned_by=scheduler
        self._evac_done: List[Completion] = []  # cstlint-torch: owned_by=scheduler
        # Fleet stream watermarks: tokens already SENT per request vs
        # tokens emitted by the request's CURRENT owning engine.
        self._stream_sent: Dict[Any, int] = {}  # cstlint-torch: owned_by=scheduler
        self._stream_cur: Dict[Any, int] = {}  # cstlint-torch: owned_by=scheduler
        self._stream_seq: Dict[Any, int] = {}  # cstlint-torch: owned_by=scheduler
        self._routed = 0
        self._rerouted = 0
        self._fleet_shed = 0
        self._restarts = 0
        self._kills = 0
        self._health_lock = named_lock("serving.fleet.health")
        self._snapshots: List[Dict[str, Any]] = []  # cstlint-torch: guarded_by=self._health_lock
        if registry is not None:
            registry.declare(*FLEET_COUNTERS)
        for rep in self._replicas:
            rep.start()
        first = self._replicas[0].engine
        # The fleet's configuration (shared by construction; the server's
        # stream warning and the fleet-edge shed read these).
        self.chunk = first.chunk
        self.max_len = first.max_len
        self.beam_size = first.beam_size
        self.buckets = first.buckets
        self.deadline_ms = first.deadline_ms
        self._update_snapshots()

    # -- routing -----------------------------------------------------------

    def _candidates(self) -> List[Replica]:
        """In-service replicas, healthy tier first, least-loaded within
        a tier (queue + residents), index as the deterministic tiebreak."""
        active = [r for r in self._replicas if r.in_service]

        def key(rep: Replica):
            # Cheap reads, not engine.health(): this runs once per
            # routed request.
            eng = rep.engine
            return rank_key(eng.degraded(),
                            eng.queue_depth + eng.resident_count,
                            rep.index)

        return sorted(active, key=key)

    def submit(self, request_id, feats, meta: Optional[dict] = None,
               deadline_ms: Optional[float] = None, stream: bool = False,
               no_cache: bool = False) -> bool:
        """Route one request.  True = accepted somewhere (or answered at
        the fleet edge via a drop record); False = every candidate's
        bounded queue shed it — the fleet-wide backpressure signal."""
        if self._lifecycle is not None:
            # The router is the fleet's intake: the replicas' views drop
            # received and shed, so one request is one "received".
            self._lifecycle.emit("received", request_id)
        cands = self._candidates()
        if not cands:
            if any(r.in_service or r.draining for r in self._replicas):
                # No routable replica for now (the last live one is
                # rotating): shed, the client's retry signal; the
                # rotation finishes and service resumes.
                self._fleet_shed += 1
                self._inc("fleet_shed")
                if self._lifecycle is not None:
                    self._lifecycle.emit("shed", request_id,
                                         where="fleet")
                return False
            raise FleetUnrecoverable(
                "every replica is dead (per-replica restart budget "
                f"{self.restart_limit} exhausted fleet-wide)")
        # A fresh submission is a fresh stream: a reused id is never
        # filtered against a watermark its previous request left.
        self._stream_forget(request_id)
        ttl = (self.deadline_ms if deadline_ms is None
               else float(deadline_ms))
        if ttl and ttl > 0:
            if deadline_unmeetable(
                    ttl, (rep.engine.min_service_s() for rep in cands)):
                # Unmeetable everywhere: answered at the edge.
                self._fleet_shed += 1
                self._inc("fleet_shed")
                self._dropped.append(Dropped(request_id, "deadline_shed",
                                             "fleet", meta=meta))
                if self._lifecycle is not None:
                    self._lifecycle.emit("dropped", request_id,
                                         reason="deadline_shed",
                                         where="fleet")
                return True
        for i, rep in enumerate(cands):
            with rep.on_device():
                ok = rep.engine.submit(request_id, feats, meta=meta,
                                       deadline_ms=deadline_ms,
                                       stream=stream, no_cache=no_cache)
            if ok:
                self._routed += 1
                self._inc("fleet_routed")
                if i:
                    self._rerouted += 1
                    self._inc("fleet_rerouted")
                if self._lifecycle is not None:
                    self._lifecycle.emit("routed", request_id,
                                         replica=rep.index,
                                         candidate=i)
                return True
        self._fleet_shed += 1
        self._inc("fleet_shed")
        if self._lifecycle is not None:
            self._lifecycle.emit("shed", request_id, where="fleet")
        return False

    # -- lifecycle ---------------------------------------------------------

    def kill_replica(self, index: int) -> None:
        """Hard replica kill (the drill's stand-in for a replica dying
        with exit 124): evacuate and re-queue everything it owes, then
        restart it warm."""
        rep = self._replicas[int(index)]
        if rep.engine is None:
            return
        rep.kills += 1
        self._kills += 1
        self._inc("fleet_replica_kills")
        log.warning("fleet: hard kill of replica %d (%d resident, "
                    "%d queued)", rep.index, rep.engine.resident_count,
                    rep.engine.queue_depth)
        self._restart_replica(rep)

    def rotate(self, index: int) -> None:
        """Begin draining replica ``index`` for a rolling rebuild: no new
        work goes to it, its queued requests move to live replicas now,
        its residents finish over the next steps, then ``step`` rebuilds
        the engine warm (loading no kernel library) and returns the
        replica to service."""
        rep = self._replicas[int(index)]
        if rep.engine is None or rep.dead:
            raise ValueError(f"replica {index} is not serving")
        if rep.draining:
            return
        rep.draining = True
        done, queued = rep.engine.evacuate(include_residents=False)
        self._evac_done.extend(done)
        self._requeue(queued)
        log.info("fleet: rotating replica %d (%d resident(s) draining, "
                 "%d queued moved)", rep.index,
                 rep.engine.resident_count, len(queued))
        self._update_snapshots()

    def _restart_replica(self, rep: Replica) -> None:
        """The supervised-restart path shared by the hard kill and the
        in-process 124 (:class:`ServingUnrecoverable`): evacuate, count,
        rebuild warm (or mark dead past the budget), re-queue."""
        rep.restarts += 1                # budget spend (attempts)
        rep.retire()
        self._collect(rep)               # drops/chunks it already owed
        done, reqs = rep.engine.evacuate()
        if self._lifecycle is not None:
            # The kill opens each evacuated request's "requeue" window.
            for req in reqs:
                self._lifecycle.emit("killed", req.request_id,
                                     replica=rep.index)
        self._evac_done.extend(done)
        # A dead replica is not draining: a stale flag would keep the
        # all-dead check below (and ``idle``) from ever firing.
        rep.draining = False
        if rep.restarts > self.restart_limit:
            rep.dead = True
            rep.engine = None
            log.error("fleet: replica %d exhausted its restart budget "
                      "(%d) and is removed from service", rep.index,
                      self.restart_limit)
        else:
            # Counted where a restart happens: the branch above removes
            # the replica and restarts nothing.
            self._restarts += 1
            self._inc("fleet_replica_restarts")
            rep.start(warm=True)
            log.warning("fleet: replica %d restarted (restart %d/%d); "
                        "re-queuing %d request(s)", rep.index,
                        rep.restarts, self.restart_limit, len(reqs))
        self._requeue(reqs)
        self._update_snapshots()
        if not any(r.in_service or r.draining for r in self._replicas):
            raise FleetUnrecoverable(
                "every replica is dead (per-replica restart budget "
                f"{self.restart_limit} exhausted)")

    def _requeue(self, reqs: List[Request]) -> None:
        """Re-route evacuated requests.  Each placed one counts as
        rerouted; one no candidate accepts is ANSWERED as a fleet-level
        drop — a request may die with its replica's answer, never
        silently."""
        for req in reqs:
            # The new owner re-decodes from step 0; its re-derived
            # stream tokens must fall inside the fleet watermark.
            self._stream_cur[req.request_id] = 0
            placed = False
            for rep in self._candidates():
                with rep.on_device():
                    if rep.engine.requeue(req):
                        placed = True
                        break
            if placed:
                self._rerouted += 1
                self._inc("fleet_rerouted")
                continue
            self._stream_forget(req.request_id)   # terminal answer
            self._dropped.append(Dropped(req.request_id, "admit_failed",
                                         "fleet", meta=req.meta))
            if self._lifecycle is not None:
                self._lifecycle.emit("dropped", req.request_id,
                                     reason="admit_failed", where="fleet")

    def _finish_rotation(self, rep: Replica) -> None:
        """The drained replica's warm rebuild, back in service."""
        self._restarts += 1
        self._inc("fleet_replica_restarts")
        rep.retire()
        self._collect(rep)
        rep.start(warm=True)
        rep.draining = False
        log.info("fleet: replica %d rotation complete — rebuilt warm and "
                 "back in service", rep.index)

    # -- scheduling --------------------------------------------------------

    def step(self) -> List[Completion]:
        """One fleet scheduler step: step every replica that has work
        (catching a replica's in-process 124 and restarting it in
        place), finish any rotation whose residents drained, collect
        drops and stream chunks.  Completions evacuated from killed
        replicas (cache hits) are returned first."""
        done: List[Completion] = list(self._evac_done)
        self._evac_done.clear()
        for rep in self._replicas:
            if rep.engine is None:
                continue
            if rep.engine.idle:
                if rep.draining:
                    self._finish_rotation(rep)
                continue
            try:
                with rep.on_device():
                    comps = rep.engine.step()
            except ServingUnrecoverable as e:
                log.error("fleet: replica %d unrecoverable (%s) — "
                          "supervised restart", rep.index, e)
                self._restart_replica(rep)
                done.extend(self._evac_done)
                self._evac_done.clear()
                continue
            done.extend(comps)
            self._collect(rep)
        for comp in done:
            self._stream_forget(comp.request_id)
        self._update_snapshots()
        return done

    def _collect(self, rep: Replica) -> None:
        if rep.engine is None:
            return
        drops = rep.engine.pop_dropped()
        for d in drops:
            # A drop is a TERMINAL answer: release the stream watermark
            # (long-running fleets must not leak an entry per dropped
            # streamed request).
            self._stream_forget(d.request_id)
        self._dropped.extend(drops)
        for ch in rep.engine.pop_stream_chunks():
            out = self._stream_filter(ch)
            if out is not None:
                self._stream_chunks.append(out)

    # -- streaming continuity ----------------------------------------------

    def _stream_filter(self, ch: StreamChunk) -> Optional[StreamChunk]:
        """Fleet-level prefix discipline: only the tokens beyond the
        fleet watermark reach the client, re-sequenced fleet-side — so a
        restart's replayed tokens are filtered and the concatenation of
        a request's chunks still equals its final caption bit for bit."""
        rid = ch.request_id
        sent = self._stream_sent.get(rid, 0)
        cur = self._stream_cur.get(rid, 0) + len(ch.tokens)
        self._stream_cur[rid] = cur
        if cur <= sent:
            return None
        fresh = np.asarray(ch.tokens, np.int32)
        if cur - sent < len(fresh):
            fresh = fresh[len(fresh) - (cur - sent):]
        self._stream_sent[rid] = cur
        seq = self._stream_seq.get(rid, 0)
        self._stream_seq[rid] = seq + 1
        return StreamChunk(rid, seq, fresh, meta=ch.meta)

    def _stream_forget(self, rid) -> None:
        self._stream_sent.pop(rid, None)
        self._stream_cur.pop(rid, None)
        self._stream_seq.pop(rid, None)

    # -- the engine scheduler surface --------------------------------------

    def pop_dropped(self) -> List[Dropped]:
        out, self._dropped = self._dropped, []
        return out

    def pop_stream_chunks(self) -> List[StreamChunk]:
        out, self._stream_chunks = self._stream_chunks, []
        return out

    @property
    def idle(self) -> bool:
        # A pending rotation keeps the fleet non-idle: the next step()
        # finishes it (rebuild + return to service), so step-driven
        # loops (run_until_idle, the server's scheduler) can never
        # stall a replica in ``draining`` forever.
        return (not self._dropped and not self._stream_chunks
                and not self._evac_done
                and not any(r.draining for r in self._replicas)
                and all(r.engine is None or r.engine.idle
                        for r in self._replicas))

    @property
    def resident_count(self) -> int:
        return sum(r.engine.resident_count for r in self._replicas
                   if r.engine is not None)

    @property
    def queue_depth(self) -> int:
        return sum(r.engine.queue_depth for r in self._replicas
                   if r.engine is not None)

    def resident_requests(self) -> List[Request]:
        out: List[Request] = []
        for rep in self._replicas:
            if rep.engine is not None:
                out.extend(rep.engine.resident_requests())
        return out

    def drain(self, abort: Optional[Callable[[], bool]] = None
              ) -> Tuple[List[Completion], List[Request]]:
        """Fleet-wide graceful shutdown: drain every replica (reject its
        queue, finish its residents), same contract as the engine."""
        done: List[Completion] = list(self._evac_done)
        self._evac_done.clear()
        rejected: List[Request] = []
        for rep in self._replicas:
            if rep.engine is None:
                continue
            with rep.on_device():
                d, r = rep.engine.drain(abort=abort)
            done.extend(d)
            rejected.extend(r)
            self._collect(rep)
        self._update_snapshots()
        return done, rejected

    def run_until_idle(self) -> List[Completion]:
        done: List[Completion] = []
        while not self.idle:
            done.extend(self.step())
        return done

    def warm(self) -> Dict[str, Any]:
        """Warm every replica (the first loads the kernel library, the
        rest load nothing) -> ``stats()`` plus ``compiles``, the
        kernel-library builds and loads of the warm-up."""
        compiles = 0
        for rep in self._replicas:
            if rep.engine is not None:
                with rep.on_device():
                    compiles += rep.engine.warm()["compiles"]
        self._update_snapshots()
        return {**self.stats(), "compiles": compiles}

    # -- stats / health ----------------------------------------------------

    def _engines(self) -> List[ServingEngine]:
        return [r.engine for r in self._replicas if r.engine is not None]

    def fleet_counters(self) -> Dict[str, int]:
        """The router's counters: the one dict that stats, health and
        the bench probe render."""
        return {
            "fleet_routed": self._routed,
            "fleet_rerouted": self._rerouted,
            "fleet_shed": self._fleet_shed,
            "fleet_replica_restarts": self._restarts,
            "fleet_replica_kills": self._kills,
        }

    def recovery_counters(self) -> Dict[str, int]:
        """Replica recovery counters summed over the live engines (a
        restarted engine starts at 0; the fleet counters carry the
        restarts)."""
        out: Dict[str, int] = {}
        for eng in self._engines():
            for k, v in eng.recovery_counters().items():
                out[k] = out.get(k, 0) + v
        return out

    def cache_counters(self) -> Dict[str, Any]:
        engines = self._engines()
        out: Dict[str, Any] = {"cache_armed": False, "cache_hits": 0,
                               "cache_misses": 0, "cache_evictions": 0,
                               "cache_bypass": 0, "cache_errors": 0,
                               "cache_entries": 0, "cache_capacity": 0}
        for eng in engines:
            c = eng.cache_counters()
            out["cache_armed"] = out["cache_armed"] or c["cache_armed"]
            for k in ("cache_hits", "cache_misses", "cache_evictions",
                      "cache_bypass", "cache_errors"):
                out[k] += c[k]
            # One shared cache: entries and capacity are not summed.
            if c["cache_armed"]:
                out["cache_entries"] = c["cache_entries"]
                out["cache_capacity"] = c["cache_capacity"]
        return out

    def stream_stats(self) -> Dict[str, Any]:
        ttft: List[float] = []
        gaps: List[float] = []
        chunks = 0
        for eng in self._engines():
            t, g = eng.stream_windows_s()
            ttft.extend(t)
            gaps.extend(g)
            chunks += eng.stream_stats()["stream_chunks"]
        t_ms = np.asarray(ttft, np.float64) * 1e3
        g_ms = np.asarray(gaps, np.float64) * 1e3
        p = (lambda a, q: round(float(np.percentile(a, q)), 3)
             if a.size else None)
        return {
            "stream_chunks": chunks,
            "ttft_p50_ms": p(t_ms, 50),
            "ttft_p99_ms": p(t_ms, 99),
            "chunk_gap_p50_ms": p(g_ms, 50),
            "chunk_gap_p99_ms": p(g_ms, 99),
        }

    def stats(self) -> Dict[str, Any]:
        """The engine ``stats()`` keys aggregated fleet-wide, plus the
        ``per_replica`` rows and the fleet counters."""
        engines = self._engines()
        estats = [e.stats() for e in engines]
        totals = [r.decode_totals() for r in self._replicas]
        steps = sum(t[0] for t in totals)
        decode_ms = sum(t[1] for t in totals)
        lat = np.asarray([x for e in engines for x in e.latency_window_s()],
                         np.float64) * 1e3
        pct = (lambda q: float(np.percentile(lat, q)) if lat.size else None)
        out = {
            "replicas": len(self._replicas),
            "in_service": sum(1 for r in self._replicas if r.in_service),
            "slots": sum(s["slots"] for s in estats),
            "buckets": list(self.buckets),
            "beam_size": self.beam_size,
            "decode_chunk": self.chunk,
            "residents": self.resident_count,
            "queue_depth": self.queue_depth,
            "submitted": self._routed,
            "completed": sum(r.completed_total() for r in self._replicas),
            "shed": self._fleet_shed,
            "rejected_drain": sum(s["rejected_drain"] for s in estats),
            "chunk_dispatches": sum(s["chunk_dispatches"]
                                    for s in estats),
            # Over every engine generation (a killed engine's steps ran).
            "decode_kernel": engines[0].model.decode_kernel if engines
            else None,
            "decode_steps": steps,
            "decode_ms_per_step": decode_ms / steps if steps else None,
            "latency_p50_ms": pct(50),
            "latency_p99_ms": pct(99),
            "latency_mean_ms": float(lat.mean()) if lat.size else None,
            "fleet": self.fleet_counters(),
            "per_replica": self.per_replica(),
            **self.recovery_counters(),
            **self.cache_counters(),
            **self.stream_stats(),
        }
        if self._lifecycle is not None:
            # Attribution fleet-wide and per completing replica.
            out["attribution"] = self._lifecycle.attribution_report()
        return out

    def per_replica(self) -> List[Dict[str, Any]]:
        """Per-replica rows (the bench record), from the snapshot table
        ``health()`` renders."""
        with self._health_lock:
            return [dict(s) for s in self._snapshots]

    def _update_snapshots(self) -> None:
        snaps: List[Dict[str, Any]] = []
        for rep in self._replicas:
            if rep.engine is None:
                h: Dict[str, Any] = {"status": "dead", "queue_depth": 0,
                                     "residents": 0, "recovery": {}}
            else:
                h = rep.engine.health()
                if rep.draining:
                    h["status"] = "draining"
            h["replica"] = rep.index
            h["restarts"] = rep.restarts
            h["kills"] = rep.kills
            h["completed"] = rep.completed_total()
            snaps.append(h)
        with self._health_lock:
            self._snapshots = snaps

    def health(self) -> Dict[str, Any]:
        """Worst-of-replicas status plus the per-replica detail, from the
        snapshots: safe to call from the watchdog's thread."""
        with self._health_lock:
            per = [dict(s) for s in self._snapshots]
        status = worst_status(s["status"] for s in per)  # dead -> degraded
        return {
            "status": status,
            "replicas": len(per),
            "in_service": sum(1 for s in per
                              if s["status"] in ("ok", "degraded")),
            "queue_depth": sum(s["queue_depth"] for s in per),
            "residents": sum(s["residents"] for s in per),
            "completed": sum(s["completed"] for s in per),
            "fleet": self.fleet_counters(),
            "per_replica": per,
        }

    # -- telemetry ---------------------------------------------------------

    def _inc(self, name: str, n: float = 1) -> None:
        if self._registry is not None:
            self._registry.inc(name, n)
