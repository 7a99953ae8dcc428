"""The port's fleet router against the reference's (``serving/fleet.py``).

Each twin is one reference ``FleetRouter`` over reference engines (the
Pallas decode cell, interpreted on the CPU) and one port ``FleetRouter``
over port engines (K2's plain version on the CPU), on the same weights
(``model_from_flax``), given the same requests, fault plans, kills,
rotations and fake-clock ticks.  Their completions, drops, stream chunks,
fleet and recovery counters must be equal, and the captions must equal a
clean single engine's.  Every test runs with the lock sanitizer armed in
both packages; a lock-order violation fails it.  Then the port's own
parts: the server's health source, the heartbeat, and ``python -m
cst_captioning_tpu_torch.serve_fleet`` on the CPU.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.resilience.faults import FaultPlan as RefFaultPlan
from cst_captioning_tpu.serving import fleet as ref_fleet
from cst_captioning_tpu.serving.buckets import ProgramCache
from cst_captioning_tpu.serving.cache import ResultCache as RefResultCache
from cst_captioning_tpu.serving.engine import ServingEngine as JaxEngine
from cst_captioning_tpu.telemetry.lifecycle import \
    LifecycleTracer as RefLifecycle
from cst_captioning_tpu.telemetry.registry import \
    MetricsRegistry as RefRegistry
from cst_captioning_tpu.utils import locksan as ref_locksan
from cst_captioning_tpu_torch.ops import _cuda
from cst_captioning_tpu_torch.resilience.exitcodes import EXIT_OK, EXIT_WEDGE
from cst_captioning_tpu_torch.resilience.faults import ANY_INDEX, FaultPlan
from cst_captioning_tpu_torch.serving import fleet
from cst_captioning_tpu_torch.serving.cache import ResultCache
from cst_captioning_tpu_torch.serving.engine import (COUNTERS, Dropped,
                                                     ServingEngine,
                                                     _trim_eos)
from cst_captioning_tpu_torch.serving.fleet import (FLEET_COUNTERS,
                                                    FleetRouter,
                                                    FleetUnrecoverable)
from cst_captioning_tpu_torch.serving.server import CaptionServer
from cst_captioning_tpu_torch.telemetry.lifecycle import LifecycleTracer
from cst_captioning_tpu_torch.telemetry.registry import MetricsRegistry
from cst_captioning_tpu_torch.utils import locksan
from cst_captioning_tpu_torch.utils.watchdog import ProgressWatchdog
from cst_captioning_tpu_torch.weights import model_from_flax

N, H, E, A, V, MAX_LEN, CHUNK = 9, 16, 12, 16, 30, 8, 2
FEAT_SHAPES = ((4, 8), (1, 5))
BUCKETS = (1, 2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _lock_sanitizer(monkeypatch, tmp_path):
    """Both packages' sanitizers armed for the objects each test builds;
    a violation (or a receipt) fails the test."""
    receipt = tmp_path / "locksan_violation.json"
    monkeypatch.setenv(locksan.ENV_FLAG, "1")
    monkeypatch.setenv(locksan.ENV_RECEIPT, str(receipt))
    before = (len(locksan.violations()), len(ref_locksan.violations()))
    yield
    assert (len(locksan.violations()), len(ref_locksan.violations())) \
        == before, (locksan.violations(), ref_locksan.violations())
    assert not receipt.exists(), receipt.read_text()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class World:
    """The reference model and variables, the port's model on the same
    weights, ``N`` seeded videos."""

    def __init__(self, jm, params, eos_bias, seed):
        params = {**params, "logit": {**params["logit"]}}
        params["logit"]["bias"] = params["logit"]["bias"].copy()
        params["logit"]["bias"][0] += eos_bias
        self.jm = jm
        self.variables = {"params": params}
        self.model = model_from_flax(params, device="cpu",
                                     decode_kernel="fused")
        rng = np.random.default_rng(seed)
        self.feats = [(rng.normal(size=(N,) + s) * 2.0).astype(np.float32)
                      for s in FEAT_SHAPES]

    def video(self, i):
        return [f[i % N] for f in self.feats]

    def single_engine(self, ids):
        """A clean port engine's captions of the videos ``ids``."""
        eng = ServingEngine(self.model, FEAT_SHAPES, max_len=MAX_LEN,
                            decode_chunk=CHUNK, bucket_sizes=BUCKETS,
                            queue_limit=0)
        for i in ids:
            eng.submit(i, self.video(i))
        return {c.request_id: c.tokens.tolist()
                for c in eng.run_until_idle()}


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(5)
    feats = [jnp.asarray(rng.normal(size=(N,) + s).astype(np.float32))
             for s in FEAT_SHAPES]
    jm = JaxCaptionModel(vocab_size=V, embed_size=E, hidden_size=H,
                         attn_size=A, dropout_rate=0.0,
                         decode_kernel="pallas")
    variables = jm.init(jax.random.PRNGKey(0), feats,
                        np.zeros((N, MAX_LEN), np.int32))
    return jm, jax.tree_util.tree_map(np.asarray, variables["params"])


@pytest.fixture(scope="module")
def world(params):
    """Captions of mixed lengths, most longer than one chunk, so
    residents are in flight when a replica dies."""
    w = World(*params, eos_bias=-0.5, seed=1)
    lengths = [len(_trim_eos(np.asarray(t)))
               for t in w.single_engine(range(N)).values()]
    assert sum(n > CHUNK for n in lengths) >= N - 2, lengths
    return w


@pytest.fixture(scope="module")
def programs():
    """One reference ProgramCache for the module: every reference twin
    has the same configuration, so its programs compile once."""
    return ProgramCache()


class Twin:
    """A reference fleet and a port fleet driven in lockstep."""

    def __init__(self, w: World, programs, replicas=2, *, plan=None,
                 cache=False, lifecycle=False, restart_limit=3,
                 deadline_ms=0.0, recover=True, retry_limit=2,
                 rebuild_limit=2, queue_limit=0):
        self.w = w
        self.clocks = [FakeClock(), FakeClock()]
        self.registries = [RefRegistry(), MetricsRegistry()]
        self.plans = [None, None]
        if plan is not None:
            self.plans = [RefFaultPlan.parse(plan), FaultPlan.parse(plan)]
            for p, reg in zip(self.plans, self.registries):
                p.bind_metrics(reg)
        self.lifecycles = [None, None]
        if lifecycle:
            self.lifecycles = [RefLifecycle(clock=self.clocks[0]),
                               LifecycleTracer(clock=self.clocks[1])]
        caches = ((RefResultCache(16), ResultCache(16)) if cache
                  else (None, None))
        common = dict(max_len=MAX_LEN, decode_chunk=CHUNK,
                      bucket_sizes=BUCKETS, queue_limit=queue_limit,
                      deadline_ms=deadline_ms, recover=recover,
                      retry_limit=retry_limit, rebuild_limit=rebuild_limit)

        def factory(side):
            plan_, lc, clock = (self.plans[side], self.lifecycles[side],
                                self.clocks[side])

            def make(k):
                kw = dict(common, result_cache=caches[side],
                          registry=self.registries[side], clock=clock,
                          fault_plan=(plan_.for_replica(k)
                                      if plan_ is not None else None),
                          lifecycle=(lc.for_replica(k) if lc is not None
                                     else None))
                if side == 0:
                    return JaxEngine(w.jm, w.variables, list(FEAT_SHAPES),
                                     program_cache=programs, **kw)
                return ServingEngine(w.model, FEAT_SHAPES, **kw)

            return make

        self.fleets = [
            ref_fleet.FleetRouter(factory(0), replicas,
                                  restart_limit=restart_limit,
                                  registry=self.registries[0],
                                  lifecycle=self.lifecycles[0],
                                  clock=self.clocks[0]),
            FleetRouter(factory(1), replicas, restart_limit=restart_limit,
                        registry=self.registries[1],
                        lifecycle=self.lifecycles[1], clock=self.clocks[1])]
        for f in self.fleets:
            f.warm()
        self.done = [[], []]
        self.drops = [[], []]
        self.chunks = [[], []]
        #: The shed floor every live engine reads (fixed, not wall times).
        self.floor_window = []

    @property
    def port(self) -> FleetRouter:
        return self.fleets[1]

    def both(self, fn):
        """``fn(side, fleet)`` on both; the results must be equal."""
        out = [fn(k, f) for k, f in enumerate(self.fleets)]
        assert out[0] == out[1], out
        return out[1]

    def _floor(self):
        for f in self.fleets:
            for rep in f._replicas:
                if rep.engine is not None:
                    rep.engine._chunk_wall.clear()
                    rep.engine._chunk_wall.extend(self.floor_window)

    def submit(self, i, video=None, **kw):
        self._floor()
        return self.both(lambda k, f: f.submit(
            i, self.w.video(i if video is None else video), **kw))

    def _collect(self, k, comps):
        f = self.fleets[k]
        self.done[k] += [(c.request_id, np.asarray(c.tokens).tolist(),
                          c.slot, c.latency_s, c.decode_steps, c.cache_hit,
                          c.stream_chunks) for c in comps]
        self.drops[k] += [(d.request_id, d.reason, d.where)
                          for d in f.pop_dropped()]
        self.chunks[k] += [(c.request_id, c.seq,
                            np.asarray(c.tokens).tolist())
                           for c in f.pop_stream_chunks()]

    def step(self):
        self._floor()
        for k, f in enumerate(self.fleets):
            self._collect(k, f.step())

    def tick(self, dt):
        for c in self.clocks:
            c.t += dt

    def run(self, dt=0.0):
        while not all(f.idle for f in self.fleets):
            self.step()
            self.tick(dt)

    def kill(self, index):
        for f in self.fleets:
            f.kill_replica(index)

    def check(self):
        """Completions, drops, chunks, fleet, recovery and registry
        counters equal -> {request id: tokens}."""
        assert self.done[1] == self.done[0]
        assert self.drops[1] == self.drops[0]
        assert self.chunks[1] == self.chunks[0]
        rf, pf = self.fleets
        assert pf.fleet_counters() == rf.fleet_counters()
        assert pf.recovery_counters() == rf.recovery_counters()
        ref, port = (r.snapshot()["counters"] for r in self.registries)
        names = [n for n in ref if n in COUNTERS or n in FLEET_COUNTERS
                 or n.startswith("fault_")]
        assert {n: port.get(n) for n in names} == {n: ref[n] for n in names}
        rows = [[{k: s[k] for k in ("replica", "status", "completed",
                                    "restarts", "kills", "queue_depth",
                                    "residents")}
                 for s in f.per_replica()] for f in self.fleets]
        assert rows[1] == rows[0]
        return {c[0]: c[1] for c in self.done[1]}


# -- the @replica=K axis ------------------------------------------------------


def test_replica_axis_parses_and_derives_as_the_reference():
    text = "serve_wedge@replica=1,serve_garble@req=2"
    plan, ref = FaultPlan.parse(text), RefFaultPlan.parse(text)
    assert str(plan) == str(ref) and "serve_wedge@replica=1" in str(plan)
    assert plan.fire("serve_wedge", 0) == ref.fire("serve_wedge", 0) is False
    assert plan.fire("serve_garble", 2) == ref.fire("serve_garble", 2)
    d1, r1 = plan.for_replica(1), ref.for_replica(1)
    assert d1.specs[0].at == r1.specs[0].at == ANY_INDEX
    assert str(d1) == str(r1)
    # Fires at the first probed index, once.
    assert d1.fire("serve_wedge", 7) and r1.fire("serve_wedge", 7)
    assert not d1.fire("serve_wedge", 8) and not r1.fire("serve_wedge", 8)
    assert d1.pending("serve_wedge") == r1.pending("serve_wedge") == 0
    assert plan.for_replica(0) is None and ref.for_replica(0) is None
    # Memoized: a restarted replica gets the same, spent plan.
    assert plan.for_replica(1) is d1
    for bad in ("nan_grad@replica=0", "serve_wedge@replica=0*2"):
        for parse in (FaultPlan.parse, RefFaultPlan.parse):
            with pytest.raises(ValueError):
                parse(bad)
    # proc_* kinds have no engine site: never materialized.
    assert FaultPlan.parse("proc_kill@replica=0").for_replica(0) is None


def test_policy_equals_the_references():
    from cst_captioning_tpu.serving import policy as ref_policy
    from cst_captioning_tpu_torch.serving import policy

    assert policy.STATUS_RANK == ref_policy.STATUS_RANK
    for case in ([], ["ok"], ["ok", "degraded"], ["dead", "ok"],
                 ["draining", "degraded", "ok"], ["restarting"]):
        assert policy.worst_status(case) == ref_policy.worst_status(case)
    for args in ((10.0, [0.05, 0.02]), (10.0, [None, 0.05]), (1.0, []),
                 (60.0, [0.05, 0.02]), (30.0, [0.02], 2.0)):
        assert policy.deadline_unmeetable(*args) == \
            ref_policy.deadline_unmeetable(*args)
    assert policy.rank_key(True, 3, 1) == ref_policy.rank_key(True, 3, 1)
    pacers = [policy.QueryPacer(1.0, 4), ref_policy.QueryPacer(1.0, 4)]
    for now, op in ((0.0, "sent"), (0.5, None), (1.0, "failed"),
                    (1.5, "sent"), (2.0, None), (3.6, "ok"), (3.6, None)):
        got = [p.due("k", now) for p in pacers]
        assert got[0] == got[1], (now, got)
        for p in pacers:
            if op == "sent":
                p.sent("k", now)
            elif op is not None:
                getattr(p, op)("k")


# -- routing ------------------------------------------------------------------


def test_spread_and_counters(world, programs):
    twin = Twin(world, programs, 2)
    for i in range(6):
        assert twin.submit(i)
    twin.run(dt=0.25)
    got = twin.check()
    assert sorted(got) == list(range(6))
    st = twin.port.stats()
    assert st["fleet"]["fleet_routed"] == 6
    assert twin.registries[1].counter("fleet_routed") == 6
    assert all(p["completed"] > 0 for p in st["per_replica"])
    snap = twin.registries[1].snapshot()["counters"]
    assert set(FLEET_COUNTERS) <= set(snap)
    assert fleet.FLEET_COUNTERS == ref_fleet.FLEET_COUNTERS
    assert fleet.LOCK_ORDER == ref_fleet.LOCK_ORDER


def test_captions_bit_identical_to_one_engine(world, programs):
    twin = Twin(world, programs, 3)
    for i in range(N):
        assert twin.submit(i)
    twin.run(dt=0.1)
    got = twin.check()
    assert got == world.single_engine(range(N))
    st = twin.port.stats()
    assert st["decode_steps"] == st["chunk_dispatches"] * CHUNK


def test_route_around_degraded(world, programs):
    twin = Twin(world, programs, 2)
    for f in twin.fleets:
        f._replicas[0].engine._note_recovery_event()
    for i in range(3):
        assert twin.submit(i)
    eng0, eng1 = (r.engine for r in twin.port._replicas)
    assert eng0.queue_depth + eng0.resident_count == 0
    assert eng1.queue_depth + eng1.resident_count == 3
    for f in twin.fleets:
        f._update_snapshots()
    assert twin.port.health()["per_replica"][0]["status"] == "degraded"
    twin.run()
    assert len(twin.check()) == 3


def test_fleet_edge_shed_where_fleet(world, programs):
    twin = Twin(world, programs, 2, deadline_ms=1.0)
    twin.floor_window = [0.05] * 8
    assert twin.submit("r1", video=0, deadline_ms=1.0)
    twin.step()
    assert twin.drops[1] == [("r1", "deadline_shed", "fleet")]
    assert twin.registries[1].counter("fleet_shed") == 1
    # An unknown floor anywhere: not provable, admitted normally.
    twin.floor_window = []
    assert twin.submit("r2", video=1, deadline_ms=1.0)
    twin.run()
    twin.check()
    out = []
    server = CaptionServer(twin.port, vocab=None, feats_for=lambda v: None)
    server._respond_dropped(Dropped("x", "deadline_shed", "fleet",
                                    meta={"id": 9, "video_id": "v",
                                          "respond": out.append}))
    server._respond_dropped(Dropped("y", "admit_failed", "fleet",
                                    meta={"id": 8, "video_id": "w",
                                          "respond": out.append}))
    shed, failed = (json.loads(x) for x in out)
    assert (shed["error"], shed["where"], shed["why"]) == \
        ("expired", "fleet", "deadline_unmeetable")
    assert (failed["error"], failed["where"]) == ("admit_failed", "fleet")


# -- kills, restarts, the budget, rotation -----------------------------------


def test_kill_requeues_bit_identical_with_no_library_event(world, programs):
    twin = Twin(world, programs, 2)
    for i in range(6):
        assert twin.submit(i)
    twin.step()
    assert twin.port._replicas[0].engine.resident_count > 0
    events0 = _cuda.library_events()
    twin.kill(0)
    twin.run(dt=0.1)
    got = twin.check()
    assert _cuda.library_events() == events0
    assert got == world.single_engine(range(6))
    st = twin.port.stats()["fleet"]
    assert (st["fleet_replica_kills"], st["fleet_replica_restarts"]) == (1, 1)
    assert st["fleet_rerouted"] >= 1
    # The killed engine's decode steps still count.
    s = twin.port.stats()
    assert s["decode_steps"] > s["chunk_dispatches"] * CHUNK


def test_unrecoverable_replica_is_restarted(world, programs):
    twin = Twin(world, programs, 2, plan="serve_wedge@replica=0",
                retry_limit=0, rebuild_limit=0)
    for i in range(4):
        assert twin.submit(i)
    twin.run(dt=0.1)
    got = twin.check()
    assert got == world.single_engine(range(4))
    st = twin.port.stats()["fleet"]
    assert (st["fleet_replica_restarts"], st["fleet_replica_kills"]) == (1, 0)
    # The derived plan survived the restart: the wedge fired once.
    assert twin.registries[1].counter("fault_serve_wedge") == 1


def test_budget_runs_out_into_fleet_unrecoverable(world, programs):
    twin = Twin(world, programs, 2, restart_limit=0)
    for i in range(2):
        assert twin.submit(i)
    twin.step()
    twin.kill(0)
    for f in twin.fleets:
        assert f.health()["per_replica"][0]["status"] == "dead"
        assert f.health()["status"] == "degraded"
    for f in twin.fleets:
        with pytest.raises((FleetUnrecoverable,
                            ref_fleet.FleetUnrecoverable)):
            f.kill_replica(1)
    twin._collect(0, [])
    twin._collect(1, [])
    twin.check()
    assert {d[0] for d in twin.drops[1]} <= {0, 1}
    assert all(d[1:] == ("admit_failed", "fleet") for d in twin.drops[1])
    assert twin.port.fleet_counters()["fleet_replica_restarts"] == 0
    assert twin.port.fleet_counters()["fleet_replica_kills"] == 2


def test_death_mid_rotation(world, programs):
    twin = Twin(world, programs, 1, restart_limit=0)
    assert twin.submit(0)
    twin.step()
    for f in twin.fleets:
        f.rotate(0)
        with pytest.raises((FleetUnrecoverable,
                            ref_fleet.FleetUnrecoverable)):
            f.kill_replica(0)
        assert not f._replicas[0].draining
    twin._collect(0, [])
    twin._collect(1, [])
    twin.check()
    assert [d[0] for d in twin.drops[1]] == [0]
    assert twin.port.idle


def test_rotation_admits_nothing_and_rebuilds_warm(world, programs):
    twin = Twin(world, programs, 2)
    for i in range(2):
        assert twin.submit(i)
    twin.step()
    for f in twin.fleets:
        f.rotate(0)
    assert twin.port.health()["status"] == "draining"
    assert twin.port.health()["per_replica"][0]["status"] == "draining"
    for i in range(2, 4):
        assert twin.submit(i)
    assert twin.port._replicas[0].engine.queue_depth == 0
    events0 = _cuda.library_events()
    twin.run(dt=0.1)
    got = twin.check()
    assert sorted(got) == list(range(4))
    assert twin.port.health()["per_replica"][0]["status"] == "ok"
    assert twin.port._replicas[0].in_service
    assert twin.registries[1].counter("fleet_replica_restarts") == 1
    assert _cuda.library_events() == events0


def test_replica_targeted_fault_hits_only_that_replica(world, programs):
    twin = Twin(world, programs, 2, plan="serve_garble@replica=1")
    for i in range(4):
        assert twin.submit(i)
    twin.run(dt=0.1)
    got = twin.check()
    rec0, rec1 = (r.engine.recovery_counters()
                  for r in twin.port._replicas)
    assert rec0["garble_detected"] == 0
    assert rec1["garble_detected"] == 1 and rec1["chunk_retries"] >= 1
    assert got == world.single_engine(range(4))


def test_acceptance_drill_all_faults_plus_a_kill(world, programs):
    twin = Twin(world, programs, 3, plan="serve_wedge@replica=0,"
                "serve_garble@replica=1,admit_err@replica=0")
    for i in range(N):
        assert twin.submit(i)
    twin.step()
    events0 = _cuda.library_events()
    twin.kill(2)
    twin.run(dt=0.1)
    got = twin.check()
    assert got == world.single_engine(range(N))
    assert twin.drops[1] == []
    assert _cuda.library_events() == events0
    reg = twin.registries[1]
    for kind in ("serve_wedge", "serve_garble", "admit_err"):
        assert reg.counter(f"fault_{kind}") == 1, kind
    rec = twin.port.recovery_counters()
    assert (rec["wedge_detected"], rec["garble_detected"],
            rec["admit_errors"]) == (1, 1, 1)
    st = twin.port.stats()["fleet"]
    assert (st["fleet_replica_kills"], st["fleet_replica_restarts"]) == (1, 1)


# -- the shared cache, streams, watermarks -----------------------------------


def test_shared_result_cache(world, programs):
    twin = Twin(world, programs, 2, cache=True)
    assert twin.submit("a", video=3)
    twin.run()
    assert twin.submit("b", video=3)
    twin.run()
    got = twin.check()
    assert got["a"] == got["b"]
    assert [c[5] for c in twin.done[1]] == [False, True]
    st = twin.port.stats()
    assert (st["cache_hits"], st["cache_misses"], st["cache_entries"]) == \
        (1, 1, 1)


def test_stream_prefix_consistent_across_a_kill(world, programs):
    twin = Twin(world, programs, 2)
    for i in range(2):
        assert twin.submit(i, stream=True)
    twin.step()
    assert twin.chunks[1], "no chunk before the kill"
    twin.kill(0)
    twin.run()
    got = twin.check()
    for rid, toks in got.items():
        mine = sorted((c for c in twin.chunks[1] if c[0] == rid),
                      key=lambda c: c[1])
        assert [c[1] for c in mine] == list(range(len(mine)))
        text = [t for c in mine for t in c[2]]
        assert text == _trim_eos(np.asarray(toks)).tolist()


def test_requeue_keeps_no_cache(world, programs):
    twin = Twin(world, programs, 2, cache=True)
    assert twin.submit("prime", video=4)
    twin.run()
    assert twin.submit("bypass", video=4, no_cache=True)
    owner = next(r.index for r in twin.port._replicas
                 if r.engine.queue_depth + r.engine.resident_count)
    twin.step()
    twin.kill(owner)
    twin.run()
    twin.check()
    comp = next(c for c in twin.done[1] if c[0] == "bypass")
    assert comp[5] is False and comp[4] > 0
    assert twin.port.stats()["cache_bypass"] >= 1


def test_watermark_forgotten_on_drop_and_id_reuse(world, programs):
    twin = Twin(world, programs, 2)
    assert twin.submit("rid", video=0, stream=True)
    twin.step()
    assert twin.chunks[1] and twin.chunks[1][0][0] == "rid"
    twin.tick(10.0)
    for f in twin.fleets:
        for rep in f._replicas:
            for res in rep.engine._residents:
                if res is not None:
                    res.request.deadline = 5.0
    twin.step()
    assert twin.drops[1] == [("rid", "expired", "resident")]
    assert "rid" not in twin.port._stream_sent
    n0 = len(twin.chunks[1])
    assert twin.submit("rid", video=0, stream=True)
    twin.run()
    twin.check()
    comp = twin.done[1][-1]
    text = [t for c in sorted(twin.chunks[1][n0:], key=lambda c: c[1])
            for t in c[2]]
    assert text == _trim_eos(np.asarray(comp[1])).tolist()


def test_submit_during_last_rotation_sheds_not_124(world, programs):
    twin = Twin(world, programs, 1)
    assert twin.submit(0)
    twin.step()
    for f in twin.fleets:
        f.rotate(0)
    assert twin.submit(1) is False
    assert twin.port.stats()["fleet"]["fleet_shed"] == 1
    twin.run()
    assert [c[0] for c in twin.done[1]] == [0]
    assert twin.port._replicas[0].in_service
    assert twin.submit(1)
    twin.run()
    twin.check()


# -- lifecycle across the fleet -----------------------------------------------


def _chains(lc):
    out = {}
    for ev in lc.events():
        out.setdefault(ev["id"], []).append(ev["kind"])
    return out


def test_kill_lifecycle_chains_equal_the_references(world, programs):
    twin = Twin(world, programs, 2, lifecycle=True)
    for i in range(6):
        assert twin.submit(i)
    twin.step()
    killed = [r.request_id for r in
              twin.port._replicas[0].engine.resident_requests()]
    assert killed
    twin.kill(0)
    twin.run(dt=0.1)
    twin.check()
    ref_lc, lc = twin.lifecycles
    assert _chains(lc) == _chains(ref_lc)
    assert lc.accounting() == ref_lc.accounting()
    assert lc.accounting()["terminal_ok"]
    rep = lc.attribution_report()
    assert rep["reconcile_ok"] and rep["requests"] == 6
    assert rep["components"]["requeue"]["p99_ms"] > 0
    for rid in killed:
        ks = _chains(lc)[rid]
        assert ks.index("killed") < ks.index("requeued") \
            < ks.index("completed")
    assert set(rep["per_replica"]) <= {"0", "1"}
    assert twin.port.stats()["attribution"]["requests"] == 6


def test_replica_wedge_lifecycle_retry_kill_requeue(world, programs):
    twin = Twin(world, programs, 2, plan="serve_wedge@replica=0",
                lifecycle=True, retry_limit=0, rebuild_limit=0)
    for i in range(4):
        assert twin.submit(i)
    twin.run(dt=0.1)
    twin.check()
    ref_lc, lc = twin.lifecycles
    chains = _chains(lc)
    assert chains == _chains(ref_lc)
    wedged = [rid for rid, ks in chains.items() if "retry" in ks]
    assert wedged
    for rid in wedged:
        ks = chains[rid]
        assert ks.index("retry") < ks.index("killed") \
            < ks.index("requeued") < ks.index("completed")
    assert lc.accounting() == ref_lc.accounting()
    assert lc.attribution_report()["reconcile_ok"]


# -- the health plane ---------------------------------------------------------


def test_server_health_source_renders_the_fleet(world, programs):
    twin = Twin(world, programs, 2)
    server = CaptionServer(twin.port, vocab=None, feats_for=lambda v: None,
                           health_source=twin.port.health)
    h = server.health_payload()
    assert h["op"] == "health" and h["status"] == "ok"
    assert h["replicas"] == 2 and len(h["per_replica"]) == 2
    assert set(h["fleet"]) == set(FLEET_COUNTERS)
    twin.port._replicas[1].engine._note_recovery_event()
    twin.port._update_snapshots()
    assert server.health_payload()["status"] == "degraded"
    server._draining = True
    assert server.health_payload()["status"] == "draining"


def test_heartbeat_carries_every_replica(world, tmp_path):
    registry = MetricsRegistry()
    router = FleetRouter(
        lambda k: ServingEngine(world.model, FEAT_SHAPES, max_len=MAX_LEN,
                                decode_chunk=CHUNK, bucket_sizes=BUCKETS,
                                registry=registry), 2, registry=registry)
    server = CaptionServer(router, vocab=None, feats_for=lambda v: None,
                           registry=registry, health_source=router.health)
    hb = tmp_path / "heartbeat.json"
    wd = ProgressWatchdog(
        0, describe=lambda: "fleet heartbeat", heartbeat_path=str(hb),
        payload=lambda: {"serving": server.published_health(),
                         **registry.heartbeat_payload()},
        heartbeat_interval_s=0.05).start()
    try:
        end = time.monotonic() + 10.0
        while not hb.exists() and time.monotonic() < end:
            time.sleep(0.02)
    finally:
        wd.stop()
    doc = json.loads(hb.read_text())
    per = doc["serving"]["per_replica"]
    assert {p["replica"] for p in per} == {0, 1}
    assert all(p["status"] == "ok" and {"restarts", "kills", "recovery"}
               <= set(p) for p in per)
    assert doc["serving"]["status"] == "ok"
    assert "fleet_routed" in doc["counters"]


# -- the CLI --------------------------------------------------------------------


def _fleet_cmd(*extra):
    return [sys.executable, "-m", "cst_captioning_tpu_torch.serve_fleet",
            "--serve_demo", "1", "--device", "cpu", "--rnn_size", "16",
            "--input_encoding_size", "16", "--att_size", "16",
            "--vocab_size", "20", "--feat_shapes", "4x16,1x8",
            "--beam_size", "1", "--serve_demo_eos_bias", "-4",
            "--serve_replicas", "2", *extra]


def _env():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop(locksan.ENV_FLAG, None)
    return env


def test_cli_fleet_under_a_replica_fault(tmp_path):
    lines = "".join(json.dumps({"id": i, "video_id": f"v{i}"}) + "\n"
                    for i in range(6)) + json.dumps({"op": "health"}) + "\n"
    clean = subprocess.run(
        [sys.executable, "-m", "cst_captioning_tpu_torch.serve"]
        + _fleet_cmd()[3:-2], input=lines, capture_output=True, text=True,
        timeout=120, cwd=REPO, env=_env())
    assert clean.returncode == EXIT_OK, clean.stderr[-2000:]
    result = tmp_path / "result.json"
    proc = subprocess.run(
        _fleet_cmd("--serve_retry_limit", "0", "--serve_rebuild_limit", "0",
                   "--fault_plan", "serve_wedge@replica=0",
                   "--result_file", str(result)),
        input=lines, capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(_env(), CST_LOCK_SANITIZER="1",
                 CST_LOCK_SANITIZER_RECEIPT=str(tmp_path / "r.json")))
    assert proc.returncode == EXIT_OK, proc.stderr[-2000:]
    out = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.strip()]
    captions = {r["id"]: r["caption"] for r in out if "caption" in r}
    want = {r["id"]: r["caption"] for r in map(json.loads,
                                               clean.stdout.splitlines())
            if "caption" in r}
    assert captions == want and len(captions) == 6
    health = [r for r in out if r.get("op") == "health"]
    assert health and health[0]["replicas"] == 2
    assert len(health[0]["per_replica"]) == 2
    stats = json.loads([ln for ln in proc.stderr.splitlines()
                        if ln.startswith("serve_fleet: {")][-1]
                       [len("serve_fleet: "):])
    assert stats["fleet"]["fleet_replica_restarts"] == 1
    assert stats["completed"] == 6 and stats["attribution"]["requests"] == 6
    doc = json.loads(result.read_text())
    assert set(doc) == {"stats", "health", "telemetry"}
    assert doc["telemetry"]["counters"]["fault_serve_wedge"] == 1
    assert not (tmp_path / "r.json").exists()


def test_cli_fleet_exits_124_with_a_blackbox_when_every_replica_is_spent(
        tmp_path):
    box = tmp_path / "blackbox.json"
    lines = "".join(json.dumps({"id": i, "video_id": f"v{i}"}) + "\n"
                    for i in range(4))
    proc = subprocess.run(
        _fleet_cmd("--serve_retry_limit", "0", "--serve_rebuild_limit", "0",
                   "--serve_restart_limit", "0", "--fault_plan",
                   "serve_wedge@replica=0,serve_wedge@replica=1",
                   "--serve_blackbox", str(box)),
        input=lines, capture_output=True, text=True, timeout=120, cwd=REPO,
        env=_env())
    assert proc.returncode == EXIT_WEDGE, proc.stderr[-2000:]
    assert "serve_fleet: UNRECOVERABLE" in proc.stderr
    doc = json.loads(box.read_text())
    assert doc["reason"] == "unrecoverable"
    assert doc["health"]["replicas"] == 2
    assert all(p["status"] == "dead" for p in doc["health"]["per_replica"])
    kinds = {e["kind"] for e in doc["events"]}
    assert {"received", "routed", "retry", "killed"} <= kinds


def test_cli_fleet_serves_a_socket(tmp_path):
    proc = subprocess.Popen(_fleet_cmd("--serve_port", "-1"),
                            stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO, env=_env())
    try:
        port = None
        for line in proc.stderr:
            if "listening on 127.0.0.1:" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port is not None
        with socket.create_connection(("127.0.0.1", port), timeout=60) as c:
            f = c.makefile("r")
            c.sendall(("".join(json.dumps({"id": i, "video_id": f"v{i}"})
                               + "\n" for i in range(4))
                       + '{"op": "health"}\n{"op": "dump", "path": "'
                       + str(tmp_path / "bb.json") + '"}\n').encode())
            got = [json.loads(f.readline()) for _ in range(6)]
        assert sorted(r["id"] for r in got if "caption" in r) == \
            [0, 1, 2, 3]
        health = next(r for r in got if r.get("op") == "health")
        assert health["replicas"] == 2
        dump = next(r for r in got if r.get("op") == "dump")
        assert dump["path"] == str(tmp_path / "bb.json")
        assert json.loads((tmp_path / "bb.json").read_text())[
            "reason"] == "wire_dump"
        proc.send_signal(15)
        assert proc.wait(timeout=60) == 75
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
