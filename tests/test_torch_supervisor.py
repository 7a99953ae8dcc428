"""The port's process-fleet supervisor (``serving/supervisor.py``) against
the reference's, in lockstep.

Both ``ProcessFleetSupervisor``s are driven by the same script over the
same strict in-process children (the reference suite's ``FakeChild``
and ``FakeClock``, ``tests/test_supervisor.py``): one decode chunk a
``lines()`` call, a dead child answers nothing more.  Each behaviour of
the reference suite is a case here, and for each the two supervisors
must give equal results: every response (JSON with keys sorted), the
counters, the health payload, the incident listings, the lifecycle
events and what the scenario reads on the way.  Host logic only: equality
is exact.  One case holds a fix of the port's (``hard_abort`` answers a
parked request once; the reference answers it twice).

Then the CLI (``python -m cst_captioning_tpu_torch.serve_supervisor``) at
a tiny width on the CPU: the kill probe's record and run directory
through the reference's ``serve_report.py``, ``fleet_report.py`` and
``fleet_trace.py``.  The other CLI drills spawn many processes and are
marked ``slow``.
"""

import io
import json
import os
import re
import subprocess
import sys

import pytest

from cst_captioning_tpu.resilience import faults as ref_faults
from cst_captioning_tpu.serving import autoscale as ref_autoscale
from cst_captioning_tpu.serving import journal as ref_journal
from cst_captioning_tpu.serving import supervisor as ref_supervisor
from cst_captioning_tpu.telemetry import fleetobs as ref_fleetobs
from cst_captioning_tpu.telemetry import lifecycle as ref_lifecycle
from cst_captioning_tpu_torch.resilience import faults as port_faults
from cst_captioning_tpu_torch.serving import autoscale as port_autoscale
from cst_captioning_tpu_torch.serving import journal as port_journal
from cst_captioning_tpu_torch.serving import supervisor as port_supervisor
from cst_captioning_tpu_torch.telemetry import fleetobs as port_fleetobs
from cst_captioning_tpu_torch.telemetry import lifecycle as port_lifecycle
from cst_captioning_tpu_torch.utils import locksan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXIT_PREEMPTED, EXIT_SIGKILL, EXIT_SIGTERM = 75, 137, 143


class Impl:
    def __init__(self, sup, faults, journal, fleetobs, autoscale,
                 lifecycle):
        self.sup, self.faults, self.journal = sup, faults, journal
        self.fleetobs, self.autoscale = fleetobs, autoscale
        self.lifecycle = lifecycle


IMPLS = {
    "reference": Impl(ref_supervisor, ref_faults, ref_journal,
                      ref_fleetobs, ref_autoscale, ref_lifecycle),
    "port": Impl(port_supervisor, port_faults, port_journal,
                 port_fleetobs, port_autoscale, port_lifecycle),
}


@pytest.fixture(autouse=True)
def _lock_sanitizer(monkeypatch, tmp_path):
    """Both supervisors' locks are made under the armed sanitizer."""
    receipt = tmp_path / "locksan_violation.json"
    monkeypatch.setenv(locksan.ENV_FLAG, "1")
    monkeypatch.setenv(locksan.ENV_RECEIPT, str(receipt))
    before = len(locksan.violations())
    yield
    assert locksan.violations()[before:] == []
    assert not receipt.exists()


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeChild:
    """A strict serve-child stand-in with the ``ServeChild`` surface (the
    reference suite's): one decode chunk advances per ``lines()`` call
    while alive and unfrozen; after ``die()`` the transport raises and
    ``lines()`` returns only what was already buffered."""

    CHUNK = 2
    CAP_LEN = 6

    def __init__(self, replica, workdir, *, status="ok", compiles=0,
                 min_service_ms=1.0, shed_all=False, reject_all=False):
        self.replica = int(replica)
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.pid = 40000 + self.replica
        self.alive = True
        self.frozen = False
        self.draining = False
        self.rc = None
        self.status = status
        self.compiles = compiles
        self.min_service_ms = min_service_ms
        self.shed_all = shed_all
        self.reject_all = reject_all
        self.sent = []
        self.jobs = []
        self.dumps = 0
        self._outbox = []
        self._stalled = []

    @classmethod
    def tokens_for(cls, vid):
        base = int(str(vid).lstrip("v"))
        return [base * 10 + j + 1 for j in range(cls.CAP_LEN)]

    @classmethod
    def caption_for(cls, vid):
        return " ".join(f"w{t}" for t in cls.tokens_for(vid))

    def send_line(self, line):
        if not self.alive:
            raise OSError("child is dead")
        if self.frozen:
            self._stalled.append(line)
            return
        self.sent.append(line)
        req = json.loads(line)
        op = req.get("op", "caption")
        if op == "health":
            self._outbox.append(json.dumps({
                "op": "health", "status": self.status, "queue_depth": 0,
                "residents": len(self.jobs), "compiles": self.compiles,
                "min_service_ms": self.min_service_ms}))
            return
        if op == "stats":
            self._outbox.append(json.dumps(
                {"op": "stats", "compiles": self.compiles,
                 "queue_depth": 0, "slots": 8, "residents": len(self.jobs),
                 "attribution": {"components": {
                     "queue_wait": {"p99_ms": 80.0 if self.jobs else 1.0},
                     "decode": {"p99_ms": 5.0}}}}))
            return
        if op == "ping":
            self._outbox.append(json.dumps(
                {"op": "ping", "seq": req["seq"], "t0": req["t0"],
                 "wall": 1000.0 + self.replica, "pid": self.pid}))
            return
        if op == "dump":
            self.dumps += 1
            with open(os.path.join(self.workdir, "blackbox.json"), "w") as f:
                json.dump({"reason": "wire_dump", "replica": self.replica}, f)
            self._outbox.append(json.dumps({"op": "dump"}))
            return
        rid = req["id"]
        if self.shed_all:
            self._outbox.append(json.dumps(
                {"id": rid, "error": "shed", "queue_depth": 1}))
            return
        if self.reject_all or self.draining:
            self._outbox.append(json.dumps(
                {"id": rid, "error": "rejected_draining"}))
            return
        self.jobs.append({"id": rid, "vid": req["video_id"],
                          "deadline_ms": req.get("deadline_ms"),
                          "stream": op == "stream", "pos": 0, "seq": 0})

    def lines(self):
        if self.alive and not self.frozen:
            self._advance()
        out, self._outbox = self._outbox, []
        return out

    def _advance(self):
        for job in list(self.jobs):
            toks = self.tokens_for(job["vid"])
            if job["pos"] < len(toks):
                chunk = toks[job["pos"]:job["pos"] + self.CHUNK]
                if job["stream"]:
                    self._outbox.append(json.dumps({
                        "id": job["id"], "video_id": job["vid"],
                        "stream": True, "seq": job["seq"], "tokens": chunk,
                        "text": " ".join(f"w{t}" for t in chunk),
                        "final": False}))
                job["seq"] += 1
                job["pos"] += self.CHUNK
                continue
            term = {"id": job["id"], "video_id": job["vid"],
                    "caption": self.caption_for(job["vid"]),
                    "tokens": toks, "latency_ms": 7.0}
            if job["stream"]:
                term.update(stream=True, final=True, chunks=job["seq"])
            self._outbox.append(json.dumps(term))
            self.jobs.remove(job)
        if self.draining and not self.jobs:
            self.die(EXIT_PREEMPTED)

    def poll(self):
        return None if self.alive else self.rc

    def die(self, rc):
        self.alive = False
        self.rc = rc

    def terminate(self):
        if not self.alive:
            return
        self.draining = True
        if not self.jobs:
            self.die(EXIT_PREEMPTED)

    def kill(self):
        if self.alive:
            self.die(EXIT_SIGKILL)

    def stop(self):
        self.frozen = True

    def cont(self):
        self.frozen = False
        stalled, self._stalled = self._stalled, []
        for line in stalled:
            self.send_line(line)

    def close(self):
        pass


class Rig:
    """One supervisor of one package over FakeChildren, plus what the
    scenario records."""

    def __init__(self, M, tmp, n=2, child_kw=None, lifecycle=False,
                 plan=None, **kw):
        self.M = M
        self.tmp = str(tmp)
        self.clock = kw.pop("clock", None) or FakeClock()
        self.children = []
        self.answers = {}
        self.notes = {}
        self.lc = (M.lifecycle.LifecycleTracer(clock=self.clock)
                   if lifecycle else None)
        child_kw = child_kw or {}

        def launcher(k):
            child = FakeChild(k, os.path.join(self.tmp, f"replica{k}"),
                              **child_kw.get(k, {}))
            self.children.append(child)
            return child

        kw.setdefault("backoff_ms", 200.0)
        kw.setdefault("incident_dir", os.path.join(self.tmp, "incidents"))
        if plan is not None:
            kw["fault_plan"] = M.faults.FaultPlan.parse(plan)
        self.plan = kw.get("fault_plan")
        self.sup = M.sup.ProcessFleetSupervisor(
            launcher, n, clock=self.clock, spawn_async=False,
            lifecycle=self.lc, **kw)

    def child(self, k):
        return [c for c in self.children if c.replica == k][-1]

    def submit(self, cid, vid, **kw):
        self.answers.setdefault(cid, [])
        self.sup.submit(cid, vid, respond=self.answers[cid].append, **kw)

    def tick_until(self, pred, n=64):
        for _ in range(n):
            self.sup.tick()
            if pred():
                return
        raise AssertionError(f"predicate never held within {n} ticks")

    def final(self, cid):
        return any(a.get("final") or "caption" in a or "error" in a
                   for a in self.answers.get(cid, []))

    def note(self, key, value):
        self.notes[key] = value

    def record(self):
        def rel(v):
            return (os.path.relpath(v, self.tmp)
                    if isinstance(v, str) and v.startswith(self.tmp) else v)

        incidents = [{k: rel(v) for k, v in inc.items()}
                     for inc in self.sup._incidents]
        out = {
            "answers": {str(k): [json.dumps(a, sort_keys=True) for a in v]
                        for k, v in self.answers.items()},
            "counters": self.sup.supervisor_counters(),
            "health": self.sup.health_payload(),
            "incidents": incidents,
            "incident_dirs": sorted(os.listdir(os.path.join(
                self.tmp, "incidents"))) if os.path.isdir(os.path.join(
                    self.tmp, "incidents")) else [],
            "states": [(r.state, r.restarts, r.fatal_spent, r.last_rc)
                       for r in self.sup._replicas],
            "sent": [c.sent for c in self.children],
            "notes": self.notes,
        }
        if self.lc is not None:
            out["lifecycle"] = self.lc.events()
        return out


# -- the scenarios: each drives one rig and notes what it reads ------------


def sc_placement(r):
    for i in range(6):
        r.submit(i, f"v{i}")
    r.note("owners", [len(c.jobs) for c in r.children])


def sc_route_around_degraded(r):
    r.sup.tick()
    r.sup.tick()
    r.submit("a", "v1")
    r.note("jobs", [len(c.jobs) for c in r.children])


def sc_edge_latency(r):
    r.submit("cli-7", "v3")
    r.clock.advance(0.25)
    r.tick_until(lambda: r.final("cli-7"))
    r.note("quiet", r.sup.quiet)


def sc_kill_midstream(r):
    r.submit("s1", "v4", stream=True, deadline_ms=1000.0)
    r.sup.tick()
    r.sup.tick()
    r.clock.advance(0.3)
    r.children[0].kill()
    r.sup.tick()
    r.tick_until(lambda: r.final("s1"))
    r.clock.advance(0.5)
    r.sup.tick()


def sc_watermark_slice(r):
    r.submit("s", "v1", stream=True)
    pr = next(iter(r.sup._pending.values()))
    pr.sent_tokens, pr.cur_tokens, pr.seq_out = 3, 0, 2
    r.sup._forward_chunk(pr, {"stream": True, "seq": 0,
                              "tokens": [11, 12, 13, 14],
                              "text": "a b c d", "final": False})
    r.note("sent_tokens", pr.sent_tokens)


def sc_fatal_budget(r):
    r.children[0].die(1)
    r.sup.tick()
    r.clock.advance(0.5)
    r.sup.tick()
    r.child(0).die(1)
    try:
        r.sup.tick()
    except r.M.sup.SupervisorUnrecoverable as e:
        r.note("raised", str(e))


def sc_resumable_free(r):
    for _ in range(3):
        r.child(0).die(EXIT_SIGTERM)
        r.sup.tick()
        r.clock.advance(3.0)
        r.sup.tick()


def sc_backoff(r):
    delays = []
    for _ in range(4):
        r.child(0).die(EXIT_SIGTERM)
        r.sup.tick()
        delays.append(round((r.sup._replicas[0].backoff_until - r.clock.t)
                            * 1e3))
        r.clock.advance(2.0)
        r.sup.tick()
    r.submit("a", "v1")
    r.tick_until(lambda: r.final("a"))
    r.child(0).die(EXIT_SIGTERM)
    r.sup.tick()
    delays.append(round((r.sup._replicas[0].backoff_until - r.clock.t)
                        * 1e3))
    r.note("delays", delays)


def sc_child_shed(r):
    r.submit("a", "v1")
    r.tick_until(lambda: r.final("a"))


def sc_child_drain_requeued(r):
    r.submit("a", "v5")
    r.tick_until(lambda: r.final("a"))


def sc_parked(r):
    r.children[0].die(EXIT_SIGKILL)
    r.sup.tick()
    r.submit("a", "v2", deadline_ms=5000.0)
    r.note("held", not r.answers["a"])
    r.clock.advance(0.5)
    r.tick_until(lambda: r.final("a"))


def sc_deadline_unmeetable(r):
    r.sup.tick()
    r.sup.tick()
    r.submit("a", "v1", deadline_ms=10.0)


def sc_wedge_detection(r):
    r.submit("a", "v6", stream=True)
    r.children[0].stop()
    r.sup.tick()
    r.clock.advance(1.5)
    r.sup.tick()
    r.tick_until(lambda: r.final("a"))


def sc_proc_kill(r):
    for _ in range(3):
        r.sup.tick()
    r.note("armed_idle", [r.children[0].alive, r.children[0].dumps])
    r.submit("a", "v7", stream=True)
    r.tick_until(lambda: not r.children[0].alive, n=200)
    r.note("dumps", r.children[0].dumps)
    r.sup.tick()
    r.note("again", r.plan.fire_replica("proc_kill", 0))
    r.clock.advance(0.5)
    r.tick_until(lambda: r.final("a"))


def sc_proc_wedge(r):
    r.submit("a", "v8", stream=True)
    r.tick_until(lambda: r.children[0].frozen, n=8)
    r.clock.advance(1.5)
    r.sup.tick()
    r.tick_until(lambda: r.final("a"))


def sc_proc_preempt(r):
    r.submit("a", "v9", stream=True)
    r.tick_until(lambda: r.children[0].draining, n=8)
    r.tick_until(lambda: r.final("a"))
    r.tick_until(lambda: not r.children[0].alive, n=8)
    r.sup.tick()


def sc_health(r):
    r.sup.tick()
    r.sup.tick()
    r.note("h0", r.sup.health_payload())
    r.sup._replicas[1].health = {"status": "degraded"}
    r.sup._update_snapshots()
    r.note("h1", r.sup.health_payload())
    r.children[2].die(EXIT_SIGKILL)
    r.sup.tick()
    st = r.sup.stats()
    st.pop("incidents")
    r.note("stats", json.loads(json.dumps(st).replace(r.tmp, "<tmp>")))


def sc_drain(r):
    r.submit(0, "v1")
    r.submit(1, "v2")
    r.sup.begin_drain()
    r.tick_until(r.sup.drain_done)
    r.submit(2, "v3", stream=True)


def sc_hard_abort(r):
    for i in range(3):
        r.submit(i, f"v{i}", stream=(i == 0))
    r.sup.hard_abort()
    r.note("alive", [c.alive for c in r.children])


def sc_server_ops(r):
    server = r.M.sup.SupervisorServer(r.sup, out=io.StringIO())
    replies = []
    for line in ('{"op": "health"}', '{"op": "stats"}', '{"op": "dump"}',
                 "not json", '["a", "list"]', '{"op": "nope", "id": 1}',
                 '{"id": 1}', '{"id": 1, "video_id": "v1", '
                 '"deadline_ms": -5}', '{"id": 2, "video_id": "v1", '
                 '"idem": 5}', '{"id": 3, "video_id": "v1", '
                 '"have_seq": "x"}'):
        server._handle_line(line, replies.append)
    r.note("replies", [json.loads(x.replace(r.tmp, "<tmp>"))
                       for x in replies])


def sc_server_stdin(r):
    out = io.StringIO()
    server = r.M.sup.SupervisorServer(r.sup, out=out, idle_sleep=0.0)
    lines = [json.dumps({"id": i, "video_id": f"v{i}"}) + "\n"
             for i in range(4)] + ['{"op": "health"}\n']
    r.note("rc", server.run_stdin(lines=lines))
    r.note("out", sorted(out.getvalue().splitlines()))


def sc_autoscale_grow_retire(r):
    r.note("added", r.sup.add_replica())
    r.note("active", r.sup.active_replicas())
    r.sup.tick()
    r.sup.tick()
    r.submit("a", "v1")
    r.submit("b", "v2")
    r.note("retired", r.sup.retire_worst())
    r.tick_until(lambda: r.final("a") and r.final("b"))
    r.tick_until(lambda: r.sup.active_replicas() == 2)
    r.note("refuse", [r.sup.retire_worst(), r.sup.retire_worst()])
    r.note("snapshot", json.loads(json.dumps(
        r.sup.scrape_snapshot()).replace(r.tmp, "<tmp>")))


def journal_rig(r, name):
    return r.M.journal.IntakeJournal(os.path.join(r.tmp, name),
                                     wall=FakeClock(500.0))


def sc_journal_dup_and_attach(r):
    j = journal_rig(r, "journal")
    r.sup._journal = j
    r.submit("c0", "v0", idem="k0")
    r.tick_until(lambda: r.final("c0"))
    r.submit("dup", "v0", idem="k0")            # answered from the journal
    r.submit("s1", "v1", stream=True, idem="k1")
    r.sup.tick()
    r.sup.tick()
    r.submit("s1b", "v1", stream=True, idem="k1", have_seq=0)  # attach
    r.tick_until(lambda: r.final("s1b"))
    r.note("journal", {k: v for k, v in j.stats().items() if k != "dir"})
    j.close()


def sc_journal_replay(r):
    """The supervisor dies without a drain (abandoned); a new one on the
    same journal replays, and the reconnecting stream attaches."""
    j = journal_rig(r, "journal")
    r.sup._journal = j
    for i in range(3):
        r.submit(f"s{i}", f"v{i}", stream=True, idem=f"k{i}",
                 deadline_ms=60000.0)
    r.sup.tick()
    r.sup.tick()
    r.sup.tick()
    r.sup.tick()
    j.close()
    first = dict(r.answers)
    r.answers.clear()
    j2 = journal_rig(r, "journal")
    r.sup = r.M.sup.ProcessFleetSupervisor(
        lambda k: FakeChild(k, os.path.join(r.tmp, f"again{k}")), 2,
        clock=r.clock, spawn_async=False, journal=j2,
        incident_dir=os.path.join(r.tmp, "incidents"))
    r.note("ledger", r.sup.replay_journal())
    for i in range(3):
        seqs = [a["seq"] for a in first.get(f"s{i}", [])
                if a.get("stream") and not a.get("final")]
        r.submit(f"s{i}", f"v{i}", stream=True, idem=f"k{i}",
                 have_seq=max(seqs) if seqs else None)
    r.tick_until(lambda: all(r.final(f"s{i}") for i in range(3)))
    r.note("first", {k: [json.dumps(a, sort_keys=True) for a in v]
                     for k, v in first.items()})
    j2.close()


def sc_fleet_obs_plane(r):
    out = os.path.join(r.tmp, "plane")
    slo = r.M.fleetobs.SLOMonitor(p99_ms=50.0, clock=r.clock,
                                  min_requests=2, fast_window_s=10.0,
                                  slow_window_s=20.0)
    obs = r.M.fleetobs.FleetObs(out, scrape_interval_s=1.0, slo=slo,
                                clock=r.clock, wall=FakeClock(2000.0))
    r.sup._fleet_obs = obs
    for i in range(4):
        r.submit(i, f"v{i}")
        r.clock.advance(0.6)
        r.sup.tick()
    r.tick_until(lambda: all(r.final(i) for i in range(4)))
    r.clock.advance(1.5)
    r.sup.tick()
    r.children[1].kill()
    for _ in range(4):
        r.clock.advance(1.1)
        r.sup.tick()
    obs.close()
    r.note("slo", slo.status())
    r.note("metrics", [json.loads(x) for x in open(
        os.path.join(out, "fleet_metrics.jsonl"))])
    doc = json.load(open(os.path.join(out, "clock_sync.json")))
    doc.pop("supervisor_pid")
    r.note("clock_sync", doc)


def sc_brownout(r):
    """The brownout rungs gate intake: rung 1 tightens deadlines, rung 2
    caps the parked list, rung 3 sheds streams."""
    obs = r.M.fleetobs.FleetObs(os.path.join(r.tmp, "plane"),
                                clock=r.clock, wall=FakeClock(3000.0))
    asc = r.M.autoscale.Autoscaler(obs, min_replicas=1, max_replicas=1,
                                   parked_cap=1, wall=FakeClock(4000.0))
    r.sup._autoscaler = asc
    r.sup.tick()
    r.sup.tick()
    for rung in (1, 2, 3):
        asc._rung = rung
        r.submit(f"d{rung}", "v1", deadline_ms=3.0)
        r.submit(f"s{rung}", "v2", stream=True)
    r.children[0].die(EXIT_SIGKILL)
    r.sup.tick()
    r.submit("p0", "v3")
    r.submit("p1", "v4")
    r.note("counters", asc.counters())
    obs.close()


SCENARIOS = {
    "placement": (sc_placement, dict(n=3)),
    "route_around_degraded": (sc_route_around_degraded,
                              dict(child_kw={0: {"status": "degraded"}})),
    "edge_latency": (sc_edge_latency, dict(n=1)),
    "kill_midstream_requeue": (sc_kill_midstream, dict(lifecycle=True)),
    "watermark_slice": (sc_watermark_slice, dict(n=1)),
    "fatal_budget_unrecoverable": (sc_fatal_budget,
                                   dict(n=1, restart_limit=1)),
    "resumable_free_of_budget": (sc_resumable_free,
                                 dict(n=1, restart_limit=0)),
    "backoff_doubles_caps_resets": (sc_backoff,
                                    dict(n=1, backoff_cap_ms=1000.0)),
    "child_shed_reroutes": (sc_child_shed,
                            dict(child_kw={0: {"shed_all": True}})),
    "fleet_shed": (sc_child_shed, dict(child_kw={
        0: {"shed_all": True}, 1: {"shed_all": True}})),
    "child_drain_requeued": (sc_child_drain_requeued,
                             dict(child_kw={0: {"reject_all": True}})),
    "parked_then_retried": (sc_parked, dict(n=1)),
    "deadline_unmeetable": (sc_deadline_unmeetable, dict(child_kw={
        k: {"min_service_ms": 5000.0} for k in range(2)})),
    "wedge_detection_124": (sc_wedge_detection,
                            dict(wedge_timeout_s=1.0, lifecycle=True)),
    "proc_kill_dump_before_kill": (sc_proc_kill,
                                   dict(plan="proc_kill@replica=0",
                                        dump_grace_s=0.2)),
    "proc_wedge": (sc_proc_wedge, dict(plan="proc_wedge@replica=0",
                                       wedge_timeout_s=1.0)),
    "proc_preempt": (sc_proc_preempt, dict(plan="proc_preempt@replica=0")),
    "health_worst_of": (sc_health, dict(n=3)),
    "drain": (sc_drain, dict(lifecycle=True)),
    "hard_abort": (sc_hard_abort, {}),
    "server_ops_and_intake": (sc_server_ops, dict(n=1)),
    "server_stdin": (sc_server_stdin, {}),
    "autoscale_add_retire": (sc_autoscale_grow_retire, {}),
    "journal_dup_and_attach": (sc_journal_dup_and_attach, {}),
    "journal_replay": (sc_journal_replay, {}),
    "fleet_obs_plane": (sc_fleet_obs_plane, {}),
    "brownout_rungs": (sc_brownout, dict(n=1)),
}


def run(impl, tmp, name):
    fn, kw = SCENARIOS[name]
    rig = Rig(IMPLS[impl], tmp / impl, **dict(kw))
    fn(rig)
    return rig.record()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervisors_in_lockstep(tmp_path, name):
    want = run("reference", tmp_path, name)
    got = run("port", tmp_path, name)
    for key in want:
        assert got[key] == want[key], key
    assert got == want


def test_the_scenarios_do_what_they_say(tmp_path):
    """Spot checks that the lockstep cases exercise the behaviours (on the
    port's records): a kill requeues bit-identically, fatal exits end in
    SupervisorUnrecoverable, the wedge is a 124, the dump lands first."""
    kill = run("port", tmp_path / "a", "kill_midstream_requeue")
    fin = json.loads(kill["answers"]["s1"][-1])
    assert fin["caption"] == FakeChild.caption_for("v4")
    assert kill["counters"]["sup_requeued"] == 1
    replay = [json.loads(x) for x in kill["sent"][1]
              if json.loads(x).get("op") == "stream"]
    assert replay[-1]["deadline_ms"] == pytest.approx(700.0)
    kinds = [e["kind"] for e in kill["lifecycle"]]
    assert kinds.index("killed") < kinds.index("requeued") \
        < kinds.index("completed")
    fatal = run("port", tmp_path / "b", "fatal_budget_unrecoverable")
    assert "every replica is dead" in fatal["notes"]["raised"]
    wedge = run("port", tmp_path / "c", "wedge_detection_124")
    assert wedge["incidents"][0]["rc"] == 124
    assert wedge["incidents"][0]["classification"] == "wedge"
    pk = run("port", tmp_path / "d", "proc_kill_dump_before_kill")
    assert pk["notes"]["dumps"] == 1 and pk["notes"]["again"] is False
    assert "blackbox.json" in pk["incidents"][0]["files"]
    assert pk["incident_dirs"] == ["000_replica0_rc137"]
    backoff = run("port", tmp_path / "e", "backoff_doubles_caps_resets")
    assert backoff["notes"]["delays"] == [200, 400, 800, 1000, 200]
    replay = run("port", tmp_path / "f", "journal_replay")
    assert replay["notes"]["ledger"]["enabled"]
    assert all(json.loads(v[-1]).get("caption") for v in
               replay["answers"].values())


def test_hard_abort_answers_a_parked_request_once(tmp_path):
    """The port's one departure: a parked request is also pending, and
    ``hard_abort`` answers it once (the reference answers it twice)."""
    counts = {}
    for impl in IMPLS:
        rig = Rig(IMPLS[impl], tmp_path / impl, n=1)
        rig.children[0].die(EXIT_SIGKILL)
        rig.sup.tick()
        rig.submit("p", "v2")                  # parked: restart pending
        rig.sup.hard_abort()
        counts[impl] = len(rig.answers["p"])
        assert rig.answers["p"][-1]["error"] == "rejected_draining"
    assert counts == {"reference": 2, "port": 1}


def test_counter_tables_and_lock_order_are_the_references():
    assert port_supervisor.SUPERVISOR_COUNTERS == \
        ref_supervisor.SUPERVISOR_COUNTERS
    assert port_supervisor.LOCK_ORDER == ref_supervisor.LOCK_ORDER
    assert port_supervisor.FRONTEND_LOCK_ORDER == \
        ref_supervisor.FRONTEND_LOCK_ORDER
    assert port_supervisor._PORT_RE.pattern == ref_supervisor._PORT_RE.pattern


@pytest.mark.parametrize("plan", [
    "proc_kill@replica=1,serve_wedge@replica=1",
    "proc_wedge@replica=0,proc_preempt@replica=2,admit_err@replica=2",
    "serve_garble@replica=0,proc_kill@replica=0"])
def test_process_fault_kinds_fire_once_and_slice_per_child(plan):
    ref = ref_faults.FaultPlan.parse(plan)
    port = port_faults.FaultPlan.parse(plan)
    for k in range(3):
        assert port.cli_for_child(k) == ref.cli_for_child(k)
    for kind in ("proc_kill", "proc_wedge", "proc_preempt"):
        assert port.pending(kind) == ref.pending(kind)
        for k in (0, 1, 2, 1):
            assert port.fire_replica(kind, k) == ref.fire_replica(kind, k)
        assert port.pending(kind) == ref.pending(kind) == 0
    for p in (ref, port):
        with pytest.raises(ValueError):
            p.fire_replica("serve_wedge", 1)


# -- the CLI -----------------------------------------------------------------

TINY = ["--serve_demo", "1", "--device", "cpu", "--rnn_size", "16",
        "--input_encoding_size", "16", "--att_size", "16", "--vocab_size",
        "20", "--feat_shapes", "4x16,1x8", "--serve_demo_eos_bias", "-0.3",
        "--beam_size", "1"]


def cli(*args, timeout=120, stdin=None):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop(locksan.ENV_FLAG, None)
    return subprocess.run(
        [sys.executable, "-m", "cst_captioning_tpu_torch.serve_supervisor",
         *TINY, *args], input=stdin, capture_output=True, text=True,
        timeout=timeout, cwd=REPO, env=env)


def report(script, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return subprocess.run([sys.executable, os.path.join(REPO, "scripts",
                                                        script), *args],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO, env=env)


def test_cli_kill_probe_passes_the_references_reports(tmp_path):
    root = tmp_path / "run"
    proc = cli("--supervise_probe", "1", "--supervise_replicas", "3",
               "--fleet_scrape_ms", "200", "--slo_p99_ms", "60000",
               "--slo_availability", "0.5", "--supervise_dir", str(root))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.splitlines()[-1])
    sup = rec["supervisor"]
    assert sup["parity_ok"] and sup["blackbox_harvested"]
    assert sup["restarts"] == 1 and rec["recompiles_after_warmup"] == 0
    assert rec["completed"] == rec["num_requests"] == 48    # 16 a child
    assert rec["stream"]["prefix_ok"] and rec["slo"]["ok"]
    inc = os.listdir(root / "incidents")
    assert len(inc) == 1 and re.fullmatch(r"\d{3}_replica1_rc137", inc[0])
    assert (root / "incidents" / inc[0] / "blackbox.json").exists()
    with open(root / "supervisor_exit.json") as f:
        assert json.load(f)["parent_cuda_initialized"] is False
    rec_file = tmp_path / "record.jsonl"
    rec_file.write_text(proc.stdout)
    sr = report("serve_report.py", "--file", str(rec_file))
    assert sr.returncode == 0, sr.stderr
    assert "process fleet" in sr.stdout or "supervisor" in sr.stdout
    fr = report("fleet_report.py", "--dir", str(root))
    assert fr.returncode == 0, fr.stderr
    ft = report("fleet_trace.py", "--dir", str(root))
    assert ft.returncode == 0, ft.stderr
    merged = json.load(open(root / "fleet_trace.json"))
    pids = {e.get("pid") for e in merged["traceEvents"]
            if e.get("name") == "clock_skew"}
    # The killed child never closed its trace: the three live ones did.
    assert len(pids) == 3
    assert all(e["args"]["synced"] for e in merged["traceEvents"]
               if e.get("name") == "clock_skew")


@pytest.mark.slow
def test_cli_serves_stdin_and_every_replica_dead_exits_124(tmp_path):
    lines = "".join(json.dumps({"id": i, "video_id": f"v{i}"}) + "\n"
                    for i in range(4))
    ok = cli("--supervise_replicas", "2", "--supervise_dir",
             str(tmp_path / "ok"), stdin=lines)
    assert ok.returncode == 0, ok.stderr[-3000:]
    assert len([ln for ln in ok.stdout.splitlines() if "caption" in ln]) == 4
    dead = cli("--supervise_replicas", "2", "--supervise_restart_limit",
               "0", "--serve_recover", "0", "--fault_plan",
               "serve_wedge@replica=0,serve_wedge@replica=1",
               "--supervise_dir", str(tmp_path / "dead"), stdin=lines)
    assert dead.returncode == 124, dead.stderr[-3000:]
    answers = [json.loads(ln) for ln in dead.stdout.splitlines()]
    assert sorted(a["id"] for a in answers) == [0, 1, 2, 3]
    box = json.load(open(tmp_path / "dead" / "blackbox.json"))
    assert [p["status"] for p in box["health"]["per_replica"]] == \
        ["dead", "dead"]
    assert len(os.listdir(tmp_path / "dead" / "incidents")) == 2


@pytest.mark.slow
def test_cli_wedge_and_preempt_requeue_every_stream(tmp_path):
    lines = "".join(json.dumps({"id": i, "video_id": f"v{i % 16}",
                                "op": "stream"}) + "\n" for i in range(24))
    proc = cli("--supervise_replicas", "3", "--fault_plan",
               "proc_wedge@replica=0,proc_preempt@replica=2",
               "--wedge_timeout", "3", "--supervise_dir",
               str(tmp_path / "c"), stdin=lines, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    finals = [json.loads(ln) for ln in proc.stdout.splitlines()
              if '"final": true' in ln]
    assert len(finals) == 24 and all("caption" in f for f in finals)
    doc = json.load(open(tmp_path / "c" / "supervisor_exit.json"))
    incs = {(i["replica"], i["rc"]) for i in doc["stats"]["incidents"]}
    assert incs == {(0, 124), (2, 75)}


def test_serve_child_reader_outlives_a_silent_stretch(tmp_path):
    """``ServeChild``'s socket keeps its connect timeout (30 s; 0.2 s
    here).  A child that says nothing for longer (it waits, silent, while
    the supervisor starts the others, on a loaded host longer than 30 s)
    is still heard afterwards: a read that times out only means silence,
    and the reader waits again.  Lines split across sends arrive whole;
    the reader ends when the child's socket closes."""
    import socket
    import threading
    import time

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen()
    sock = socket.create_connection(srv.getsockname(), timeout=0.2)
    conn, _ = srv.accept()
    before = set(threading.enumerate())
    child = port_supervisor.ServeChild(None, sock, str(tmp_path), 0,
                                       str(tmp_path / "stderr.log"))
    reader, = [t for t in threading.enumerate()
               if t not in before and t.name == "sup-child-0"]

    def collect(n, within=5.0):
        got, end = [], time.monotonic() + within
        while len(got) < n and time.monotonic() < end:
            got += child.lines()
            time.sleep(0.01)
        return got

    try:
        time.sleep(0.7)                       # three timed-out reads
        assert reader.is_alive()
        conn.sendall(b'{"op": "health", "compiles": 3}\n{"id": 1, "fin')
        time.sleep(0.3)
        conn.sendall(b'al": true}\n')
        got = collect(2)
        assert [json.loads(ln) for ln in got] == [
            {"op": "health", "compiles": 3}, {"id": 1, "final": True}]
        assert all(ln.endswith("\n") for ln in got)
        conn.close()
        reader.join(timeout=5)
        assert not reader.is_alive()
    finally:
        conn.close()
        sock.close()
        srv.close()
