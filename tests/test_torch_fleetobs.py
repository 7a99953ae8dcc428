"""The port's fleet observability plane (``telemetry/fleetobs.py``)
against the reference's, in lockstep: the same series of request
outcomes gives the same SLO status and alert transitions, the same echoes
give the same clock-sync table, the same supervisor snapshots give the
same ``fleet_metrics.jsonl`` rows (with rotation) and ``slo_alerts.jsonl``;
and the files the port writes pass the reference's ``fleet_report.py``.
Host logic only: equality is exact."""

import json
import os
import subprocess
import sys

import pytest

from cst_captioning_tpu.telemetry import fleetobs as ref_fleetobs
from cst_captioning_tpu.telemetry import lifecycle as ref_lifecycle
from cst_captioning_tpu.telemetry import registry as ref_registry
from cst_captioning_tpu_torch.telemetry import fleetobs as port_fleetobs
from cst_captioning_tpu_torch.telemetry import lifecycle as port_lifecycle
from cst_captioning_tpu_torch.telemetry import registry as port_registry
from cst_captioning_tpu_torch.utils import locksan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPLS = {"reference": (ref_fleetobs, ref_lifecycle, ref_registry),
         "port": (port_fleetobs, port_lifecycle, port_registry)}


@pytest.fixture(autouse=True)
def _lock_sanitizer(monkeypatch, tmp_path):
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


def series(kind):
    """(dt, ok, latency_ms) outcomes: a seeded pattern per case."""
    out = []
    if kind == "p99_burn_then_clear":
        out += [(0.5, True, 10.0)] * 20 + [(0.5, True, 900.0)] * 30
        out += [(0.5, True, 5.0)] * 200
    elif kind == "errors_burst":
        out += [(1.0, True, 3.0)] * 10 + [(0.2, False, None)] * 40
        out += [(2.0, True, 3.0)] * 60
    elif kind == "one_bad_second":
        out += [(0.01, False, None)] * 5 + [(1.0, True, 1.0)] * 30
    elif kind == "flapping":
        for k in range(12):
            ok = k % 2 == 0
            out += [(0.3, ok, 40.0 if ok else 4000.0)] * 15
    return out


OBJECTIVES = {
    "p99": dict(p99_ms=100.0),
    "availability": dict(availability=0.9),
    "error_rate": dict(error_rate=0.05),
    "all": dict(p99_ms=100.0, availability=0.99, error_rate=0.02),
    "disabled": {},
}


def slo_run(impl, kind, objectives):
    fo, lc_mod, reg_mod = IMPLS[impl]
    clock = FakeClock()
    lc = lc_mod.LifecycleTracer(clock=clock)
    reg = reg_mod.MetricsRegistry()
    reg.declare(*fo.FLEETOBS_COUNTERS)
    slo = fo.SLOMonitor(clock=clock, lifecycle=lc, registry=reg,
                        fast_window_s=10.0, slow_window_s=60.0,
                        **OBJECTIVES[objectives])
    statuses = []
    for dt, ok, lat in series(kind):
        clock.advance(dt)
        slo.observe(ok, lat)
        statuses.append(slo.evaluate())
    return {"statuses": statuses, "alerts": slo.alerts,
            "alerting": slo.alerting, "status": slo.status(),
            "events": lc.events(), "accounting": lc.accounting(),
            "counters": {k: v for k, v in reg.snapshot()["counters"].items()
                         if k.startswith("slo_")}}


@pytest.mark.parametrize("objectives", sorted(OBJECTIVES))
@pytest.mark.parametrize("kind", ["p99_burn_then_clear", "errors_burst",
                                  "one_bad_second", "flapping"])
def test_slo_monitors_in_lockstep(kind, objectives):
    want = slo_run("reference", kind, objectives)
    got = slo_run("port", kind, objectives)
    assert got == want


def test_slo_cases_fire_and_clear():
    got = slo_run("port", "p99_burn_then_clear", "p99")
    assert [(a["objective"], a["state"]) for a in got["alerts"]] == [
        ("p99", "firing"), ("p99", "cleared")]
    assert got["accounting"]["terminal_ok"]
    burst = slo_run("port", "errors_burst", "availability")
    assert burst["alerts"][0]["state"] == "firing"
    assert burst["counters"]["slo_alerts_fired"] == 1


def clock_sync_run(impl):
    fo = IMPLS[impl][0]
    cs = fo.ClockSync(wall=FakeClock(7000.0))
    out = []
    for k, (idx, pid, rtt, skew) in enumerate(
            [(0, 11, 0.004, 0.5), (1, 12, 0.002, -0.25), (0, 11, 0.001, 0.5),
             (0, 11, 0.009, 0.5), (2, 13, 0.003, 0.0)]):
        t0 = 10.0 + k
        ping = cs.ping_payload(idx, t0)
        echo = {"op": "ping", "seq": ping["seq"], "pid": pid,
                "wall": 7000.0 + skew + rtt / 2}
        out.append(cs.on_echo(idx, echo, t1=t0 + rtt))
    cs.ping_payload(1, 20.0)
    cs.drop_pending(1)
    out.append(cs.on_echo(1, {"seq": 6, "pid": 12}, t1=21.0))
    out.append(cs.on_echo(0, {"seq": 99, "pid": 11}, t1=21.0))
    doc = cs.doc()
    doc.pop("supervisor_pid")
    return out, doc


def test_clock_sync_in_lockstep():
    assert clock_sync_run("port") == clock_sync_run("reference")


class StubSup:
    """The surface ``FleetObs.tick`` reads: a scripted fleet whose
    replicas restart and die on the way."""

    def __init__(self, clock, n=3):
        self.clock = clock
        self.queries = []
        self.fail = set()
        self.children = [
            {"index": k, "state": "ok", "live": True, "restarts": 0,
             "inflight": k, "retiring": False, "pid": 500 + k, "health": {},
             "stats": {"queue_depth": k, "latency_p50_ms": 4.0 + k,
                       "latency_p99_ms": 9.0 + k, "compiles": 2,
                       "slots": 8, "residents": 2 + k,
                       "cache_hits": 3, "cache_misses": k,
                       "attribution": {"components": {
                           "queue_wait": {"p99_ms": 1.5 * k},
                           "decode": {"p99_ms": 5.5}}}}}
            for k in range(n)]

    def scrape_snapshot(self):
        return {"fleet": {"replicas": len(self.children),
                          "in_service": sum(c["live"]
                                            for c in self.children),
                          "outstanding": 0, "parked": 0, "completed": 7},
                "children": [dict(c) for c in self.children]}

    def query_child(self, index, payload):
        self.queries.append((index, dict(payload)))
        return index not in self.fail


def plane_run(impl, tmp):
    fo, lc_mod, reg_mod = IMPLS[impl]
    clock = FakeClock()
    reg = reg_mod.MetricsRegistry()
    lc = lc_mod.LifecycleTracer(clock=clock)
    slo = fo.SLOMonitor(p99_ms=50.0, clock=clock, min_requests=3,
                        fast_window_s=5.0, slow_window_s=10.0,
                        lifecycle=lc, registry=reg)
    obs = fo.FleetObs(str(tmp), scrape_interval_s=1.0, slo=slo,
                      clock=clock, wall=FakeClock(5000.0), registry=reg,
                      lifecycle=lc, rotate_rows=16, fsync_every=4)
    sup = StubSup(clock)
    for step in range(60):
        clock.advance(0.4)
        if step == 10:
            sup.children[1].update(state="backoff", live=False, stats=None)
        if step == 14:
            sup.children[1].update(state="ok", live=True, restarts=1,
                                   pid=601)
            obs.on_child_assigned(1)
        if step == 20:
            sup.fail.add(2)
        if step == 30:
            sup.fail.discard(2)
        for q in list(sup.queries):
            if q[1]["op"] == "ping":
                obs.on_ping(q[0], {"op": "ping", "seq": q[1]["seq"],
                                   "pid": sup.children[q[0]]["pid"],
                                   "wall": 5000.5}, t1=clock() + 0.002)
            else:
                obs.on_stats(q[0])
        sup.queries.clear()
        obs.observe_request(step % 7 != 0, 20.0 if step < 25 else 200.0)
        obs.tick(sup, clock())
    obs.close()
    out = {}
    for name in sorted(os.listdir(tmp)):
        with open(os.path.join(tmp, name)) as f:
            if name.endswith(".jsonl"):
                out[name] = [json.loads(x) for x in f]
            else:
                out[name] = json.load(f)
    out["clock_sync.json"].pop("supervisor_pid")
    out["series"] = obs.series()
    out["counters"] = reg.snapshot()["counters"]
    out["events"] = lc.events()
    return out


def test_fleet_planes_write_the_same_files(tmp_path):
    want = plane_run("reference", tmp_path / "ref")
    got = plane_run("port", tmp_path / "port")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key
    assert "fleet_metrics_part0.jsonl" in got      # rotation happened
    assert got["slo_alerts.jsonl"]                 # an alert fired


def test_port_plane_files_pass_fleet_report(tmp_path):
    """The port's plane over a healthy fleet passes the reference's
    report; the same plane with a firing SLO fails its gate."""
    for name, p99_target, want_rc in (("healthy", 60000.0, 0),
                                      ("burning", 1.0, 1)):
        root = tmp_path / name
        clock = FakeClock()
        slo = port_fleetobs.SLOMonitor(p99_ms=p99_target, clock=clock,
                                       min_requests=3, fast_window_s=5.0,
                                       slow_window_s=10.0)
        obs = port_fleetobs.FleetObs(str(root), scrape_interval_s=1.0,
                                     slo=slo, clock=clock)
        sup = StubSup(clock, n=2)
        for _ in range(12):
            clock.advance(1.0)
            obs.observe_request(True, 30.0)
            obs.tick(sup, clock())
        obs.close()
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts",
                                          "fleet_report.py"),
             "--dir", str(root)], capture_output=True, text=True,
            cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
            timeout=120)
        assert proc.returncode == want_rc, (name, proc.stderr)


def test_tables_are_the_references():
    assert port_fleetobs.FLEETOBS_COUNTERS == ref_fleetobs.FLEETOBS_COUNTERS
    assert port_fleetobs.SLO_OBJECTIVES == ref_fleetobs.SLO_OBJECTIVES
    assert port_fleetobs.LOCK_ORDER == ref_fleetobs.LOCK_ORDER
    assert port_fleetobs.FLEET_METRICS_SCHEMA == \
        ref_fleetobs.FLEET_METRICS_SCHEMA
