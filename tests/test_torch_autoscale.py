"""The port's autoscaler (``serving/autoscale.py``) against the
reference's, in lockstep: the same scraped series gives the same scale
and brownout decisions, the same ``autoscale_decisions.jsonl`` lines, the
same counters and lifecycle events (host logic: exact equality).  Then the
autoscale probe through ``python -m cst_captioning_tpu_torch.serve_supervisor``
on the CPU at a tiny width: 1 -> 2 -> 1 replica, every answer
bit-identical to a single-engine child, and the record and run directory
through the reference's ``serve_report.py`` and ``fleet_report.py``."""

import json
import os
import subprocess
import sys

import pytest

from cst_captioning_tpu.serving import autoscale as ref_autoscale
from cst_captioning_tpu.telemetry import lifecycle as ref_lifecycle
from cst_captioning_tpu_torch.serving import autoscale as port_autoscale
from cst_captioning_tpu_torch.telemetry import lifecycle as port_lifecycle
from cst_captioning_tpu_torch.utils import locksan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPLS = {"reference": (ref_autoscale, ref_lifecycle),
         "port": (port_autoscale, port_lifecycle)}


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


class SeriesObs:
    """A scripted ``FleetObs.series()``: one scrape sample per push."""

    def __init__(self):
        self._samples = []

    def series(self):
        return list(self._samples)

    def push(self, qw=0.0, dc=5.0, *, busy=True, settled=True,
             firing=False, children=1):
        self._samples.append({
            "seq": len(self._samples) + 1,
            "children": [{
                "index": k, "state": "ok" if settled else "backoff",
                "live": True, "retiring": False,
                "inflight": 1 if busy else 0,
                "queue_depth": 1 if busy else 0,
                "attribution_p99_ms": {"queue_wait": qw * (k + 1),
                                       "decode": dc},
            } for k in range(children)],
            "slo": {"firing": ["p99"] if firing else []},
        })


class CountSup:
    """The verbs the autoscaler acts through, counted."""

    def __init__(self, n=1, refuse=False):
        self.n = n
        self.refuse = refuse
        self.log = []

    def active_replicas(self):
        return self.n

    def add_replica(self):
        self.n += 1
        self.log.append(("add", self.n))
        return self.n - 1

    def retire_worst(self):
        if self.refuse:
            self.log.append(("refused", self.n))
            return None
        self.n -= 1
        self.log.append(("retire", self.n))
        return self.n


def script(kind):
    """-> [(dt, push kwargs or None)]: one scripted traffic shape."""
    if kind == "burst_then_idle":
        return ([(1.0, dict(qw=0.0))] * 4 + [(1.0, dict(qw=120.0))] * 12
                + [(1.0, dict(qw=0.0, busy=False))] * 30)
    if kind == "decode_bound":
        # Waiting rises with the decode time: the model, not capacity.
        return ([(1.0, dict(qw=0.0, dc=5.0))] * 9
                + [(1.0, dict(qw=80.0, dc=200.0))] * 4)
    if kind == "pinned_at_max_brownout":
        return ([(0.5, dict(qw=300.0))] * 40
                + [(0.5, dict(qw=0.0, busy=False))] * 40)
    if kind == "flapping":
        return [(0.7, dict(qw=200.0 if (k // 4) % 2 else 0.0,
                           busy=bool((k // 4) % 2))) for k in range(60)]
    if kind == "unsettled_and_slo":
        return ([(1.0, dict(qw=100.0, settled=False))] * 6
                + [(1.0, dict(qw=100.0))] * 6
                + [(1.0, dict(qw=0.0, busy=False, firing=True))] * 12
                + [(1.0, dict(qw=0.0, busy=False))] * 12)
    if kind == "hysteresis_band":
        return [(1.0, dict(qw=20.0))] * 30
    raise KeyError(kind)


CONFIGS = {
    "defaults": dict(min_replicas=1, max_replicas=3, queue_hi_ms=50.0,
                     queue_lo_ms=5.0, up_cooldown_s=0.0,
                     down_cooldown_s=0.0),
    "cooldowns": dict(min_replicas=1, max_replicas=4, queue_hi_ms=50.0,
                      queue_lo_ms=5.0, up_cooldown_s=3.0,
                      down_cooldown_s=6.0),
    "pinned": dict(min_replicas=2, max_replicas=2, queue_hi_ms=50.0,
                   queue_lo_ms=5.0, brownout_patience=2),
}


def run(impl, tmp, kind, config, refuse=False):
    mod, lc_mod = IMPLS[impl]
    os.makedirs(tmp, exist_ok=True)
    clock = FakeClock()
    lc = lc_mod.LifecycleTracer(clock=clock)
    obs = SeriesObs()
    cfg = CONFIGS[config]
    sup = CountSup(n=cfg["min_replicas"], refuse=refuse)
    asc = mod.Autoscaler(obs, out_dir=str(tmp), wall=FakeClock(9000.0),
                         lifecycle=lc, **cfg)
    rungs = []
    for dt, push in script(kind):
        clock.advance(dt)
        obs.push(children=sup.n, **push)
        asc.tick(sup, clock())
        rungs.append(asc.brownout_rung())
    for rung in ("deadline", "parked", "stream"):
        asc.note_shed(rung)
    path = os.path.join(str(tmp), "autoscale_decisions.jsonl")
    lines = ([json.loads(x) for x in open(path)]
             if os.path.exists(path) else [])
    return {"decisions": asc.decisions, "lines": lines, "sup": sup.log,
            "rungs": rungs, "status": asc.status(),
            "counters": asc.counters(), "events": lc.events(),
            "accounting": lc.accounting()}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("kind", ["burst_then_idle", "decode_bound",
                                  "pinned_at_max_brownout", "flapping",
                                  "unsettled_and_slo", "hysteresis_band"])
def test_autoscalers_in_lockstep(tmp_path, kind, config):
    want = run("reference", tmp_path / "ref", kind, config)
    got = run("port", tmp_path / "port", kind, config)
    for key in want:
        assert got[key] == want[key], key


def test_retire_refused_in_lockstep(tmp_path):
    want = run("reference", tmp_path / "ref", "burst_then_idle",
               "defaults", refuse=True)
    got = run("port", tmp_path / "port", "burst_then_idle", "defaults",
              refuse=True)
    assert got == want


def test_the_cases_decide_what_they_say(tmp_path):
    burst = run("port", tmp_path / "a", "burst_then_idle", "defaults")
    actions = [d["action"] for d in burst["decisions"]]
    assert actions[:2] == ["scale_up", "scale_up"] and "scale_down" in actions
    assert [x["action"] for x in burst["lines"]] == \
        [d["action"] for d in burst["decisions"]]
    assert burst["accounting"]["terminal_ok"]
    assert run("port", tmp_path / "b", "decode_bound",
               "defaults")["decisions"] == []
    brown = run("port", tmp_path / "c", "pinned_at_max_brownout", "pinned")
    assert max(brown["rungs"]) == 3 and brown["rungs"][-1] == 0
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                dict(queue_hi_ms=5.0, queue_lo_ms=5.0)):
        for mod, _ in IMPLS.values():
            with pytest.raises(ValueError):
                mod.Autoscaler(SeriesObs(), **bad)


def test_tables_are_the_references():
    assert port_autoscale.AUTOSCALE_COUNTERS == \
        ref_autoscale.AUTOSCALE_COUNTERS
    assert port_autoscale.BROWNOUT_RUNGS == ref_autoscale.BROWNOUT_RUNGS
    assert port_autoscale.LOCK_ORDER == ref_autoscale.LOCK_ORDER


TINY = ["--serve_demo", "1", "--device", "cpu", "--rnn_size", "16",
        "--input_encoding_size", "16", "--att_size", "16", "--vocab_size",
        "20", "--feat_shapes", "4x16,1x8", "--serve_demo_eos_bias", "-0.3",
        "--beam_size", "1"]


def test_cli_autoscale_probe_passes_the_references_reports(tmp_path):
    root = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop(locksan.ENV_FLAG, None)
    proc = subprocess.run(
        [sys.executable, "-m", "cst_captioning_tpu_torch.serve_supervisor",
         *TINY, "--autoscale_probe", "1", "--autoscale_min", "1",
         "--autoscale_max", "3", "--autoscale_up_cooldown_s", "1",
         "--autoscale_down_cooldown_s", "1", "--fleet_scrape_ms", "200",
         "--serve_cache", "0", "--supervise_dir", str(root)],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.splitlines()[-1])
    a = rec["autoscale"]
    assert a["started_at_min"] and a["scaled_up"] and a["scaled_down"]
    assert a["no_thrash"] and a["answered_ok"]
    assert rec["supervisor"]["parity_ok"]
    assert rec["recompiles_after_warmup"] == 0
    decisions = [json.loads(x) for x in open(root /
                                             "autoscale_decisions.jsonl")]
    assert {d["action"] for d in decisions} >= {"scale_up", "scale_down"}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    rec_file = tmp_path / "record.jsonl"
    rec_file.write_text(proc.stdout)
    for script_args in (["serve_report.py", "--file", str(rec_file)],
                        ["fleet_report.py", "--dir", str(root)]):
        rep = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", script_args[0]),
             *script_args[1:]], capture_output=True, text=True, cwd=REPO,
            env=env, timeout=120)
        assert rep.returncode == 0, (script_args[0], rep.stderr)
        assert "autoscale" in rep.stdout
