"""Port's serving faults against the reference engine: the ladder, deadlines,
admission errors, the health plane and the front ends.

Each twin is one reference ``ServingEngine`` (the Pallas decode cell,
interpreted on the CPU) and one port ``ServingEngine`` (K2's plain
version on the CPU) on the same weights (``model_from_flax``), given the
same requests, the same fault plan and the same fake-clock ticks.  Their
completions (tokens, slot, latency), drop records and recovery counters
must be equal, and under a fault plan the captions must equal a clean
run's.  Then the port's own contracts: the ladder's exit 124, the
rebuild that loads no kernel library, the server's intake, health,
socket and signals (subprocesses of the CLI with ``--device cpu``).
"""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.resilience import garble as ref_garble
from cst_captioning_tpu.resilience.faults import FaultPlan as RefFaultPlan
from cst_captioning_tpu.serving.engine import ServingEngine as JaxEngine
from cst_captioning_tpu.serving.engine import \
    ServingUnrecoverable as JaxUnrecoverable
from cst_captioning_tpu.telemetry.registry import \
    MetricsRegistry as RefRegistry
from cst_captioning_tpu_torch import serve
from cst_captioning_tpu_torch.ops import _cuda, launch_counts
from cst_captioning_tpu_torch.ops.sampling import greedy_decode
from cst_captioning_tpu_torch.resilience import garble
from cst_captioning_tpu_torch.resilience.exitcodes import (EXIT_OK,
                                                           EXIT_PREEMPTED,
                                                           EXIT_SIGTERM,
                                                           EXIT_WEDGE)
from cst_captioning_tpu_torch.resilience.faults import FaultPlan
from cst_captioning_tpu_torch.serving import engine as engine_mod
from cst_captioning_tpu_torch.serving.engine import (COUNTERS, ServingEngine,
                                                     ServingUnrecoverable,
                                                     _trim_eos)
from cst_captioning_tpu_torch.serving.server import CaptionServer
from cst_captioning_tpu_torch.telemetry.registry import MetricsRegistry
from cst_captioning_tpu_torch.weights import model_from_flax

N, H, E, A, V, MAX_LEN, CHUNK = 6, 16, 12, 16, 30, 8, 2
FEAT_SHAPES = ((4, 8), (1, 5))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class World:
    """The reference model and its variables, the port's model on the same
    weights, and ``N`` seeded requests."""

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

    def request(self, i):
        return [f[i % N] for f in self.feats]

    def offline(self):
        """The port's offline greedy captions of the ``N`` videos."""
        return greedy_decode(self.model,
                             [torch.from_numpy(f) for f in self.feats],
                             MAX_LEN).numpy()


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(3)
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
    """Captions that end at mixed lengths."""
    return World(*params, eos_bias=0.2, seed=0)


@pytest.fixture(scope="module")
def long_world(params):
    """EOS suppressed: every caption runs MAX_LEN steps, so residents
    stay in flight for the deadline drills."""
    w = World(*params, eos_bias=-8.0, seed=7)
    assert all(len(_trim_eos(t)) == MAX_LEN for t in w.offline())
    return w


class Twin:
    """A reference engine and a port engine driven in lockstep."""

    def __init__(self, w: World, *, plan=None, clock=True, beam_size=1,
                 **kw):
        self.w = w
        self.clocks = [FakeClock(), FakeClock()]
        self.registries = [RefRegistry(), MetricsRegistry()]
        common = dict(max_len=MAX_LEN, beam_size=beam_size,
                      decode_chunk=CHUNK, bucket_sizes=(2,), queue_limit=0)
        common.update(kw)
        plans = (plan, plan)
        if isinstance(plan, str):
            plans = (RefFaultPlan.parse(plan), FaultPlan.parse(plan))
            for p, reg in zip(plans, self.registries):
                p.bind_metrics(reg)
        self.engines = [
            JaxEngine(w.jm, w.variables, list(FEAT_SHAPES), **common,
                      fault_plan=plans[0], registry=self.registries[0],
                      **({"clock": self.clocks[0]} if clock else {})),
            ServingEngine(w.model, FEAT_SHAPES, **common,
                          fault_plan=plans[1], registry=self.registries[1],
                          **({"clock": self.clocks[1]} if clock else {}))]
        self.done = [[], []]
        self.drops = [[], []]
        self.chunks = [[], []]
        # The shed floor reads wall times of real chunks (and the
        # reference's first chunk compiles): both engines get this fixed
        # window instead, before every step.
        self.floor_window = []

    @property
    def port(self) -> ServingEngine:
        return self.engines[1]

    def submit(self, i, video=None, **kw):
        ok = [e.submit(i, self.w.request(i if video is None else video),
                       **kw) for e in self.engines]
        assert ok[0] == ok[1]
        return ok[1]

    def _collect(self, k, comps):
        e = self.engines[k]
        self.done[k] += [(c.request_id, np.asarray(c.tokens).tolist(),
                          c.slot, c.latency_s, c.decode_steps, c.cache_hit,
                          c.stream_chunks, c.ttft_s) for c in comps]
        self.drops[k] += [(d.request_id, d.reason, d.where)
                          for d in e.pop_dropped()]
        self.chunks[k] += [(c.request_id, c.seq,
                            np.asarray(c.tokens).tolist())
                           for c in e.pop_stream_chunks()]

    def step(self):
        for k, e in enumerate(self.engines):
            e._chunk_wall.clear()
            e._chunk_wall.extend(self.floor_window)
            self._collect(k, e.step())

    def tick(self, dt):
        for c in self.clocks:
            c.t += dt

    def run(self, dt=0.0):
        """Step both until idle, ticking ``dt`` after every step."""
        while not all(e.idle for e in self.engines):
            self.step()
            self.tick(dt)

    def check(self):
        """Completions, drops, stream chunks and counters equal."""
        assert self.done[1] == self.done[0]
        assert self.drops[1] == self.drops[0]
        assert self.chunks[1] == self.chunks[0]
        ref, port = (r.snapshot()["counters"] for r in self.registries)
        names = [n for n in ref if n in COUNTERS or n.startswith("fault_")]
        assert {n: port.get(n) for n in names} == {n: ref[n] for n in names}
        rs, ps = (e.stats() for e in self.engines)
        for key in self.port.recovery_counters():
            assert ps[key] == rs[key], key
        return {c[0]: c[1] for c in self.done[1]}


# -- garble helpers ---------------------------------------------------------


@pytest.mark.parametrize("case", [
    ([[0, 0], [3, 4], [0, 0]], [False, False, True], [0, 1, 2]),
    ([[0, 0], [3, 4], [0, 0]], [False, False, True], [1, 2]),
    (np.zeros((2, 2, 3), np.int32), [False, False], [0, 1]),
    (np.array([[[5, 0, 0], [0, 0, 0]], [[0, 0, 0], [0, 0, 0]]]),
     [False, True], [0, 1]),
])
def test_garble_helpers_equal_the_references(case):
    toks, fin, live = np.asarray(case[0]), np.asarray(case[1]), case[2]
    assert garble.garbled_decode_slots(toks, fin, live) == \
        ref_garble.garbled_decode_slots(toks, fin, live)
    for vals in ([0.0, 0.0], [0.0, 1e-30], [], np.zeros((3, 4))):
        assert garble.all_zero(vals) == ref_garble.all_zero(vals)
    for d in (False, True):
        for r in (False, True):
            assert garble.health_status(draining=d, recovering=r) == \
                ref_garble.health_status(draining=d, recovering=r)
    assert str(garble.GarbledChunk([1, 2])) == \
        str(ref_garble.GarbledChunk([1, 2]))


def test_serving_fault_plans_parse_as_the_references():
    text = "serve_wedge@req=1,serve_garble@req=2,admit_err@req=0*2"
    plan, ref = FaultPlan.parse(text), RefFaultPlan.parse(text)
    assert str(plan) == str(ref)
    for kind in ("serve_wedge", "serve_garble", "admit_err"):
        assert plan.pending(kind) == ref.pending(kind)
    with pytest.raises(ValueError, match="keys on 'req'"):
        FaultPlan.parse("serve_wedge@step=1")


# -- the ladder --------------------------------------------------------------


@pytest.mark.parametrize("beam_size,plan,retries", [
    (1, "serve_wedge@req=1,serve_garble@req=2,admit_err@req=3", 2),
    (3, "serve_wedge@req=0,serve_garble@req=2,admit_err@req=4", 2),
])
def test_chaos_plan_matches_reference_and_clean_run(world, beam_size, plan,
                                                    retries):
    twin = Twin(world, plan=plan, recover=True, beam_size=beam_size,
                length_norm=0.7 if beam_size > 1 else 0.0)
    clean = Twin(world, recover=True, beam_size=beam_size,
                 length_norm=0.7 if beam_size > 1 else 0.0)
    for t in (twin, clean):
        for i in range(N):
            assert t.submit(i)
        t.run(dt=0.5)
    got = twin.check()
    assert sorted(got) == list(range(N))
    assert got == clean.check()
    stats = twin.port.stats()
    assert stats["chunk_retries"] == retries
    assert stats["wedge_detected"] == stats["garble_detected"] == 1
    assert stats["admit_errors"] == 1 and stats["rebuilds"] == 0
    assert twin.registries[1].counter("fault_firings") == 3
    assert twin.port.health()["status"] == "degraded"
    lengths = {len(_trim_eos(np.asarray(t))) for t in got.values()}
    assert len(lengths) > 1, "captions should end at mixed lengths"


@pytest.mark.parametrize("beam_size", [1, 3])
def test_rebuild_replays_bit_identical_and_loads_no_library(world,
                                                            beam_size,
                                                            monkeypatch):
    """Request 0 (the longest caption) emits a chunk; request 1's garble
    then goes straight to a rebuild (retry_limit 0).  The replay
    reproduces request 0's emitted prefix, the captions equal the
    reference's, and the rebuild builds and loads no kernel library (a
    library event inside it would count)."""
    offline = world.offline()
    lengths = [len(_trim_eos(t)) for t in offline]
    long_ix = int(np.argmax(lengths))
    assert lengths[long_ix] > CHUNK, "the drill needs a caption that " \
        "outlives its first chunk"
    twin = Twin(world, plan="serve_garble@req=1", recover=True,
                retry_limit=0, beam_size=beam_size)
    twin.submit(0, video=long_ix)
    twin.step()
    assert twin.port.resident_count == 1, "request 0 ended in one chunk"
    assert len(twin.port._residents[0].toks) == 1
    for i in range(1, N):
        twin.submit(i)
    twin.run()
    got = twin.check()
    stats = twin.port.stats()
    assert stats["rebuilds"] == 1 and stats["replay_divergence"] == 0
    assert stats["rebuild_recompiles"] == 0
    if beam_size == 1:
        assert got[0] == offline[long_ix].tolist()
        assert [got[i] for i in range(1, N)] == offline[1:].tolist()

    # The violation counter: a library event during a rebuild counts.
    events = iter([0, 2])
    monkeypatch.setattr(_cuda, "library_events", lambda: next(events))
    eng = ServingEngine(world.model, FEAT_SHAPES, max_len=MAX_LEN,
                        decode_chunk=CHUNK, bucket_sizes=(2,),
                        queue_limit=0, recover=True, retry_limit=0,
                        fault_plan=FaultPlan.parse("serve_garble@req=0"))
    eng.submit(0, world.request(0))
    eng.run_until_idle()
    assert eng.stats()["rebuild_recompiles"] == 2


def test_two_rebuilds_of_one_resident_do_not_diverge(long_world):
    """A resident that lives through two separate rebuilds keeps one
    prefix from step 0 (the replay re-derives it each time)."""
    eng = ServingEngine(long_world.model, FEAT_SHAPES, max_len=MAX_LEN,
                        decode_chunk=CHUNK, bucket_sizes=(4,),
                        queue_limit=0, recover=True, retry_limit=0,
                        fault_plan=FaultPlan.parse(
                            "serve_wedge@req=1,serve_wedge@req=2"))
    eng.submit(0, long_world.request(0))
    eng.step()
    eng.submit(1, long_world.request(1))          # first rebuild
    eng.step()
    eng.step()
    eng.submit(2, long_world.request(2))          # second rebuild
    done = {c.request_id: c.tokens for c in eng.run_until_idle()}
    stats = eng.stats()
    assert stats["rebuilds"] == 2 and stats["replay_divergence"] == 0
    offline = long_world.offline()
    for i in range(3):
        assert done[i].tolist() == offline[i].tolist()


def test_recovery_disabled_detects_but_proceeds(world):
    twin = Twin(world, plan="serve_garble@req=1", recover=False)
    for i in range(3):
        twin.submit(i)
    twin.run()
    twin.check()
    stats = twin.port.stats()
    assert stats["garble_detected"] == 1 and stats["chunk_retries"] == 0


class _AlwaysWedge:
    """Wedges every chunk: the failure the single-shot grammar cannot
    state, which drives the ladder to its end."""

    def fire(self, kind, index):
        return kind == "serve_wedge"


@pytest.mark.parametrize("retry_limit,rebuild_limit", [(1, 1), (0, 0),
                                                       (2, 0)])
def test_ladder_exhaustion_raises_unrecoverable(world, retry_limit,
                                                rebuild_limit):
    twin = Twin(world, plan=_AlwaysWedge(), recover=True,
                retry_limit=retry_limit, rebuild_limit=rebuild_limit,
                bucket_sizes=(1,))
    twin.submit(0)
    for e, exc in zip(twin.engines, (JaxUnrecoverable,
                                     ServingUnrecoverable)):
        with pytest.raises(exc, match="rebuild"):
            e.run_until_idle()
    rs, ps = (e.stats() for e in twin.engines)
    assert ps["rebuilds"] == rs["rebuilds"] == rebuild_limit
    assert ps["chunk_retries"] == rs["chunk_retries"] == \
        (retry_limit + 1) * (rebuild_limit + 1)


class _AdmitErrOn:
    """Fails every admission of one request (a repeat the single-shot
    grammar cannot state)."""

    def __init__(self, index):
        self.index = index

    def fire(self, kind, index):
        return kind == "admit_err" and index == self.index


def test_admit_errors_past_the_limit_drop_the_request(world):
    twin = Twin(world, plan=_AdmitErrOn(1), recover=True, retry_limit=2,
                bucket_sizes=(1,))
    for i in range(3):
        twin.submit(i)
    twin.run(dt=0.25)
    got = twin.check()
    assert sorted(got) == [0, 2]
    assert twin.drops[1] == [(1, "admit_failed", "admit")]
    assert twin.port.stats()["admit_errors"] == 3


# -- deadlines ---------------------------------------------------------------


def test_expired_resident_frees_its_slot(long_world):
    twin = Twin(long_world, bucket_sizes=(1,))
    twin.submit(0, deadline_ms=3000)
    twin.submit(1)
    twin.step()
    assert twin.port.resident_count == 1
    twin.tick(5.0)
    twin.run()
    twin.check()
    assert twin.drops[1] == [(0, "expired", "resident")]
    assert [(c[0], c[2]) for c in twin.done[1]] == [(1, 0)]


def test_queued_request_expires_and_deadline_defaults(long_world):
    twin = Twin(long_world, bucket_sizes=(1,), deadline_ms=60000)
    twin.submit(0)                                  # engine default
    twin.step()
    twin.submit(1, deadline_ms=1000)                # override
    twin.submit(2, deadline_ms=0)                   # explicitly none
    twin.tick(2.0)
    twin.run(dt=1.0)
    twin.check()
    assert twin.drops[1] == [(1, "expired", "queued")]
    assert sorted(c[0] for c in twin.done[1]) == [0, 2]
    hist = twin.registries[1].snapshot()["histograms"]
    assert hist["serve_deadline_slack_ms"]["count"] == 1


def test_deadline_shed_at_the_p99_chunk_floor(long_world):
    twin = Twin(long_world, bucket_sizes=(1,))
    assert twin.port.min_service_s() is None         # < 4 samples
    twin.floor_window = [0.1, 0.2, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5]
    twin.port._chunk_wall.extend(twin.floor_window)
    assert twin.port.min_service_s() == pytest.approx(
        float(np.percentile([0.1, 0.2] + [0.5] * 6, 99)))
    twin.submit(0, deadline_ms=100)                  # under one chunk
    twin.submit(1, deadline_ms=60000)
    twin.run()
    got = twin.check()
    assert twin.drops[1] == [(0, "deadline_shed", "queued")]
    assert sorted(got) == [1]
    assert twin.port.health()["min_service_ms"] == pytest.approx(
        twin.port.min_service_s() * 1e3, abs=1e-3)


def test_expiry_mixed_with_faults_matches_reference(long_world):
    twin = Twin(long_world, plan="serve_wedge@req=2,admit_err@req=3",
                recover=True, deadline_ms=2500)
    for i in range(5):
        twin.submit(i, **({"deadline_ms": 0} if i == 4 else {}))
    twin.run(dt=0.75)
    twin.check()
    reasons = {d[1] for d in twin.drops[1]}
    assert reasons == {"expired"}
    assert (4,) in {(c[0],) for c in twin.done[1]}


# -- the CLI: flags, warnings and exit 124 -----------------------------------


def test_warn_serve_deadline_once(capsys, monkeypatch):
    monkeypatch.setattr(serve, "_warned_serve_deadline", False)
    base = ["--serve_demo", "1", "--serve_buckets", "1,4,8"]
    opt = serve.parse_args(base + ["--serve_deadline_ms", "10",
                                   "--serve_step_budget_ms", "250"])
    serve.warn_serve_deadline(opt)
    serve.warn_serve_deadline(opt)
    err = capsys.readouterr().err
    assert err.count("can never be met") == 1
    assert "--serve_deadline_ms 10" in err and "8 slots" in err
    monkeypatch.setattr(serve, "_warned_serve_deadline", False)
    for argv in (["--serve_deadline_ms", "500", "--serve_step_budget_ms",
                  "250"], ["--serve_deadline_ms", "10"]):
        serve.warn_serve_deadline(serve.parse_args(base + argv))
    assert "can never be met" not in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--fault_plan", "serve_wedge@step=3"],
                                  ["--serve_cache", "-1"],
                                  ["--serve_retry_limit", "-2"]])
def test_cli_usage_errors_exit_2(argv):
    with pytest.raises(SystemExit) as e:
        serve.parse_args(["--serve_demo", "1"] + argv)
    assert e.value.code == 2


def _serve_cmd(*extra):
    return [sys.executable, "-m", "cst_captioning_tpu_torch.serve",
            "--serve_demo", "1", "--device", "cpu", "--rnn_size", "16",
            "--input_encoding_size", "16", "--att_size", "16",
            "--vocab_size", "20", "--feat_shapes", "4x16,1x8",
            "--beam_size", "1", *extra]


def _env():
    return dict(os.environ, PYTHONPATH=REPO)


def test_cli_ladder_exhausted_exits_124():
    lines = "".join(json.dumps({"id": i, "video_id": f"v{i}"}) + "\n"
                    for i in range(3))
    proc = subprocess.run(
        _serve_cmd("--serve_retry_limit", "0", "--serve_rebuild_limit", "0",
                   "--fault_plan", "serve_wedge@req=0",
                   "--serve_demo_eos_bias", "-50"),
        input=lines, capture_output=True, text=True, timeout=120, cwd=REPO,
        env=_env())
    assert proc.returncode == EXIT_WEDGE, proc.stderr[-2000:]
    assert "serve: UNRECOVERABLE" in proc.stderr
    stats = json.loads([ln for ln in proc.stderr.splitlines()
                        if ln.startswith("serve: {")][-1][len("serve: "):])
    assert stats["wedge_detected"] == 1 and stats["rebuilds"] == 0


def test_cli_chaos_plan_captions_equal_clean_run(tmp_path):
    lines = "".join(json.dumps({"id": i, "video_id": f"v{i}"}) + "\n"
                    for i in range(6))
    runs = {}
    for name, extra in (("clean", []), ("chaos", [
            "--fault_plan",
            "serve_wedge@req=1,serve_garble@req=3,admit_err@req=4",
            "--serve_heartbeat_file", str(tmp_path / "hb.json"),
            "--serve_telemetry_file", str(tmp_path / "tel.json")])):
        proc = subprocess.run(_serve_cmd("--serve_buckets", "1,4", *extra),
                              input=lines, capture_output=True, text=True,
                              timeout=120, cwd=REPO, env=_env())
        assert proc.returncode == EXIT_OK, proc.stderr[-2000:]
        runs[name] = {r["id"]: r["caption"] for r in
                      map(json.loads, proc.stdout.splitlines())}
    assert runs["chaos"] == runs["clean"] and len(runs["clean"]) == 6
    tel = json.loads((tmp_path / "tel.json").read_text())["counters"]
    assert tel["fault_firings"] == 3
    assert tel["serve_wedge_detected"] == tel["serve_garble_detected"] == 1
    assert tel["serve_admit_errors"] == 1
    beat = json.loads((tmp_path / "hb.json").read_text())
    assert beat["serving"]["op"] == "health"
    assert "recovery" in beat["serving"] and "counters" in beat


# -- the server: intake, health, stats, ping ---------------------------------


class _Handler:
    requested = False
    signal_count = 0


@pytest.fixture()
def server(world):
    from cst_captioning_tpu_torch.data.vocab import Vocab

    registry = MetricsRegistry()
    engine = ServingEngine(world.model, FEAT_SHAPES, max_len=MAX_LEN,
                           decode_chunk=CHUNK, bucket_sizes=(2,),
                           queue_limit=2, registry=registry)

    def feats_for(vid):
        try:
            ix = int(str(vid).lstrip("v"))
        except ValueError:
            return None
        return world.request(ix) if 0 <= ix < N else None

    srv = CaptionServer(engine, Vocab({i: f"w{i}" for i in range(1, V)}),
                        feats_for, handler=_Handler(), registry=registry)
    replies = []
    return srv, registry, replies, (lambda ln: replies.append(json.loads(ln)))


def test_intake_survives_bad_lines_and_counts_them(server, world):
    srv, registry, replies, respond = server
    for line in ("this is not json", "[1, 2, 3]", '{"id": 7}',
                 '{"id": 8, "op": "selfdestruct"}',
                 '{"id": 9, "video_id": "v0", "deadline_ms": "soon"}',
                 '{"id": 10, "video_id": "v0", "deadline_ms": -5}',
                 '{"id": 11, "video_id": "v0", "idem": 42}',
                 '{"id": 12, "video_id": "nope"}'):
        srv._handle_line(line, respond)
    assert [r.get("error") for r in replies] == [
        "bad_request", "bad_request", "bad_request", "unknown_op",
        "bad_request", "bad_request", "bad_request", "unknown_video"]
    assert replies[3]["op"] == "selfdestruct"
    assert registry.counter("serve_bad_lines") == 7
    # A line whose handling raises is answered and counted too.
    srv.feats_for = lambda vid: 1 / 0
    srv._handle_line('{"id": 13, "video_id": "v0"}', respond)
    assert replies[-1]["error"] == "bad_request"
    assert registry.counter("serve_bad_lines") == 8
    srv.feats_for = lambda vid: world.request(0)
    srv._handle_line('{"id": 14, "video_id": "v0", "idem": "k14"}', respond)
    assert srv.engine.queue_depth == 1


def test_health_reads_ok_degraded_draining(server):
    srv, registry, replies, respond = server
    srv._handle_line('{"op": "health"}', respond)
    assert replies[-1]["op"] == "health" and replies[-1]["status"] == "ok"
    assert set(replies[-1]["recovery"]) >= {
        "expired", "chunk_retries", "rebuilds", "garble_detected",
        "rebuild_recompiles"}
    srv.engine._note_recovery_event()
    srv._handle_line('{"op": "health"}', respond)
    assert replies[-1]["status"] == "degraded"
    srv.handler.requested = True
    srv._handle_line('{"op": "health"}', respond)
    assert replies[-1]["status"] == "draining"
    assert registry.counter("serve_health_queries") == 3


def test_stats_ping_and_dump_ops(server):
    srv, registry, replies, respond = server
    srv._handle_line('{"op": "ping", "seq": 4, "t0": 1.5}', respond)
    ping = replies[-1]
    assert (ping["op"], ping["seq"], ping["t0"]) == ("ping", 4, 1.5)
    assert ping["pid"] == os.getpid() and ping["mono"] > 0
    srv._handle_line('{"id": 1, "video_id": "v0"}', respond)
    srv._handle_line('{"op": "stats"}', respond)
    stats = replies[-1]
    assert stats["op"] == "stats" and stats["queue_depth"] == 1
    assert {"cache_hits", "stream_chunks", "rebuilds"} <= set(stats)
    srv._handle_line('{"op": "dump"}', respond)
    assert replies[-1] == {"op": "dump", "error": "no_recorder",
                           "detail": "lifecycle tracing is not armed"}
    for name in ("serve_ping_queries", "serve_stats_queries",
                 "serve_dump_queries"):
        assert registry.counter(name) == 1


def test_drop_responses_carry_reason_place_and_idem(long_world):
    from cst_captioning_tpu_torch.data.vocab import Vocab

    clock = FakeClock()
    engine = ServingEngine(long_world.model, FEAT_SHAPES, max_len=MAX_LEN,
                           decode_chunk=CHUNK, bucket_sizes=(1,),
                           queue_limit=0, clock=clock)
    replies = []
    srv = CaptionServer(engine, Vocab({1: "w"}),
                        lambda vid: long_world.request(int(vid[1:])))
    respond = (lambda ln: replies.append(json.loads(ln)))
    srv._handle_line('{"id": 1, "video_id": "v0", "deadline_ms": 1000, '
                     '"idem": "a"}', respond)
    srv._handle_line('{"id": 2, "video_id": "v1", "deadline_ms": 500, '
                     '"op": "stream"}', respond)
    engine.step()
    clock.t = 9.0
    engine.step()
    assert srv._respond_dropped_all()
    assert replies == [
        {"id": 1, "video_id": "v0", "error": "expired", "where": "resident",
         "idem": "a"},
        {"id": 2, "video_id": "v1", "error": "expired", "stream": True,
         "final": True, "where": "queued"}]


def test_socket_round_trip_two_connections(server):
    srv, registry, replies, respond = server
    rc = []
    loop = threading.Thread(target=lambda: rc.append(srv.run_socket(0)),
                            daemon=True)
    loop.start()
    deadline = time.monotonic() + 30
    while srv.bound_port is None:
        assert time.monotonic() < deadline, "the server never bound"
        time.sleep(0.01)

    def rpc(sock, fh, obj):
        sock.sendall((json.dumps(obj) + "\n").encode())
        return json.loads(fh.readline())

    c1 = socket.create_connection(("127.0.0.1", srv.bound_port), timeout=30)
    c2 = socket.create_connection(("127.0.0.1", srv.bound_port), timeout=30)
    with c1, c2, c1.makefile("r") as f1, c2.makefile("r") as f2:
        a0 = rpc(c1, f1, {"id": "a0", "video_id": "v0"})
        b0 = rpc(c2, f2, {"id": "b0", "video_id": "v1"})
        a1 = rpc(c1, f1, {"id": "a1", "video_id": "v2"})
        assert (a0["id"], b0["id"], a1["id"]) == ("a0", "b0", "a1")
        assert all("caption" in r for r in (a0, b0, a1))
        assert rpc(c2, f2, {"op": "health"})["status"] == "ok"
        assert rpc(c2, f2, {"id": "b1", "video_id": "nope"}
                   )["error"] == "unknown_video"
        bad0 = registry.counter("serve_bad_lines")
        c2.sendall(b'{"id": "torn')            # disconnect mid-line
        c2.shutdown(socket.SHUT_RDWR)
    deadline = time.monotonic() + 30
    while registry.counter("serve_bad_lines") <= bad0:
        assert time.monotonic() < deadline, "the torn line was not counted"
        time.sleep(0.01)
    srv._eof.set()
    loop.join(timeout=60)
    assert rc == [EXIT_OK]
    deadline = time.monotonic() + 10
    while any(t.name in ("serve-conn", "serve-accept")
              for t in threading.enumerate()):
        assert time.monotonic() < deadline, "serving threads left behind"
        time.sleep(0.05)


# -- drain: one signal drains (75), a second aborts (143) --------------------


def test_drain_abort_answers_every_request(long_world):
    engine = ServingEngine(long_world.model, FEAT_SHAPES, max_len=MAX_LEN,
                           decode_chunk=1, bucket_sizes=(2,), queue_limit=0)

    class Handler:
        requested = True
        signal_count = 1

    out = io.StringIO()
    handler = Handler()
    srv = CaptionServer(engine, type("V", (), {"decode": lambda s, t: "x"})(),
                        lambda vid: None, handler=handler, out=out)
    for i in range(5):
        engine.submit(i, long_world.request(i),
                      meta={"id": i, "video_id": f"v{i}"})
    engine.step()
    real = engine.step

    def second_signal():
        handler.signal_count += 1
        return real()

    engine.step = second_signal
    assert srv._drain_and_exit() == EXIT_SIGTERM
    replies = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert sorted(r["id"] for r in replies) == list(range(5))
    assert all(r["error"] == "rejected_draining" for r in replies)
    engine.step = real
    engine2 = ServingEngine(long_world.model, FEAT_SHAPES, max_len=MAX_LEN,
                            decode_chunk=CHUNK, bucket_sizes=(2,),
                            queue_limit=0)
    srv2 = CaptionServer(engine2, srv.vocab, lambda vid: None,
                         handler=Handler(), out=io.StringIO())
    for i in range(3):
        engine2.submit(i, long_world.request(i))
    engine2.step()
    assert srv2._drain_and_exit() == EXIT_PREEMPTED and engine2.idle


def _read_err(proc, lines, flag, needle):
    for line in proc.stderr:
        lines.append(line.rstrip())
        if needle in line:
            flag.set()


def test_cli_socket_two_connections_then_sigterm_exits_75():
    proc = subprocess.Popen(
        _serve_cmd("--serve_port", "-1", "--max_length", "200",
                   "--serve_demo_eos_bias", "-50", "--decode_chunk", "4",
                   "--serve_buckets", "4", "--serve_cache", "0"),
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO, env=_env())
    try:
        port = None
        for line in proc.stderr:
            if "listening on 127.0.0.1:" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port, "the CLI never announced its port"
        errs, draining = [], threading.Event()
        threading.Thread(target=_read_err, daemon=True,
                         args=(proc, errs, draining, "serve: draining")
                         ).start()
        conns = [socket.create_connection(("127.0.0.1", port), timeout=60)
                 for _ in range(2)]
        files = [c.makefile("r") for c in conns]
        for k, c in enumerate(conns):
            for i in range(4):
                c.sendall((json.dumps({"id": f"{k}-{i}",
                                       "video_id": f"v{i + 4 * k}"})
                           + "\n").encode())
            c.sendall(b'{"op": "health"}\n')
        replies = []
        for f in files:
            # Each connection's health reply proves its requests before
            # it were submitted.
            while True:
                r = json.loads(f.readline())
                if r.get("op") == "health":
                    break
                replies.append(r)
        proc.send_signal(signal.SIGTERM)
        assert draining.wait(60), "the drain never started"
        for f in files:
            replies += [json.loads(ln) for ln in f if ln.strip()]
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == EXIT_PREEMPTED, "\n".join(errs)[-2000:]
    answered = [r for r in replies if r.get("op") is None]
    assert sorted(r["id"] for r in answered) == sorted(
        f"{k}-{i}" for k in range(2) for i in range(4))
    assert {r.get("error") for r in answered} <= {None, "rejected_draining"}
    assert any("caption" in r for r in answered)
    for c in conns:
        c.close()


def test_cli_second_signal_aborts_drain_exits_143():
    proc = subprocess.Popen(
        _serve_cmd("--max_length", "20000", "--serve_demo_eos_bias", "-50",
                   "--decode_chunk", "1", "--serve_buckets", "8"),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO, env=_env())
    errs, draining = [], threading.Event()
    threading.Thread(target=_read_err, daemon=True,
                     args=(proc, errs, draining, "serve: draining")).start()
    try:
        for i in range(12):
            proc.stdin.write(json.dumps({"id": i, "video_id": f"v{i}"})
                             + "\n")
        proc.stdin.write('{"op": "health"}\n')
        proc.stdin.flush()
        assert json.loads(proc.stdout.readline())["op"] == "health"
        proc.send_signal(signal.SIGTERM)
        assert draining.wait(60), "the drain never started"
        proc.send_signal(signal.SIGSTOP)
        proc.send_signal(signal.SIGTERM)          # pending while stopped
        proc.send_signal(signal.SIGCONT)
        proc.wait(timeout=120)
        out = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
    err = "\n".join(errs)
    assert proc.returncode == EXIT_SIGTERM, err[-2000:]
    assert "drain aborted" in err
    assert "0 resident(s) unfinished" not in err, "nothing was in flight"
    replies = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
    assert {r["id"] for r in replies} == set(range(12))
    assert any(r.get("error") == "rejected_draining" for r in replies)


def test_counters_declared_at_zero(world):
    registry = MetricsRegistry()
    ServingEngine(world.model, FEAT_SHAPES, max_len=MAX_LEN,
                  registry=registry)
    counters = registry.snapshot()["counters"]
    assert {n: counters[n] for n in COUNTERS} == dict.fromkeys(COUNTERS, 0)
    assert launch_counts() == {"fused_additive_attention": 0,
                               "fused_decode_cell": 0}
    assert engine_mod.COUNTERS == COUNTERS


def test_watchdog_heartbeat_without_a_timeout(tmp_path, world):
    """The serving health plane's heartbeat file: written on its interval
    with the timeout at 0 (no exit policy), the health payload inside."""
    from cst_captioning_tpu_torch.utils.watchdog import ProgressWatchdog

    engine = ServingEngine(world.model, FEAT_SHAPES, max_len=MAX_LEN)
    srv = CaptionServer(engine, None, lambda vid: None)
    path = tmp_path / "heartbeat.json"
    dog = ProgressWatchdog(0, heartbeat_path=str(path),
                           payload=lambda: {"serving": srv.published_health()},
                           heartbeat_interval_s=0.05).start()
    try:
        deadline = time.monotonic() + 10
        while not path.exists():
            assert time.monotonic() < deadline, "no heartbeat written"
            time.sleep(0.01)
        first = json.loads(path.read_text())["time"]
        while json.loads(path.read_text())["time"] == first:
            assert time.monotonic() < deadline, "the heartbeat stopped"
            time.sleep(0.01)
    finally:
        dog.stop()
    beat = json.loads(path.read_text())
    assert beat["timeout_s"] == 0 and beat["serving"]["status"] == "ok"
    assert dog._thread is None
    # Neither a timeout nor an interval: nothing starts.
    idle = ProgressWatchdog(0, heartbeat_path=str(tmp_path / "x.json"))
    assert idle.start()._thread is None


def test_heartbeat_reads_the_health_the_loop_published(world):
    """The watchdog's thread reads a copy the scheduler loop publishes
    once per iteration, never the engine's live deques."""
    engine = ServingEngine(world.model, FEAT_SHAPES, max_len=MAX_LEN,
                           bucket_sizes=(2,), queue_limit=0)
    srv = CaptionServer(engine, type("V", (), {"decode": lambda s, t: "x"})(),
                        lambda vid: None, out=io.StringIO())
    before = srv.published_health()
    assert before["status"] == "ok" and before["queue_depth"] == 0
    for i in range(3):
        engine.submit(i, world.request(i), meta={"id": i})
    # Engine state moved; nothing is published until the loop runs.
    assert srv.health_payload()["queue_depth"] == 3
    assert srv.published_health() is before and before["queue_depth"] == 0
    assert srv.run_stdin(lines=[]) == EXIT_OK
    after = srv.published_health()
    assert after is not before
    assert after["completed"] == 3 and after["queue_depth"] == 0
    assert after == srv.health_payload()
