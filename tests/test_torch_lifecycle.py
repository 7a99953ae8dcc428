"""The port's request-lifecycle tracer, flight recorder and span tracer
(``telemetry/lifecycle.py``, ``telemetry/spans.py``) against the
reference's, and their wiring into the port's engine, server and serve CLI.

- ``attribute_request`` and ``LifecycleTracer`` are fed the same event
  streams as the reference's and must give equal outputs;
- a traced twin run (a reference engine with the Pallas cell interpreted
  on the CPU and a port engine on K2's plain version, the same weights,
  requests, fault plan and fake clock) must give equal per-request kind
  chains, ``accounting()`` and ``attribution_report()``;
- an untraced engine keeps the ``stats()`` shape it had;
- the server's ``stats`` and ``dump`` ops, its ``responded`` events and
  the blackbox of an aborted drain;
- ``python -m cst_captioning_tpu_torch.serve --device cpu``: lifecycle on
  by default, a blackbox before exit 124, the ``dump`` op, ``--trace_dir``
  and ``--result_file``.
"""

import io
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.resilience.faults import FaultPlan as RefFaultPlan
from cst_captioning_tpu.serving import engine as ref_engine_mod
from cst_captioning_tpu.serving.engine import ServingEngine as JaxEngine
from cst_captioning_tpu.telemetry import lifecycle as ref_lc_mod
from cst_captioning_tpu.telemetry import spans as ref_spans
from cst_captioning_tpu.telemetry.registry import \
    MetricsRegistry as RefRegistry
from cst_captioning_tpu_torch.data.vocab import Vocab
from cst_captioning_tpu_torch.resilience.exitcodes import (EXIT_OK,
                                                           EXIT_SIGTERM,
                                                           EXIT_WEDGE)
from cst_captioning_tpu_torch.resilience.faults import FaultPlan
from cst_captioning_tpu_torch.serving import engine as engine_mod
from cst_captioning_tpu_torch.serving import server as server_mod
from cst_captioning_tpu_torch.serving.engine import ServingEngine
from cst_captioning_tpu_torch.serving.server import CaptionServer
from cst_captioning_tpu_torch.telemetry import lifecycle as lc_mod
from cst_captioning_tpu_torch.telemetry.lifecycle import (COMPONENTS,
                                                          LifecycleTracer,
                                                          attribute_request)
from cst_captioning_tpu_torch.telemetry.registry import MetricsRegistry
from cst_captioning_tpu_torch.telemetry.spans import (NULL_SPAN, SpanTracer,
                                                      trace_span)
from cst_captioning_tpu_torch.utils import locksan
from cst_captioning_tpu_torch.weights import model_from_flax

N, H, E, A, V, MAX_LEN, CHUNK = 6, 16, 12, 16, 30, 8, 2
FEAT_SHAPES = ((4, 8), (1, 5))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _lock_sanitizer(monkeypatch, tmp_path):
    receipt = tmp_path / "locksan_violation.json"
    monkeypatch.setenv(locksan.ENV_FLAG, "1")
    monkeypatch.setenv(locksan.ENV_RECEIPT, str(receipt))
    before = len(locksan.violations())
    yield
    assert len(locksan.violations()) == before, locksan.violations()


def _ev(ts, kind, rid=0, **attrs):
    return {"ts": float(ts), "id": rid, "kind": kind, **attrs}


# -- attribution and the tracer on the same event streams -------------------


STREAMS = {
    "plain": [_ev(0, "received"), _ev(0, "queued"),
              _ev(5, "admitted", admit_ms=1000.0), _ev(7, "decode_chunk"),
              _ev(9, "decode_chunk"), _ev(9, "completed", latency_ms=9000.0)],
    "kill_requeue": [_ev(0, "received"), _ev(0, "queued"),
                     _ev(1, "admitted"), _ev(2, "decode_chunk"),
                     _ev(3, "killed"), _ev(4, "requeued"), _ev(4, "queued"),
                     _ev(6, "admitted"), _ev(7, "decode_chunk"),
                     _ev(8, "completed")],
    "retry": [_ev(0, "received"), _ev(0, "queued"), _ev(1, "admitted"),
              _ev(2, "decode_chunk"), _ev(4, "retry"),
              _ev(6, "decode_chunk"), _ev(6, "completed")],
    "rebuild_drop": [_ev(0, "received"), _ev(1, "admitted", admit_ms=50.0),
                     _ev(2, "rebuild"), _ev(3, "decode_chunk"),
                     _ev(4, "dropped", reason="expired", where="resident"),
                     _ev(5, "responded")],
    "headless": [_ev(1, "queued"), _ev(2, "completed")],
    "unterminated": [_ev(0, "received"), _ev(1, "queued")],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_attribute_request_equals_the_references(name):
    evs = STREAMS[name]
    got, want = attribute_request(evs), ref_lc_mod.attribute_request(evs)
    assert got == want
    if got is not None:
        assert sum(got[c] for c in COMPONENTS) == pytest.approx(got["total"])
    if name == "plain":
        assert (got["queue_wait"], got["admit"], got["decode"]) == \
            pytest.approx((4.0, 1.0, 4.0))
    if name == "kill_requeue":
        assert got["requeue"] == pytest.approx(3.0)


def test_tables_are_the_references():
    for name in ("EVENT_KINDS", "TERMINAL_KINDS", "COMPONENTS",
                 "BLACKBOX_SCHEMA", "DEFAULT_EVENTS", "LOCK_ORDER"):
        assert getattr(lc_mod, name) == getattr(ref_lc_mod, name), name


def _both(**kw):
    """A port and a reference tracer on the same fake clock."""
    clock = kw.pop("clock", lambda: 0.0)
    return (LifecycleTracer(clock=clock, **kw),
            ref_lc_mod.LifecycleTracer(clock=clock, **kw))


def _same_views(ours, ref):
    assert ours.events() == ref.events()
    assert ours.emitted() == ref.emitted()
    assert ours.accounting() == ref.accounting()
    assert ours.attribution_report() == ref.attribution_report()
    assert ours.attribution_report({"x": 3.0}, tolerance_ms=0.5) == \
        ref.attribution_report({"x": 3.0}, tolerance_ms=0.5)


def _replay(tracers, script):
    for t in tracers:
        for kind, rid, kw in script:
            t.emit(kind, rid, **kw)


@pytest.mark.parametrize("case", ["ring", "id_reuse", "bad_chains",
                                  "replica_view", "mixed"])
def test_tracer_views_equal_the_references(case):
    if case == "ring":
        lcs = _both(max_events=16)
        script = [(k, i, {"ts": float(i), **({"latency_ms": 0.0}
                                             if k == "completed" else {})})
                  for i in range(20) for k in ("received", "completed")]
    elif case == "id_reuse":
        lcs = _both()
        script = [(k, "a", {"ts": ts + dt, **({"latency_ms": 500.0}
                                             if k == "completed" else {})})
                  for ts in (0.0, 1.0)
                  for k, dt in (("received", 0.0), ("completed", 0.5))]
    elif case == "bad_chains":
        lcs = _both()
        script = [("received", "x", {}), ("received", "y", {}),
                  ("completed", "y", {"latency_ms": 0.0}),
                  ("completed", "y", {"latency_ms": 0.0}),
                  ("slo_alert", "p99", {"state": "firing"})]
    elif case == "replica_view":
        lcs = _both()
        for lc in lcs:
            view = lc.for_replica(3)
            for kind in ("received", "shed", "queued"):
                view.emit(kind, 1)
            assert view.clock is lc.clock
        script = [("received", 2, {"ts": 0.0}), ("routed", 2, {"replica": 1})]
    else:
        # One stepping clock each: the same timestamps in both.
        ticks = [iter(np.arange(0.0, 100.0, 0.25)) for _ in range(2)]
        lcs = (LifecycleTracer(clock=lambda: float(next(ticks[0]))),
               ref_lc_mod.LifecycleTracer(
                   clock=lambda: float(next(ticks[1]))))
        script = [("received", 7, {}), ("queued", 7, {"depth": 1}),
                  ("admitted", 7, {"slot": 0, "admit_ms": 100.0}),
                  ("decode_chunk", 7, {"k": 1, "slot": 0}),
                  ("retry", 7, {"attempt": 1, "error": "InjectedFault"}),
                  ("decode_chunk", 7, {"k": 2, "slot": 0}),
                  ("completed", 7, {"latency_ms": 1500.0}),
                  ("responded", 7, {"status": "ok"}),
                  ("received", (1, "v"), {}), ("shed", (1, "v"),
                                               {"where": "queue"})]
    _replay(lcs, script)
    _same_views(*lcs)
    for lc in lcs:
        with pytest.raises(ValueError, match="unknown lifecycle event"):
            lc.emit("warp", 1)
    if case == "ring":
        assert len(lcs[0].events()) == 16 and lcs[0].emitted() == 40
        assert lcs[0].accounting()["submitted"] == 8
    if case == "bad_chains":
        acc = lcs[0].accounting()
        assert (acc["unterminated"], acc["multi_terminal"]) == (1, 1)
        assert set(acc["bad_ids"]) == {"x", "y"}
    if case == "replica_view":
        assert [e["kind"] for e in lcs[0].events()][0] == "queued"
        assert lcs[0].events()[0]["replica"] == 3


def test_blackbox_equals_the_references(tmp_path):
    regs = (MetricsRegistry(), RefRegistry())
    docs = []
    for lc_cls, reg, name in ((LifecycleTracer, regs[0], "ours"),
                              (ref_lc_mod.LifecycleTracer, regs[1], "ref")):
        lc = lc_cls(registry=reg, clock=lambda: 0.0)
        lc.emit("received", (1, "v"))
        lc.emit("completed", (1, "v"), latency_ms=0.0)
        lc.attach(good=lambda: {"x": 1}, bad=lambda: 1 / 0, gone=None)
        path = tmp_path / f"{name}.json"
        doc = lc.dump(str(path), reason="drill")
        on_disk = json.loads(path.read_text())
        assert on_disk["reason"] == "drill" and on_disk["good"] == {"x": 1}
        assert "provider_error" in on_disk["bad"] and "gone" not in on_disk
        assert on_disk["events"][0]["id"] == repr((1, "v"))
        assert doc["schema"] == 1
        docs.append({k: v for k, v in on_disk.items() if k != "wall_time"})
    assert docs[0] == docs[1]
    for reg in regs:
        assert reg.counter("lifecycle_dumps") == 1
        assert reg.counter("lifecycle_events") == 2


def _trace_events(d):
    out = []
    for f in sorted(os.listdir(d)):
        if f.startswith("trace_"):
            out += json.load(open(os.path.join(d, f)))["traceEvents"]
    return out


def test_async_mirror_and_spans_match_the_references(tmp_path):
    shapes = []
    for mod, lc_cls, sub in ((ref_spans, ref_lc_mod.LifecycleTracer, "r"),
                             (None, LifecycleTracer, "p")):
        d = tmp_path / sub
        tracer = (mod.SpanTracer if mod else SpanTracer)(str(d))
        lc = lc_cls(tracer=tracer, clock=lambda: 0.0)
        lc.emit("received", 5)
        lc.emit("queued", 5)
        lc.emit("completed", 5, latency_ms=0.0)
        with (mod.trace_span if mod else trace_span)(tracer, "serve.admit",
                                                     slot=1):
            pass
        tracer.instant("fault", kind="x")
        with pytest.raises(ValueError):
            tracer.async_event("x", "request", 5)
        tracer.close()
        tracer.instant("after_close")        # dropped, never raises
        evs = _trace_events(d)
        shapes.append(sorted((e["ph"], e["name"], e.get("cat"),
                              e.get("id"), tuple(sorted(e)))
                             for e in evs if e["ph"] != "M"))
        req = {e["ph"]: e for e in evs if e.get("cat") == "request"}
        assert req["b"]["name"] == req["e"]["name"] == "request"
        assert req["n"]["name"] == "queued"
        files = os.listdir(d)
        assert len(files) == 1 and files[0].startswith(f"trace_{os.getpid()}r")
    assert shapes[0] == shapes[1]
    assert trace_span(None, "x") is NULL_SPAN


def test_span_tracer_rotates_into_part_files(tmp_path):
    tracer = SpanTracer(str(tmp_path), max_buffered_events=1000)
    for i in range(2500):
        with tracer.span("s", i=i):
            pass
    tracer.close()
    files = sorted(os.listdir(tmp_path))
    run = tracer._run
    assert files == sorted([f"trace_{os.getpid()}r{run}.json",
                            f"trace_{os.getpid()}r{run}_part1.json",
                            f"trace_{os.getpid()}r{run}_part2.json"])
    spans = [e for e in _trace_events(tmp_path) if e["ph"] == "X"]
    assert len(spans) == 2500
    # Every part names its threads.
    for f in files:
        doc = json.load(open(tmp_path / f))
        assert any(e["name"] == "thread_name"
                   for e in doc["traceEvents"])
        assert doc["otherData"]["pid"] == os.getpid()


# -- a traced twin run -------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(3)
    feats = [jnp.asarray(rng.normal(size=(N,) + s).astype(np.float32))
             for s in FEAT_SHAPES]
    jm = JaxCaptionModel(vocab_size=V, embed_size=E, hidden_size=H,
                         attn_size=A, dropout_rate=0.0,
                         decode_kernel="pallas")
    variables = jm.init(jax.random.PRNGKey(0), feats,
                        np.zeros((N, MAX_LEN), np.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params = {**params, "logit": {**params["logit"]}}
    params["logit"]["bias"] = params["logit"]["bias"].copy()
    params["logit"]["bias"][0] += 0.2
    rng = np.random.default_rng(0)
    videos = [(rng.normal(size=(N,) + s) * 2.0).astype(np.float32)
              for s in FEAT_SHAPES]
    return types.SimpleNamespace(
        jm=jm, variables={"params": params},
        model=model_from_flax(params, device="cpu", decode_kernel="fused"),
        video=lambda i: [v[i % N] for v in videos])


@pytest.fixture()
def fixed_host_clock(monkeypatch):
    """Both engines time admission and chunks on the host clock; a fixed
    one makes ``admit_ms`` 0 in both streams, so attribution compares
    exactly (the fake scheduling clock carries every other timestamp)."""
    for mod in (engine_mod, ref_engine_mod):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda: 0.0, monotonic=mod.time.monotonic))


@pytest.mark.parametrize("beam_size,plan", [
    (1, "serve_wedge@req=1,serve_garble@req=2,admit_err@req=3"),
    (3, "serve_garble@req=0"),
])
def test_traced_twin_equals_the_reference(world, fixed_host_clock,
                                          beam_size, plan):
    clocks = [FakeClock(), FakeClock()]
    lcs = [ref_lc_mod.LifecycleTracer(clock=clocks[0]),
           LifecycleTracer(clock=clocks[1])]
    plans = [RefFaultPlan.parse(plan), FaultPlan.parse(plan)]
    common = dict(max_len=MAX_LEN, beam_size=beam_size, decode_chunk=CHUNK,
                  bucket_sizes=(2,), queue_limit=5, recover=True,
                  retry_limit=0 if beam_size > 1 else 2, deadline_ms=0.0)
    engines = [JaxEngine(world.jm, world.variables, list(FEAT_SHAPES),
                         fault_plan=plans[0], lifecycle=lcs[0],
                         clock=clocks[0], **common),
               ServingEngine(world.model, FEAT_SHAPES, fault_plan=plans[1],
                             lifecycle=lcs[1], clock=clocks[1], **common)]
    done = [[], []]
    for i in range(N):
        ok = [e.submit(i, world.video(i),
                       meta={"trace": {"id": f"t{i}"}},
                       **({"deadline_ms": 400.0} if i == 4 else {}))
              for e in engines]
        assert ok[0] == ok[1]
    while not all(e.idle for e in engines):
        for k, e in enumerate(engines):
            done[k] += [(c.request_id, c.tokens.tolist(), c.latency_s)
                        for c in e.step()]
            e.pop_dropped()
            clocks[k].t += 0.5
    assert done[1] == done[0]
    ref_lc, lc = lcs

    def chains(t):
        out = {}
        for ev in t.events():
            out.setdefault(ev["id"], []).append(ev["kind"])
        return out

    assert chains(lc) == chains(ref_lc)
    strip = ("admit_ms",)
    assert [{k: v for k, v in e.items() if k not in strip}
            for e in lc.events()] == \
        [{k: v for k, v in e.items() if k not in strip}
         for e in ref_lc.events()]
    assert lc.accounting() == ref_lc.accounting()
    assert lc.accounting()["terminal_ok"]
    rep = lc.attribution_report()
    assert rep == ref_lc.attribution_report()
    assert rep["reconcile_ok"] and rep["max_residual_ms"] < 1e-6
    kinds = {e["kind"] for e in lc.events()}
    assert {"shed", "retry", "completed"} <= kinds
    if beam_size == 1:
        assert "dropped" in kinds    # request 4's deadline
    assert {e.get("trace_id") for e in lc.events()
            if e["kind"] == "received"} == {f"t{i}" for i in range(N)}
    assert engines[1].stats()["attribution"] == rep


#: The port engine's stats() keys before lifecycle tracing existed.
UNTRACED_STATS_KEYS = {
    "slots", "buckets", "beam_size", "decode_chunk", "decode_kernel",
    "residents", "queue_depth", "submitted", "completed", "shed",
    "rejected_drain", "chunk_dispatches", "decode_steps",
    "decode_ms_per_step", "admit_ms_total", "latency_p50_ms",
    "latency_p99_ms", "latency_mean_ms", "kernel_launches", "expired",
    "deadline_shed", "chunk_retries", "rebuilds", "rebuild_recompiles",
    "garble_detected", "wedge_detected", "admit_errors",
    "replay_divergence", "cache_armed", "cache_hits", "cache_misses",
    "cache_evictions", "cache_bypass", "cache_errors", "cache_entries",
    "cache_capacity", "stream_chunks", "ttft_p50_ms", "ttft_p99_ms",
    "chunk_gap_p50_ms", "chunk_gap_p99_ms"}


def test_untraced_engine_keeps_its_stats_shape(world):
    eng = ServingEngine(world.model, FEAT_SHAPES, max_len=MAX_LEN,
                        decode_chunk=CHUNK, bucket_sizes=(1,),
                        queue_limit=0)
    eng.submit(0, world.video(0))
    eng.run_until_idle()
    assert set(eng.stats()) == UNTRACED_STATS_KEYS
    warm = eng.warm()
    assert set(warm) == UNTRACED_STATS_KEYS | {"compiles"}
    assert warm["compiles"] == 0          # the CPU loads no library
    # A fleet replica's view holds no report: its engine reports none.
    lc = LifecycleTracer()
    eng = ServingEngine(world.model, FEAT_SHAPES, max_len=MAX_LEN,
                        decode_chunk=CHUNK, lifecycle=lc.for_replica(0))
    assert set(eng.stats()) == UNTRACED_STATS_KEYS


def test_warm_loads_the_configurations_kernel_library(world, monkeypatch):
    from cst_captioning_tpu_torch.ops import _cuda

    loads = []
    monkeypatch.setattr(_cuda, "load", lambda lib, fn: loads.append((lib,
                                                                     fn)))
    eng = ServingEngine(world.model, FEAT_SHAPES, max_len=MAX_LEN)
    assert eng.kernel_functions() == [("decode_cell",
                                       "decode_cell_forward")]
    eng.device = types.SimpleNamespace(type="cuda")
    eng.warm()
    assert loads == [("decode_cell", "decode_cell_forward")]
    ref_cell = model_from_flax(world.variables["params"], device="cpu",
                               decode_kernel="reference",
                               use_kernel_attention=True)
    assert ServingEngine(ref_cell, FEAT_SHAPES, max_len=MAX_LEN
                         ).kernel_functions() == [
        ("attention", "additive_attention_forward")]
    plain = model_from_flax(world.variables["params"], device="cpu",
                            decode_kernel="reference")
    assert ServingEngine(plain, FEAT_SHAPES,
                         max_len=MAX_LEN).kernel_functions() == []


# -- the server ----------------------------------------------------------------


def _server(world, lc, out, tmp_path, registry=None, **kw):
    kw = {"decode_chunk": CHUNK, **kw}
    engine = ServingEngine(world.model, FEAT_SHAPES, max_len=MAX_LEN,
                           bucket_sizes=(2,), lifecycle=lc,
                           registry=registry, **kw)
    return CaptionServer(engine, Vocab({i: f"w{i}" for i in range(1, V)}),
                         lambda vid: world.video(int(vid)), out=out,
                         lifecycle=lc, registry=registry,
                         blackbox_path=str(tmp_path / "blackbox.json"))


def test_server_stats_and_dump_ops(world, tmp_path):
    registry = MetricsRegistry()
    lc = LifecycleTracer(registry=registry)
    out = io.StringIO()
    server = _server(world, lc, out, tmp_path, registry, queue_limit=1)
    rc = server.run_stdin([json.dumps({"id": 1, "video_id": "1"}),
                           json.dumps({"id": 2, "video_id": "2"}),
                           json.dumps({"op": "stats"}),
                           json.dumps({"op": "dump"}),
                           json.dumps({"op": "dump", "path": str(
                               tmp_path / "other.json")})])
    assert rc == EXIT_OK
    replies = [json.loads(ln) for ln in out.getvalue().splitlines()]
    stats = next(r for r in replies if r.get("op") == "stats")
    assert "attribution" in stats and "queue_depth" in stats
    dumps = [r for r in replies if r.get("op") == "dump"]
    assert [d["path"] for d in dumps] == [str(tmp_path / "blackbox.json"),
                                          str(tmp_path / "other.json")]
    doc = json.loads((tmp_path / "blackbox.json").read_text())
    assert doc["schema"] == 1 and doc["reason"] == "wire_dump"
    assert registry.counter("serve_dump_queries") == 2
    shed = next(r for r in replies if r.get("error") == "shed")
    chains = {}
    for e in lc.events():
        chains.setdefault(e["id"], []).append(e["kind"])
    ok_id = (1, "1") if shed["id"] == 2 else (2, "2")
    assert chains[ok_id][0] == "received"
    assert chains[ok_id][-1] == "responded"
    assert "completed" in chains[ok_id]
    shed_id = (shed["id"], shed["video_id"])
    assert chains[shed_id] == ["received", "shed", "responded"]
    assert lc.accounting()["terminal_ok"]


def test_server_dump_errors(world, tmp_path):
    out = io.StringIO()
    server = _server(world, None, out, tmp_path)
    server.run_stdin([json.dumps({"op": "dump"})])
    assert json.loads(out.getvalue())["error"] == "no_recorder"
    out = io.StringIO()
    server = _server(world, LifecycleTracer(), out, tmp_path)
    server.blackbox_path = None
    server.run_stdin([json.dumps({"op": "dump"})])
    assert json.loads(out.getvalue())["error"] == "no_path"


def test_aborted_drain_writes_the_blackbox(world, tmp_path):
    lc = LifecycleTracer()
    out = io.StringIO()
    server = _server(world, lc, out, tmp_path, decode_chunk=1)

    class Handler:
        requested = True
        signal_count = 1

    server.handler = Handler()
    engine = server.engine
    for i in range(4):
        engine.submit((i, str(i)), world.video(i),
                      meta={"id": i, "video_id": str(i)})
    engine.step()
    real = engine.step

    def second_signal():
        server.handler.signal_count += 1
        return real()

    engine.step = second_signal
    assert server._drain_and_exit() == EXIT_SIGTERM
    doc = json.loads((tmp_path / "blackbox.json").read_text())
    assert doc["reason"] == "drain_abort"
    assert doc["accounting"]["terminal_ok"]
    assert doc["accounting"]["submitted"] == 4
    drops = [e for e in lc.events() if e["kind"] == "dropped"]
    assert {e["where"] for e in drops} == {"drain", "drain_abort"}


def test_stream_on_a_full_length_chunk_warns_once(world, tmp_path, capsys,
                                                  monkeypatch):
    monkeypatch.setattr(server_mod, "_warned_stream_legacy", False)
    out = io.StringIO()
    server = _server(world, None, out, tmp_path, decode_chunk=0)
    server.run_stdin([json.dumps({"id": i, "video_id": str(i),
                                  "op": "stream"}) for i in range(3)])
    err = capsys.readouterr().err
    assert err.count("--decode_chunk 0") == 1
    finals = [json.loads(ln) for ln in out.getvalue().splitlines()
              if json.loads(ln).get("final")]
    assert len(finals) == 3
    assert all(r["chunks"] <= 1 for r in finals)
    server = _server(world, None, io.StringIO(), tmp_path)
    server.run_stdin([json.dumps({"id": 0, "video_id": "0",
                                  "op": "stream"})])
    assert "--decode_chunk 0" not in capsys.readouterr().err


# -- the serve CLI ------------------------------------------------------------


def _serve_cmd(*extra):
    return [sys.executable, "-m", "cst_captioning_tpu_torch.serve",
            "--serve_demo", "1", "--device", "cpu", "--rnn_size", "16",
            "--input_encoding_size", "16", "--att_size", "16",
            "--vocab_size", "20", "--feat_shapes", "4x16,1x8",
            "--beam_size", "1", *extra]


def _env():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop(locksan.ENV_FLAG, None)
    return env


def test_cli_writes_the_blackbox_before_exit_124(tmp_path):
    box = tmp_path / "box.json"
    lines = "".join(json.dumps({"id": i, "video_id": f"v{i}"}) + "\n"
                    for i in range(3))
    proc = subprocess.run(
        _serve_cmd("--serve_retry_limit", "0", "--serve_rebuild_limit", "0",
                   "--fault_plan", "serve_wedge@req=0",
                   "--serve_demo_eos_bias", "-50", "--serve_blackbox",
                   str(box)),
        input=lines, capture_output=True, text=True, timeout=120, cwd=REPO,
        env=_env())
    assert proc.returncode == EXIT_WEDGE, proc.stderr[-2000:]
    assert f"serve: blackbox written to {box}" in proc.stderr
    doc = json.loads(box.read_text())
    assert doc["reason"] == "unrecoverable"
    assert {"health", "counters", "kernels", "accounting"} <= set(doc)
    kinds = [e["kind"] for e in doc["events"]]
    assert "retry" in kinds and "received" in kinds
    assert doc["counters"]["serve_wedge_detected"] == 1


def test_cli_defaults_arm_lifecycle_and_trace(tmp_path):
    trace_dir = tmp_path / "trace"
    result = tmp_path / "result.json"
    lines = "".join(json.dumps({"id": i, "video_id": f"v{i}"}) + "\n"
                    for i in range(4)) + json.dumps(
        {"op": "dump", "path": str(tmp_path / "bb.json")}) + "\n"
    proc = subprocess.run(
        _serve_cmd("--trace_dir", str(trace_dir), "--result_file",
                   str(result)),
        input=lines, capture_output=True, text=True, timeout=120, cwd=REPO,
        env=_env())
    assert proc.returncode == EXIT_OK, proc.stderr[-2000:]
    assert "lifecycle 1" in proc.stderr
    stats = json.loads([ln for ln in proc.stderr.splitlines()
                        if ln.startswith("serve: {")][-1][len("serve: "):])
    assert stats["attribution"]["requests"] == 4
    assert stats["attribution"]["reconcile_ok"]
    doc = json.loads(result.read_text())
    assert doc["stats"]["completed"] == 4
    assert doc["health"]["op"] == "health"
    assert doc["telemetry"]["counters"]["lifecycle_dumps"] == 1
    evs = _trace_events(trace_dir)
    names = {e["name"] for e in evs}
    assert {"serve.admit", "serve.decode_chunk", "request"} <= names
    assert json.loads((tmp_path / "bb.json").read_text())["reason"] == \
        "wire_dump"
    off = subprocess.run(_serve_cmd("--serve_lifecycle", "0"), input=lines,
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=_env())
    assert off.returncode == EXIT_OK
    dump = [json.loads(ln) for ln in off.stdout.splitlines()
            if '"op": "dump"' in ln]
    assert dump[0]["error"] == "no_recorder"
    assert "attribution" not in json.loads(
        [ln for ln in off.stderr.splitlines()
         if ln.startswith("serve: {")][-1][len("serve: "):])
