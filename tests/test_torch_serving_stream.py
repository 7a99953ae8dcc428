"""Port's streaming and exact-result cache against the reference engine.

Twins as in ``test_torch_serving_resilience.py``: a reference
``ServingEngine`` (the Pallas decode cell, interpreted on the CPU) and a
port ``ServingEngine`` (K2's plain version) on the same weights, driven
with the same requests and fake-clock ticks.  Their stream chunks (seq,
tokens), completions and cache counters must be equal.  Then the
port's own contracts: each stream concatenates to its caption, also
across a rebuild; a cache hit runs no admission, no chunk and no decode
step; the cache's identity and fingerprints; the stream wire format;
the bench probe's stream and cache records.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.resilience.faults import FaultPlan as RefFaultPlan
from cst_captioning_tpu.serving import cache as ref_cache
from cst_captioning_tpu.serving.buckets import config_key as ref_config_key
from cst_captioning_tpu.serving.engine import ServingEngine as JaxEngine
from cst_captioning_tpu.telemetry.registry import \
    MetricsRegistry as RefRegistry
from cst_captioning_tpu_torch.data.vocab import Vocab
from cst_captioning_tpu_torch.ops import launch_counts
from cst_captioning_tpu_torch.ops.beam import beam_search
from cst_captioning_tpu_torch.ops.sampling import greedy_decode
from cst_captioning_tpu_torch.resilience.faults import FaultPlan
from cst_captioning_tpu_torch.serving import bench as serving_bench
from cst_captioning_tpu_torch.serving import engine as engine_mod
from cst_captioning_tpu_torch.serving.buckets import config_key
from cst_captioning_tpu_torch.serving.cache import (ResultCache,
                                                    feature_fingerprint,
                                                    params_fingerprint)
from cst_captioning_tpu_torch.serving.engine import (COUNTERS, Dropped,
                                                     ServingEngine,
                                                     _trim_eos)
from cst_captioning_tpu_torch.serving.server import CaptionServer
from cst_captioning_tpu_torch.telemetry.registry import MetricsRegistry
from cst_captioning_tpu_torch.weights import model_from_flax, to_flax

N, H, E, A, V, MAX_LEN, CHUNK = 6, 16, 12, 16, 30, 8, 2
FEAT_SHAPES = ((4, 8), (1, 5))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _with_bias(params, eos_bias):
    params = {**params, "logit": {**params["logit"]}}
    params["logit"]["bias"] = params["logit"]["bias"].copy()
    params["logit"]["bias"][0] += eos_bias
    return params


class World:
    """Reference model and variables, the port's model on the same
    weights, ``N`` seeded requests."""

    def __init__(self, jm, params, eos_bias, seed, decode_kernel="fused"):
        params = _with_bias(params, eos_bias)
        self.jm = jm
        self.params = params
        self.variables = {"params": params}
        self.model = model_from_flax(params, device="cpu",
                                     decode_kernel=decode_kernel)
        rng = np.random.default_rng(seed)
        self.feats = [(rng.normal(size=(N,) + s) * 2.0).astype(np.float32)
                      for s in FEAT_SHAPES]

    def request(self, i):
        return [f[i % N] for f in self.feats]

    def offline(self, beam_size=1, length_norm=0.0):
        feats = [torch.from_numpy(f) for f in self.feats]
        if beam_size == 1:
            return greedy_decode(self.model, feats, MAX_LEN).numpy()
        return beam_search(self.model, feats, beam_size, MAX_LEN,
                           length_norm=length_norm)[0].numpy()


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
    """A mild EOS bias: most captions run several chunks, some end
    early."""
    w = World(*params, eos_bias=0.0, seed=0)
    lengths = [len(_trim_eos(t)) for t in w.offline()]
    assert max(lengths) > 2 * CHUNK and len(set(lengths)) > 1, lengths
    return w


class Twin:
    """A reference engine and a port engine driven in lockstep."""

    def __init__(self, w: World, *, plan=None, cache=None, beam_size=1,
                 **kw):
        self.w = w
        self.clocks = [FakeClock(), FakeClock()]
        self.registries = [RefRegistry(), MetricsRegistry()]
        common = dict(max_len=MAX_LEN, beam_size=beam_size,
                      decode_chunk=CHUNK, bucket_sizes=(2,), queue_limit=0)
        common.update(kw)
        plans = (None, None)
        if plan:
            plans = (RefFaultPlan.parse(plan), FaultPlan.parse(plan))
            for p, reg in zip(plans, self.registries):
                p.bind_metrics(reg)
        caches = (None, None) if cache is None else (
            ref_cache.ResultCache(cache), ResultCache(cache))
        self.engines = [
            JaxEngine(w.jm, w.variables, list(FEAT_SHAPES), **common,
                      fault_plan=plans[0], result_cache=caches[0],
                      registry=self.registries[0], clock=self.clocks[0]),
            ServingEngine(w.model, FEAT_SHAPES, **common,
                          fault_plan=plans[1], result_cache=caches[1],
                          registry=self.registries[1],
                          clock=self.clocks[1])]
        self.done = [[], []]
        self.drops = [[], []]
        self.chunks = [[], []]

    @property
    def port(self) -> ServingEngine:
        return self.engines[1]

    def submit(self, i, video=None, **kw):
        ok = [e.submit(i, self.w.request(i if video is None else video),
                       **kw) for e in self.engines]
        assert ok[0] == ok[1]
        return ok[1]

    def step(self):
        for k, e in enumerate(self.engines):
            e._chunk_wall.clear()          # no wall-time shed floor
            comps = e.step()
            self.done[k] += [(c.request_id, np.asarray(c.tokens).tolist(),
                              c.slot, c.latency_s, c.decode_steps,
                              c.cache_hit, c.stream_chunks, c.ttft_s)
                             for c in comps]
            self.drops[k] += [(d.request_id, d.reason, d.where)
                              for d in e.pop_dropped()]
            self.chunks[k] += [(c.request_id, c.seq,
                                np.asarray(c.tokens).tolist())
                               for c in e.pop_stream_chunks()]

    def tick(self, dt):
        for c in self.clocks:
            c.t += dt

    def run(self, dt=0.0):
        while not all(e.idle for e in self.engines):
            self.step()
            self.tick(dt)

    def check(self):
        assert self.done[1] == self.done[0]
        assert self.drops[1] == self.drops[0]
        assert self.chunks[1] == self.chunks[0]
        ref, port = (r.snapshot()["counters"] for r in self.registries)
        names = [n for n in ref if n in COUNTERS or n.startswith("fault_")]
        assert {n: port.get(n) for n in names} == {n: ref[n] for n in names}
        rs, ps = (e.stats() for e in self.engines)
        for key in list(self.port.recovery_counters()) + [
                k for k in ps if k.startswith(("cache_", "stream_",
                                               "ttft_", "chunk_gap_"))]:
            assert ps[key] == rs[key], key
        return {c[0]: c for c in self.done[1]}

    def stream_of(self, rid):
        mine = sorted((c for c in self.chunks[1] if c[0] == rid),
                      key=lambda c: c[1])
        assert [c[1] for c in mine] == list(range(len(mine)))
        return [t for c in mine for t in c[2]]


# -- streaming ---------------------------------------------------------------


def test_greedy_stream_chunks_equal_the_references(world):
    twin = Twin(world)
    for i in range(N):
        assert twin.submit(i, stream=True)
    twin.run(dt=0.25)
    done = twin.check()
    offline = world.offline()
    multi = 0
    for i in range(N):
        assert done[i][1] == offline[i].tolist()
        assert twin.stream_of(i) == _trim_eos(offline[i]).tolist()
        n = sum(1 for c in twin.chunks[1] if c[0] == i)
        assert done[i][6] == n
        multi += n > 1
    assert multi >= 2, "streams should span several chunks"
    assert all(0 not in c[2] for c in twin.chunks[1])


def test_beam_streams_one_terminal_chunk(world):
    twin = Twin(world, beam_size=3, length_norm=0.7)
    for i in range(N):
        twin.submit(i, stream=True)
    twin.run(dt=0.25)
    done = twin.check()
    offline = world.offline(beam_size=3, length_norm=0.7)
    for i in range(N):
        assert done[i][1] == offline[i].tolist()
        mine = [c for c in twin.chunks[1] if c[0] == i]
        assert len(mine) == (1 if _trim_eos(offline[i]).size else 0)
        assert twin.stream_of(i) == _trim_eos(offline[i]).tolist()


def test_ttft_and_gap_percentiles_on_the_fake_clock(world):
    offline = world.offline()
    long_ix = int(np.argmax([len(_trim_eos(t)) for t in offline]))
    n_tokens = len(_trim_eos(offline[long_ix]))
    assert n_tokens > 2 * CHUNK, "the drill needs a caption of 3+ chunks"
    twin = Twin(world, bucket_sizes=(1,))
    twin.submit(0, video=long_ix, stream=True)
    twin.tick(3.0)
    twin.run(dt=1.0)
    done = twin.check()
    comp = done[0]
    chunks = comp[6]
    assert chunks == -(-n_tokens // CHUNK) and chunks >= 3
    assert comp[7] == pytest.approx(3.0)               # TTFT
    stats = twin.port.stats()
    assert stats["ttft_p50_ms"] == pytest.approx(3000.0)
    assert stats["chunk_gap_p50_ms"] == stats["chunk_gap_p99_ms"] == \
        pytest.approx(1000.0)
    snap = twin.registries[1].snapshot()
    assert snap["counters"]["serve_stream_chunks"] == chunks
    assert snap["histograms"]["serve_ttft_ms"]["count"] == 1
    assert snap["histograms"]["serve_chunk_gap_ms"]["count"] == chunks - 1
    assert list(twin.port._ttft) == [3.0]
    assert list(twin.port._gaps) == [1.0] * (chunks - 1)


@pytest.mark.parametrize("fault", ["serve_wedge", "serve_garble"])
def test_stream_concatenates_to_caption_across_a_rebuild(world, fault):
    """Request 0 streams its first chunk; request 1's fault goes straight
    to a rebuild (retry_limit 0); the replay re-emits nothing and the
    chunks still concatenate to the caption."""
    offline = world.offline()
    lengths = [len(_trim_eos(t)) for t in offline]
    long_ix = int(np.argmax(lengths))
    assert lengths[long_ix] > 2 * CHUNK, "the drill needs 3+ chunks"
    twin = Twin(world, plan=f"{fault}@req=1", recover=True, retry_limit=0,
                rebuild_limit=2)
    twin.submit(0, video=long_ix, stream=True)
    twin.step()
    assert [c[:2] for c in twin.chunks[1]] == [(0, 0)], \
        "nothing streamed before the rebuild"
    twin.submit(1, video=(long_ix + 1) % N, stream=True)
    twin.run(dt=0.5)
    done = twin.check()
    stats = twin.port.stats()
    assert stats["rebuilds"] == 1 and stats["replay_divergence"] == 0
    assert done[0][1] == offline[long_ix].tolist()
    for rid in (0, 1):
        assert twin.stream_of(rid) == _trim_eos(done[rid][1]).tolist()


# -- the result cache --------------------------------------------------------


@pytest.mark.parametrize("beam_size", [1, 3])
def test_cache_hit_is_identical_and_does_no_decode(world, beam_size,
                                                   monkeypatch):
    calls = {"decode_steps": 0}
    real = engine_mod.make_decode_step

    def counting(*a, **k):
        step = real(*a, **k)

        def wrapped(carry, tok):
            calls["decode_steps"] += 1
            return step(carry, tok)

        return wrapped

    monkeypatch.setattr(engine_mod, "make_decode_step", counting)
    twin = Twin(world, cache=8, beam_size=beam_size)
    counters0 = twin.registries[1].snapshot()["counters"]
    for name in ("serve_cache_hits", "serve_cache_misses",
                 "serve_cache_evictions", "serve_cache_bypass",
                 "serve_cache_errors", "serve_stream_chunks"):
        assert counters0[name] == 0
    for i in range(N):
        twin.submit(i)
    twin.run(dt=0.1)
    s1 = twin.port.stats()
    assert s1["cache_misses"] == N and s1["cache_hits"] == 0
    admitted = twin.registries[1].counter("serve_admitted")
    steps, launches = calls["decode_steps"], launch_counts()
    for i in range(N):
        twin.submit(100 + i, video=i, stream=(i % 2 == 0))
    twin.run(dt=0.1)
    done = twin.check()
    s2 = twin.port.stats()
    assert s2["cache_hits"] == N
    assert s2["chunk_dispatches"] == s1["chunk_dispatches"]
    assert twin.registries[1].counter("serve_admitted") == admitted
    assert calls["decode_steps"] == steps and launch_counts() == launches
    for i in range(N):
        hit = done[100 + i]
        assert hit[5] and hit[4] == 0 and hit[2] == -1
        assert hit[1] == done[i][1]
        if i % 2 == 0:
            assert twin.stream_of(100 + i) == _trim_eos(done[i][1]).tolist()


def test_cache_lru_eviction(world):
    twin = Twin(world, cache=2, bucket_sizes=(1,))
    for i in range(3):
        twin.submit(i)
        twin.run()
    s = twin.port.stats()
    assert s["cache_evictions"] == 1 and s["cache_entries"] == 2
    twin.submit(10, video=0)                  # evicted: a miss again
    twin.run()
    twin.submit(11, video=2)                  # still held: a hit
    twin.run()
    twin.check()
    s = twin.port.stats()
    assert (s["cache_misses"], s["cache_hits"]) == (4, 1)


def test_cache_identity_changes_force_a_miss(params, world):
    cache = ResultCache(32)

    def run(model, **kw):
        eng = ServingEngine(model, FEAT_SHAPES, **{
            **dict(max_len=MAX_LEN, decode_chunk=CHUNK, bucket_sizes=(2,),
                   queue_limit=0, result_cache=cache), **kw})
        eng.submit(0, world.request(0))
        eng.run_until_idle()
        return eng.stats()["cache_hits"], eng.stats()["cache_misses"]

    assert run(world.model) == (0, 1)
    assert run(world.model) == (1, 0)                 # the same: a hit
    assert run(world.model, beam_size=2) == (0, 1)    # beam
    assert run(world.model, decode_chunk=4) == (0, 1)
    reference_cell = model_from_flax(world.params, device="cpu",
                                     decode_kernel="reference")
    assert run(reference_cell) == (0, 1)              # kernel
    k1 = model_from_flax(world.params, device="cpu",
                         decode_kernel="reference",
                         use_kernel_attention=True)
    assert run(k1) == (0, 1)                          # K1 in the cell
    other = model_from_flax(_with_bias(world.params, 1.0), device="cpu",
                            decode_kernel="fused")
    assert run(other) == (0, 1)                       # weights


def test_cache_bypass_and_undecoded_requests_are_no_misses(world):
    clock = FakeClock()
    eng = ServingEngine(world.model, FEAT_SHAPES, max_len=MAX_LEN,
                        decode_chunk=CHUNK, bucket_sizes=(1,),
                        queue_limit=2, result_cache=ResultCache(8),
                        clock=clock)
    eng.submit(0, world.request(0))
    first = eng.run_until_idle()
    eng.submit(1, world.request(0), no_cache=True)
    bypassed = eng.run_until_idle()
    assert not bypassed[0].cache_hit
    assert np.array_equal(bypassed[0].tokens, first[0].tokens)
    # Shed and expired requests never decode: no miss, no entry.
    assert [eng.submit(i, world.request(i)) for i in (2, 3, 4)] == \
        [True, True, False]
    eng.run_until_idle()
    eng.submit(5, world.request(5), deadline_ms=500)
    clock.t = 1.0
    assert eng.run_until_idle() == []
    assert [(d.request_id, d.reason) for d in eng.pop_dropped()] == \
        [(5, "expired")]
    s = eng.stats()
    assert s["cache_bypass"] == 1 and s["shed"] == 1
    assert s["cache_misses"] == 3 and s["cache_entries"] == 3


def test_expired_queued_request_is_no_miss(world):
    twin = Twin(world, cache=8, bucket_sizes=(1,))
    twin.submit(0, deadline_ms=500)
    twin.tick(1.0)
    twin.run()
    twin.check()
    assert twin.drops[1] == [(0, "expired", "queued")]
    s = twin.port.stats()
    assert s["cache_misses"] == 0 and s["cache_entries"] == 0


def test_serve_cache_fault_is_absorbed(world):
    """req 0 decodes video 0, req 1 hits, req 2's lookup fails: it
    decodes fresh, the same caption, and health reads degraded."""
    twin = Twin(world, cache=8, plan="serve_cache@req=2", recover=True)
    for rid in range(3):
        twin.submit(rid, video=0)
        twin.run()
    done = twin.check()
    s = twin.port.stats()
    assert s["cache_hits"] == 1 and s["cache_errors"] == 1
    assert done[1][5] and not done[2][5]
    assert done[0][1] == done[1][1] == done[2][1]
    assert twin.port.health()["status"] == "degraded"
    counters = twin.registries[1].snapshot()["counters"]
    assert counters["serve_cache_errors"] == counters["fault_serve_cache"] \
        == 1


def test_fingerprints_and_identity_equal_the_references(world):
    assert params_fingerprint(world.model) == \
        ref_cache.params_fingerprint(world.variables)
    # bfloat16 compute over float32 parameters: the same fingerprint.
    bf16 = model_from_flax(world.params, device="cpu", decode_kernel="fused",
                           dtype=torch.bfloat16)
    assert params_fingerprint(bf16) == params_fingerprint(world.model)
    assert to_flax(world.model)["logit"]["bias"].dtype == np.float32
    feats = world.request(2)
    assert feature_fingerprint(feats) == ref_cache.feature_fingerprint(feats)
    nudged = [f.copy() for f in feats]
    nudged[0][0, 0] = np.nextafter(nudged[0][0, 0], np.inf)
    assert feature_fingerprint(nudged) != feature_fingerprint(feats)
    kw = dict(bucket=0, beam_size=3, max_len=30, decode_chunk=8,
              length_norm=0.7, decode_kernel="fused", scan_unroll=1,
              feat_shapes=[(28, 2048), (1, 4096)], dtype="float32",
              kind="result")
    assert config_key(**kw) == ref_config_key(**kw)


def test_result_cache_semantics_equal_the_references():
    mine, ref = ResultCache(2), ref_cache.ResultCache(2)
    row = np.arange(5, dtype=np.int32)
    for c in (mine, ref):
        assert c.put(("a",), row) == 0 and c.put(("b",), row + 1) == 0
        got = c.get(("a",))
        got[0] = 99                            # a copy
        assert c.get(("a",))[0] == 0
        assert c.put(("c",), row + 2) == 1     # evicts b, the LRU
        assert c.get(("b",)) is None
        assert c.invalidate(("a",)) and not c.invalidate(("a",))
        assert len(c) == 1 and c.stats() == {"size": 1, "capacity": 2}
    assert ResultCache(0).put(("x",), row) == 0


# -- the wire format ---------------------------------------------------------


def _server(world, engine, out):
    vocab = Vocab({i: f"w{i}" for i in range(1, V)})
    return CaptionServer(engine, vocab, lambda vid: world.request(int(vid)),
                         out=out)


def test_stream_wire_format_and_cached_repeat(world):
    engine = ServingEngine(world.model, FEAT_SHAPES, max_len=MAX_LEN,
                           decode_chunk=CHUNK, bucket_sizes=(2,),
                           queue_limit=0, result_cache=ResultCache(4))
    long_ix = int(np.argmax([len(_trim_eos(t)) for t in world.offline()]))
    out = io.StringIO()
    rc = _server(world, engine, out).run_stdin([
        json.dumps({"id": 1, "video_id": str(long_ix), "op": "stream",
                    "idem": "k1"}),
        json.dumps({"id": 2, "video_id": "2"})])
    assert rc == 0
    replies = [json.loads(ln) for ln in out.getvalue().splitlines()]
    mine = [r for r in replies if r["id"] == 1]
    final, parts = mine[-1], mine[:-1]
    assert final["final"] is True and final["stream"] is True
    assert final["idem"] == "k1" and "idem" not in parts[0]
    assert len(parts) >= 2
    assert all(r["stream"] and r["final"] is False for r in parts)
    assert [r["seq"] for r in parts] == list(range(len(parts)))
    assert final["chunks"] == len(parts) and final["ttft_ms"] >= 0
    assert " ".join(r["text"] for r in parts) == final["caption"]
    assert [t for r in parts for t in r["tokens"]] == \
        _trim_eos(world.offline()[long_ix]).tolist()
    plain = [r for r in replies if r["id"] == 2][-1]
    assert "stream" not in plain and "caption" in plain

    out2 = io.StringIO()
    rc = _server(world, engine, out2).run_stdin([json.dumps(
        {"id": 3, "video_id": str(long_ix), "op": "stream"})])
    assert rc == 0
    replies2 = [json.loads(ln) for ln in out2.getvalue().splitlines()]
    assert len(replies2) == 2
    chunk, final2 = replies2
    assert final2["cached"] is True and final2["final"] is True
    assert final2["caption"] == final["caption"]
    assert final2["decode_steps"] == 0 and final2["chunks"] == 1
    assert chunk["text"] == final["caption"] and chunk["seq"] == 0


def test_every_stream_gets_one_terminal_line(world, monkeypatch):
    engine = ServingEngine(world.model, FEAT_SHAPES, max_len=MAX_LEN,
                           decode_chunk=CHUNK, bucket_sizes=(1,),
                           queue_limit=0)
    out = io.StringIO()
    server = _server(world, engine, out)
    server._respond_dropped(Dropped(("r", "0"), "deadline_shed", "queued",
                                    meta={"id": "r", "video_id": "0",
                                          "stream": True}))
    obj = json.loads(out.getvalue())
    assert obj == {"id": "r", "video_id": "0", "error": "expired",
                   "stream": True, "final": True, "where": "queued",
                   "why": "deadline_unmeetable"}
    out.seek(0), out.truncate()
    server._respond_dropped(Dropped(("p", "0"), "expired", "queued",
                                    meta={"id": "p", "video_id": "0"}))
    assert "final" not in json.loads(out.getvalue())
    out.seek(0), out.truncate()
    monkeypatch.setattr(engine, "submit", lambda *a, **k: False)
    server._handle_line(json.dumps({"id": 7, "video_id": "0",
                                    "op": "stream"}), server._stdout_respond)
    shed = json.loads(out.getvalue())
    assert (shed["error"], shed["stream"], shed["final"]) == \
        ("shed", True, True)
    monkeypatch.undo()
    engine.submit(8, world.request(0), stream=True,
                  meta={"id": 8, "video_id": "0", "stream": True})
    out.seek(0), out.truncate()
    server.handler = type("H", (), {"requested": True, "signal_count": 0})()
    assert server._drain_and_exit() == 75
    rej = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert rej == [{"id": 8, "video_id": "0", "error": "rejected_draining",
                    "stream": True, "final": True}]


# -- the bench probe ---------------------------------------------------------


def test_probe_stream_and_cache_records(world):
    out = serving_bench.serving_probe(
        world.model, list(FEAT_SHAPES), num_requests=10, rate_hz=20.0,
        max_len=MAX_LEN, decode_chunk=CHUNK, bucket_sizes=(1, 2), seed=4,
        stream=True, cache_size=8, unique_videos=3, zipf_alpha=1.1)
    assert out["completed"] == 10 and out["shed"] == 0
    assert out["unique_videos"] == 3 and out["zipf_alpha"] == 1.1
    st = out["stream"]
    assert st["enabled"] and st["prefix_ok"] and st["chunks"] >= 1
    assert st["ttft_p50_ms"] is not None
    ca = out["cache"]
    assert ca["enabled"] and ca["parity_ok"] and ca["hits"] >= 1
    assert ca["hits"] + ca["misses"] == 10
    assert ca["hit_rate"] == pytest.approx(ca["hits"] / 10)
    assert out["rebuilds"] == out["chunk_retries"] == 0
    plain = serving_bench.serving_probe(
        world.model, list(FEAT_SHAPES), num_requests=4, rate_hz=50.0,
        max_len=MAX_LEN, decode_chunk=CHUNK, bucket_sizes=(1, 2), seed=4)
    assert plain["stream"] == {"enabled": False}
    assert plain["cache"] == {"enabled": False}


def test_probe_fails_on_a_lying_stream(world, monkeypatch):
    real = ServingEngine._emit_stream_delta

    def drop_first(self, res):
        before = res.streamed
        real(self, res)
        if before == 0 and self._stream_chunks:
            self._stream_chunks.pop()

    monkeypatch.setattr(ServingEngine, "_emit_stream_delta", drop_first)
    with pytest.raises(RuntimeError, match="do not concatenate"):
        serving_bench.serving_probe(
            world.model, list(FEAT_SHAPES), num_requests=4, rate_hz=50.0,
            max_len=MAX_LEN, decode_chunk=CHUNK, bucket_sizes=(1, 2),
            seed=4, stream=True)
