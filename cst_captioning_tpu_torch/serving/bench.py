"""Open-loop serving probe: p50/p99 latency and captions/s (counterpart of
the reference's ``serving/bench.py``, single engine).

Open loop: arrivals follow a schedule drawn from a seed before the
probe starts and are never gated on completions, so a slow server grows
its queue instead of slowing its users.  Latency is measured from the
scheduled arrival, so queueing delay is part of it.

Before the clock starts, ``warm_buckets`` runs one engine through every
bucket of the ladder, so every kernel library is built and loaded and
every shape the probe can reach has run once.  While the clock runs no
library may be built or loaded (``ops._cuda.loaded_libraries``); the
probe raises if one is.

The request mix (``zipfian_mix``) and the arrival shapes
(``make_arrivals``: Poisson, diurnal, burst, trace replay) are the
reference's, draw for draw.  ``stream`` streams every request and checks
that each one's chunks concatenate to its caption; ``cache_size`` arms
the exact-result cache and checks every hit against the first decoded
caption of its video.  The warm-up engines run without the cache, so
the probe's first request of each video is a miss.

``replicas`` > 1 drives the same load through a ``FleetRouter`` over that
many engines on the model's one device (they share it), with one result
cache; ``kill_replica`` hard-kills that replica once half the requests
are submitted.  The ``fleet`` record holds every caption against a clean
single engine's decode of the same videos (``parity_ok``).
``lifecycle`` (or ``blackbox_path``) arms the request-lifecycle tracer on
the probe's clock: the ``lifecycle`` record carries its terminal
accounting, ``attribution`` the latency components reconciled against
the engine's latencies, and the blackbox is written at the end.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from ..ops import _cuda, kernel_state
from ..telemetry.lifecycle import LifecycleTracer
from .buckets import DEFAULT_BUCKETS
from .cache import ResultCache
from .engine import ServingEngine, _trim_eos
from .fleet import FleetRouter


def poisson_arrivals(num_requests: int, rate_hz: float,
                     seed: int = 0) -> np.ndarray:
    """Cumulative arrival times (seconds) of an open-loop Poisson stream."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / float(rate_hz),
                                     size=int(num_requests)))


def _thinned_arrivals(num_requests: int, peak_hz: float,
                      rate_at: Callable[[float], float],
                      seed: int) -> np.ndarray:
    """Lewis-Shedler thinning: candidate gaps at the peak rate, each kept
    with probability ``rate_at(t) / peak`` — an exact non-homogeneous
    Poisson process, deterministic per seed."""
    rng = np.random.default_rng(seed)
    out = np.empty(int(num_requests), dtype=np.float64)
    t = 0.0
    k = 0
    peak = float(peak_hz)
    while k < out.size:
        t += rng.exponential(1.0 / peak)
        if rng.random() * peak <= rate_at(t):
            out[k] = t
            k += 1
    return out


def diurnal_arrivals(num_requests: int, rate_hz: float, seed: int = 0,
                     period_s: float = 60.0,
                     depth: float = 0.9) -> np.ndarray:
    """A seeded sinusoid: mean rate ``rate_hz``, swinging ``±depth``
    around it over ``period_s`` (a compressed day)."""
    base = float(rate_hz)
    d = min(max(float(depth), 0.0), 1.0)
    w = 2.0 * np.pi / float(period_s)

    def rate_at(t: float) -> float:
        return base * (1.0 + d * np.sin(w * t))

    return _thinned_arrivals(num_requests, base * (1.0 + d), rate_at, seed)


def burst_arrivals(num_requests: int, rate_hz: float, seed: int = 0,
                   period_s: float = 8.0, duty: float = 0.25,
                   burst_factor: float = 4.0) -> np.ndarray:
    """Square-wave storms: ``rate_hz`` for most of each ``period_s``, a
    ``burst_factor``x storm for the ``duty`` fraction."""
    base = float(rate_hz)
    f = max(1.0, float(burst_factor))
    du = min(max(float(duty), 0.0), 1.0)
    p = float(period_s)

    def rate_at(t: float) -> float:
        return base * f if (t % p) < du * p else base

    return _thinned_arrivals(num_requests, base * f, rate_at, seed)


def replay_arrivals(path: str, num_requests: int) -> np.ndarray:
    """Arrival times from a JSONL trace (one ``{"t": seconds}`` object per
    line), sorted and rebased to 0; the trace must hold at least
    ``num_requests`` events (the rest are dropped)."""
    ts = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                ts.append(float(json.loads(line)["t"]))
    n = int(num_requests)
    if len(ts) < n:
        raise ValueError(
            f"arrival trace {path} has {len(ts)} events, need {n}")
    arr = np.sort(np.asarray(ts, dtype=np.float64))[:n]
    return arr - arr[0]


ARRIVAL_SHAPES = ("poisson", "diurnal", "burst", "replay")


def make_arrivals(shape: str, num_requests: int, rate_hz: float,
                  seed: int = 0,
                  trace_path: Optional[str] = None) -> np.ndarray:
    """Dispatch on ``--arrival_shape``."""
    if shape == "poisson":
        return poisson_arrivals(num_requests, rate_hz, seed)
    if shape == "diurnal":
        return diurnal_arrivals(num_requests, rate_hz, seed)
    if shape == "burst":
        return burst_arrivals(num_requests, rate_hz, seed)
    if shape == "replay":
        if not trace_path:
            raise ValueError("--arrival_shape replay needs --arrival_trace")
        return replay_arrivals(trace_path, num_requests)
    raise ValueError(f"unknown arrival shape {shape!r} (expected "
                     f"{'|'.join(ARRIVAL_SHAPES)})")


def zipfian_mix(num_requests: int, unique_videos: int, alpha: float,
                seed: int = 0) -> np.ndarray:
    """Video index per request: rank-``1/r^alpha`` draws over the unique
    set (``alpha`` <= 0: round-robin, every request its own video when
    ``unique_videos == num_requests``)."""
    n, u = int(num_requests), max(1, int(unique_videos))
    if alpha <= 0:
        return np.arange(n) % u
    ranks = np.arange(1, u + 1, dtype=np.float64)
    p = ranks ** -float(alpha)
    p /= p.sum()
    return np.random.default_rng(seed).choice(u, size=n, p=p)


def warm_buckets(make_engine: Callable[[], ServingEngine],
                 feats: Sequence[Sequence[np.ndarray]]) -> int:
    """One fresh engine per bucket of the ladder, filled to that bucket
    and run to idle: every slot count (and beam rows) the probe can reach
    has run once.  -> the requests decoded."""
    n = 0
    for b in make_engine().buckets:
        engine = make_engine()
        for i in range(b):
            engine.submit(("warm", b, i), feats[i % len(feats)])
        n += len(engine.run_until_idle())
    return n


def serving_probe(model, feat_shapes: Sequence, *, num_requests: int = 24,
                  rate_hz: float = 8.0, max_len: int = 30,
                  beam_size: int = 1, length_norm: float = 0.0,
                  decode_chunk: int = 8,
                  bucket_sizes: Sequence[int] = DEFAULT_BUCKETS,
                  queue_limit: int = 0, seed: int = 0,
                  stream: bool = False, cache_size: int = 0,
                  unique_videos: Optional[int] = None,
                  zipf_alpha: float = 0.0, replicas: int = 1,
                  kill_replica: int = -1, arrival_shape: str = "poisson",
                  arrival_trace: Optional[str] = None,
                  lifecycle: bool = False,
                  blackbox_path: Optional[str] = None,
                  clock: Callable[[], float] = time.perf_counter
                  ) -> Dict[str, Any]:
    """Drive one engine (or a fleet of ``replicas``) through a seeded
    open-loop load; -> metrics.

    Raises ``RuntimeError`` if a kernel library is built or loaded while
    the clock runs (the warm-up must have paid for every one, and a
    restarted replica loads none), if a streamed request's chunks do not
    concatenate to its caption, or if a cache hit differs from its
    video's decoded caption.
    """
    n = int(num_requests)
    uniq = n if unique_videos is None else max(1, min(int(unique_videos), n))
    arrivals = make_arrivals(arrival_shape, n, rate_hz, seed,
                             trace_path=arrival_trace)
    feat_rng = np.random.default_rng(seed + 1)
    feats = [[feat_rng.standard_normal(s).astype(np.float32)
              for s in feat_shapes] for _ in range(uniq)]
    video_of = zipfian_mix(n, uniq, zipf_alpha, seed + 2)

    fleet_n = max(1, int(replicas))
    cache = ResultCache(int(cache_size)) if cache_size else None
    # On the probe's clock, so attribution reconciles with its latencies.
    recorder = (LifecycleTracer(clock=clock)
                if lifecycle or blackbox_path else None)

    def make_engine(cache=None, lc=None) -> ServingEngine:
        return ServingEngine(
            model, feat_shapes, max_len=max_len, beam_size=beam_size,
            length_norm=length_norm, decode_chunk=decode_chunk,
            bucket_sizes=bucket_sizes, queue_limit=queue_limit,
            result_cache=cache, lifecycle=lc, clock=clock)

    def replica_engine(k: int) -> ServingEngine:
        return make_engine(cache, recorder.for_replica(k)
                           if recorder is not None else None)

    t_warm = clock()
    warmed = warm_buckets(make_engine, feats)
    warm_s = clock() - t_warm
    if fleet_n > 1:
        engine = FleetRouter(replica_engine, fleet_n, lifecycle=recorder,
                             clock=clock)
    else:
        engine = make_engine(cache, recorder)
    engine.warm()
    libraries = _cuda.loaded_libraries()
    kill_at = n // 2 if fleet_n > 1 and kill_replica >= 0 else None
    killed = False

    t0 = clock()
    submitted = 0
    latencies: Dict[Any, float] = {}
    tokens: Dict[Any, np.ndarray] = {}
    hit: Dict[Any, bool] = {}
    chunks: Dict[Any, list] = {}
    shed = 0
    dropped = 0
    while len(latencies) + shed + dropped < n:
        now = clock() - t0
        while submitted < n and arrivals[submitted] <= now:
            if not engine.submit(submitted,
                                 feats[int(video_of[submitted])],
                                 stream=stream):
                shed += 1
            submitted += 1
        if kill_at is not None and not killed and submitted >= kill_at:
            # One replica dies with residents aboard; they re-queue and
            # the replica restarts warm.
            engine.kill_replica(int(kill_replica) % fleet_n)
            killed = True
        for comp in engine.step():
            latencies[comp.request_id] = ((comp.done_at - t0)
                                          - arrivals[comp.request_id])
            tokens[comp.request_id] = np.asarray(comp.tokens)
            hit[comp.request_id] = bool(comp.cache_hit)
        # A drop record is an answer (none on a probe without deadlines).
        dropped += len(engine.pop_dropped())
        for ch in engine.pop_stream_chunks():
            chunks.setdefault(ch.request_id, []).append(ch)
        if engine.idle and submitted < n:
            time.sleep(min(max(arrivals[submitted] - (clock() - t0), 0.0),
                           0.01))
    makespan = clock() - t0

    loaded = _cuda.loaded_libraries()
    if loaded != libraries:
        raise RuntimeError(
            f"kernel libraries {sorted(set(loaded) - set(libraries))} were "
            "built or loaded while the serving clock ran; the warm-up must "
            "load every one")
    stats = engine.stats()

    stream_out: Dict[str, Any] = {"enabled": bool(stream)}
    if stream:
        bad = []
        for rid, row in tokens.items():
            mine = sorted(chunks.get(rid, []), key=lambda c: c.seq)
            got = (np.concatenate([c.tokens for c in mine]) if mine
                   else np.zeros((0,), np.int32))
            if not np.array_equal(got, _trim_eos(row)):
                bad.append(rid)
        if bad:
            raise RuntimeError(
                f"streamed chunks do not concatenate to the caption of "
                f"request(s) {bad[:5]}")
        stream_out.update({
            "chunks": stats["stream_chunks"],
            "ttft_p50_ms": stats["ttft_p50_ms"],
            "ttft_p99_ms": stats["ttft_p99_ms"],
            "chunk_gap_p50_ms": stats["chunk_gap_p50_ms"],
            "chunk_gap_p99_ms": stats["chunk_gap_p99_ms"],
            "prefix_ok": True,
        })

    cache_out: Dict[str, Any] = {"enabled": bool(cache_size)}
    if cache_size:
        # Every hit against its twin: the first decoded caption of the
        # same video.
        twin: Dict[int, np.ndarray] = {}
        for rid in sorted(tokens):
            if not hit[rid]:
                twin.setdefault(int(video_of[rid]), tokens[rid])
        mismatches = sum(
            1 for rid in tokens
            if hit[rid] and not np.array_equal(
                tokens[rid], twin.get(int(video_of[rid]))))
        if mismatches:
            raise RuntimeError(f"{mismatches} cache hit(s) differ from "
                               "their video's decoded caption")
        hm = stats["cache_hits"] + stats["cache_misses"]
        cache_out.update({
            "hits": stats["cache_hits"],
            "misses": stats["cache_misses"],
            "evictions": stats["cache_evictions"],
            "bypass": stats["cache_bypass"],
            "errors": stats["cache_errors"],
            "entries": stats["cache_entries"],
            "capacity": stats["cache_capacity"],
            "hit_rate": round(stats["cache_hits"] / hm, 4) if hm else None,
            "parity_ok": True,
            "parity_mismatches": 0,
        })

    fleet_out: Dict[str, Any] = {"enabled": fleet_n > 1}
    if fleet_n > 1:
        # Every caption against a clean single engine's decode of the
        # same videos (no result cache: a hit would prove nothing).
        ref_engine = make_engine()
        for v in range(uniq):
            ref_engine.submit(("ref", v), feats[v])
        ref = {int(c.request_id[1]): np.asarray(c.tokens)
               for c in ref_engine.run_until_idle()}
        mismatches = sum(
            1 for rid, row in tokens.items()
            if not np.array_equal(row, ref.get(int(video_of[rid]))))
        fleet_out.update({
            "replicas": fleet_n,
            **stats["fleet"],
            "killed_replica": (int(kill_replica) % fleet_n if killed
                               else None),
            "answered": len(latencies) + shed + dropped,
            "dropped": dropped,
            "parity_ok": mismatches == 0,
            "parity_mismatches": mismatches,
            "per_replica": stats["per_replica"],
        })

    lifecycle_out: Dict[str, Any] = {"enabled": recorder is not None}
    attribution: Optional[Dict[str, Any]] = None
    if recorder is not None:
        attribution = recorder.attribution_report()
        lifecycle_out.update({
            "events": recorder.emitted(),
            "retained": len(recorder.events()),
            **recorder.accounting(),
        })
        if blackbox_path:
            recorder.attach(health=engine.health, kernels=kernel_state)
            recorder.dump(blackbox_path, reason="probe_end")
            lifecycle_out["blackbox"] = str(blackbox_path)

    lat_ms = np.asarray(sorted(latencies.values())) * 1e3
    pct = (lambda q: round(float(np.percentile(lat_ms, q)), 3)  # noqa: E731
           if lat_ms.size else None)
    return {
        "captions_per_sec": round(len(latencies) / makespan, 2),
        "latency_p50_ms": pct(50),
        "latency_p99_ms": pct(99),
        "latency_mean_ms": (round(float(lat_ms.mean()), 3)
                            if lat_ms.size else None),
        "num_requests": n,
        "attempted": submitted,
        "completed": len(latencies),
        "shed": shed,
        "dropped": dropped,
        "answered": len(latencies) + shed + dropped,
        "rate_hz": float(rate_hz),
        "arrival_shape": str(arrival_shape),
        "arrival_seed": int(seed),
        "unique_videos": uniq,
        "zipf_alpha": float(zipf_alpha),
        "makespan_s": round(makespan, 3),
        "warmup_requests": warmed,
        "warmup_s": round(warm_s, 3),
        "libraries_loaded_after_warmup": 0,
        "buckets": list(engine.buckets),
        "slots": stats["slots"],
        "chunk_dispatches": stats["chunk_dispatches"],
        "decode_ms_per_step": stats["decode_ms_per_step"],
        "beam_size": engine.beam_size,
        "decode_chunk": engine.chunk,
        "max_len": int(max_len),
        "stream": stream_out,
        "cache": cache_out,
        "lifecycle": lifecycle_out,
        **({"attribution": attribution} if attribution is not None
           else {}),
        **({"fleet": fleet_out} if fleet_n > 1 else {}),
        # All 0 on a healthy probe without a fault plan.
        **engine.recovery_counters(),
    }
