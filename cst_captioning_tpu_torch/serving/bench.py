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
reference's, draw for draw.  The reference's streaming, result cache,
fleet and lifecycle tracing are not ported.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from ..ops import _cuda
from .buckets import DEFAULT_BUCKETS
from .engine import ServingEngine


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
                  unique_videos: Optional[int] = None,
                  zipf_alpha: float = 0.0, arrival_shape: str = "poisson",
                  arrival_trace: Optional[str] = None,
                  clock: Callable[[], float] = time.perf_counter
                  ) -> Dict[str, Any]:
    """Drive one engine through a seeded open-loop load; -> metrics.

    Raises ``RuntimeError`` if a kernel library is built or loaded while
    the clock runs (the warm-up must have paid for every one).
    """
    n = int(num_requests)
    uniq = n if unique_videos is None else max(1, min(int(unique_videos), n))
    arrivals = make_arrivals(arrival_shape, n, rate_hz, seed,
                             trace_path=arrival_trace)
    feat_rng = np.random.default_rng(seed + 1)
    feats = [[feat_rng.standard_normal(s).astype(np.float32)
              for s in feat_shapes] for _ in range(uniq)]
    video_of = zipfian_mix(n, uniq, zipf_alpha, seed + 2)

    def make_engine() -> ServingEngine:
        return ServingEngine(
            model, feat_shapes, max_len=max_len, beam_size=beam_size,
            length_norm=length_norm, decode_chunk=decode_chunk,
            bucket_sizes=bucket_sizes, queue_limit=queue_limit, clock=clock)

    t_warm = clock()
    warmed = warm_buckets(make_engine, feats)
    warm_s = clock() - t_warm
    engine = make_engine()
    libraries = _cuda.loaded_libraries()

    t0 = clock()
    submitted = 0
    latencies: Dict[Any, float] = {}
    shed = 0
    dropped = 0     # the port's engine drops nothing (no deadlines yet)
    while len(latencies) + shed + dropped < n:
        now = clock() - t0
        while submitted < n and arrivals[submitted] <= now:
            if not engine.submit(submitted,
                                 feats[int(video_of[submitted])]):
                shed += 1
            submitted += 1
        for comp in engine.step():
            latencies[comp.request_id] = ((comp.done_at - t0)
                                          - arrivals[comp.request_id])
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
    }
