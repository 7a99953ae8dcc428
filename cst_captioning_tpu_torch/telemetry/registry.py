"""Metrics registry: counters, gauges and histograms, and the step
records fanned out to ``metrics.jsonl`` (own copy of the part of the
reference's ``telemetry/registry.py`` the training loop needs).

Counters are the resilience audit trail: preemption signals and saves,
fault firings, checkpoint saves, walk-backs and quarantines.  The exit
snapshot ``telemetry.json`` carries them.  Records and snapshots carry
``"schema": 2``, the reference's.  Sinks: ``JsonlSink`` (``metrics.jsonl``)
and ``ScalarWriterSink`` (TensorBoard scalars, ``--tensorboard 1``).

Threading: the watchdog thread reads ``heartbeat_payload`` while the main
thread counts, so every table is guarded by one lock, which no method
holds while it takes another.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ..resilience.integrity import atomic_json_write
from ..utils.locksan import named_lock

#: Version stamped into every metrics.jsonl record and snapshot.
METRICS_SCHEMA = 2


class MetricsRegistry:
    """Counters, gauges, histograms + step-record fan-out to sinks."""

    def __init__(self):
        self._lock = named_lock("telemetry.registry")
        self._counters: Dict[str, float] = {}  # cstlint-torch: guarded_by=self._lock
        self._gauges: Dict[str, float] = {}  # cstlint-torch: guarded_by=self._lock
        self._hists: Dict[str, Dict[str, float]] = {}  # cstlint-torch: guarded_by=self._lock
        self._info: Dict[str, Any] = {}
        self._meta: Dict[str, Any] = {}  # cstlint-torch: guarded_by=self._lock
        self._sinks: List[Any] = []
        self._last_train: Optional[Dict[str, Any]] = None  # cstlint-torch: guarded_by=self._lock
        self._last_val: Optional[Dict[str, Any]] = None  # cstlint-torch: guarded_by=self._lock

    # -- instruments -------------------------------------------------------

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def declare(self, *names: str) -> None:
        """Register counters at 0 (never resets a live count): a snapshot
        then tells "armed, nothing happened" (0) from "absent"."""
        with self._lock:
            for name in names:
                self._counters.setdefault(name, 0)

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def set_info(self, name: str, value: Any) -> None:
        """A fact of the run that is not a number (the CST scorer that
        ran), carried in the snapshot under ``info``."""
        with self._lock:
            self._info[name] = value

    def set_meta(self, name: str, value: Any) -> None:
        """A fact of the run's configuration (the reference's name), in
        the snapshot under ``meta``: ``tuned_config``, the tuned-default
        provenance of ``tuning/record.py``."""
        with self._lock:
            self._meta[name] = value

    def observe(self, name: str, value: float) -> None:
        """One observation of a histogram kept as count/sum/min/max."""
        v = float(value)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                self._hists[name] = {"count": 1, "sum": v, "min": v, "max": v}
            else:
                h["count"] += 1
                h["sum"] += v
                h["min"] = min(h["min"], v)
                h["max"] = max(h["max"], v)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    # -- step records ------------------------------------------------------

    def add_sink(self, sink) -> None:
        """A sink implements log_step(step, scope, metrics, wall_time),
        flush(fsync=False) and close()."""
        self._sinks.append(sink)

    def log_step(self, step: int, scope: str,
                 metrics: Dict[str, Any]) -> None:
        """Fan one step's metrics out to every sink and remember the last
        record per scope."""
        now = time.time()
        with self._lock:
            rec = {"step": int(step), "scope": scope, **metrics}
            if scope == "val":
                self._last_val = rec
            else:
                self._last_train = rec
        for sink in self._sinks:
            sink.log_step(step, scope, metrics, now)

    def flush(self, fsync: bool = False) -> None:
        for sink in self._sinks:
            sink.flush(fsync=fsync)

    # -- snapshots ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            hists = {name: {**h, "mean": h["sum"] / max(h["count"], 1)}
                     for name, h in self._hists.items()}
            return {"schema": METRICS_SCHEMA, "time": time.time(),
                    "counters": dict(self._counters),
                    "gauges": dict(self._gauges), "histograms": hists,
                    "info": dict(self._info),
                    "meta": dict(self._meta),
                    "last_train": self._last_train,
                    "last_val": self._last_val}

    def heartbeat_payload(self) -> Dict[str, Any]:
        """Host state the watchdog writes into ``heartbeat.json``: the
        last train record, the last val step and the counters."""
        with self._lock:
            return {"last_train": self._last_train,
                    "last_val_step": (self._last_val or {}).get("step"),
                    "counters": dict(self._counters),
                    "gauges": dict(self._gauges)}

    def write_snapshot(self, path: str) -> None:
        """Atomic ``telemetry.json`` write (the exit snapshot)."""
        atomic_json_write(path, self.snapshot(), indent=2, default=str)

    def close(self) -> None:
        for sink in self._sinks:
            try:
                sink.close()
            except Exception:  # one dying sink must not mute the others
                pass
        self._sinks = []


class JsonlSink:
    """Append-only ``metrics.jsonl`` writer (schema 2).  ``flush(fsync=
    True)`` makes every record written so far durable: the trainer calls
    it at each checkpoint save, so the stream on disk is never behind the
    checkpoint it describes."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        self._f = open(path, "a")
        self._closed = False

    def log_step(self, step: int, scope: str, metrics: Dict[str, Any],
                 wall_time: float) -> None:
        if self._closed:
            return
        self._f.write(json.dumps(
            {"schema": METRICS_SCHEMA, "step": int(step), "scope": scope,
             "time": wall_time, **metrics}) + "\n")
        self._f.flush()

    def flush(self, fsync: bool = False) -> None:
        if self._closed:
            return
        self._f.flush()
        if fsync:
            try:
                os.fsync(self._f.fileno())
            except OSError:
                pass  # metrics durability is best-effort, never fatal

    def close(self) -> None:
        if self._closed:
            return
        self.flush(fsync=True)
        self._f.close()
        self._closed = True


class ScalarWriterSink:
    """Step records to a ``utils.tb.ScalarWriter`` as ``<scope>/<key>``
    scalars; values that are not numbers (None, strings, booleans) are
    skipped.  The writer drops writes after its close, so the order in
    which the registry and an exit hook close it never raises."""

    def __init__(self, writer):
        self._writer = writer

    def log_step(self, step: int, scope: str, metrics: Dict[str, Any],
                 wall_time: float) -> None:
        for k, v in metrics.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._writer.add_scalar(f"{scope}/{k}", v, step)

    def flush(self, fsync: bool = False) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()
