"""Host-side span tracer with Chrome-trace JSON export (own copy of the
reference's ``telemetry/spans.py``: the same event format and part-file
names).

A span is a named wall-clock interval opened with
``tracer.span("serve.admit")`` (or :func:`trace_span` when the tracer may
be absent).  Completed spans are buffered under a lock and written as
Chrome trace events, the ``{"traceEvents": [...]}`` JSON that Perfetto
and chrome://tracing load, one row per host thread.

- **Disabled is free.**  Call sites hold ``None`` and pay one is-None
  check; ``trace_span(None, ...)`` returns a shared no-op object.
- **Wall clocks only.**  A span reads ``time.perf_counter`` at its ends
  and never synchronises the device.  A span around a decode chunk
  therefore measures host time: the launches, and the wait in the one
  fetch that blocks on the device, not the kernels' own time.
- **Bounded.**  The buffer is written out as a part file every
  ``max_buffered_events`` events, so a long run cannot grow host memory
  without bound.

Files land in ``trace_dir`` as ``trace_<pid>r<k>[_partN].json``; each
part is a complete Chrome trace.  ``r<k>`` numbers the tracers of one
process, so two tracers sharing a pid and a directory write distinct
files.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils.locksan import named_lock


class _NullSpan:
    """Shared no-op context manager: the disabled path of every hook."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


#: The one instance call sites use when their tracer is None.
NULL_SPAN = _NullSpan()


def trace_span(tracer: Optional["SpanTracer"], name: str, **args):
    """``with trace_span(tracer, "serve.admit"): ...``; a no-op when
    ``tracer`` is None."""
    if tracer is None:
        return NULL_SPAN
    return tracer.span(name, **args)


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._record(self._name, self._t0, time.perf_counter(),
                             self._args)
        return False


class SpanTracer:
    """Thread-safe span buffer and Chrome-trace writer.  Spans may be
    opened from any thread; each thread is its own ``tid`` row."""

    _seq = 0
    _seq_lock = threading.Lock()

    def __init__(self, trace_dir: str, process_index: int = 0,
                 max_buffered_events: int = 200_000):
        self._dir = os.path.abspath(trace_dir)
        os.makedirs(self._dir, exist_ok=True)
        self._pid = os.getpid()
        with SpanTracer._seq_lock:
            self._run = SpanTracer._seq
            SpanTracer._seq += 1
        self._process_index = int(process_index)
        self._lock = named_lock("telemetry.spans")
        self._events: List[Dict[str, Any]] = []     # under _lock
        self._named_tids: set = set()               # under _lock
        self._max = max(1000, int(max_buffered_events))
        self._part = 0                              # under _lock
        self._closed = False                        # under _lock
        # Every ts is microseconds since the tracer started; the wall
        # clock at that moment rides in the file's otherData.
        self._t_epoch = time.perf_counter()
        self._wall_epoch = time.time()
        self._events.append({
            "name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
            "args": {"name": f"cst_captioning_tpu_torch host "
                             f"(process {self._process_index})"},
        })

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **args) -> _Span:
        """Context manager timing one host interval; nests."""
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker event."""
        now = time.perf_counter()
        ev = {"name": name, "ph": "i", "s": "t", "cat": "host",
              "ts": (now - self._t_epoch) * 1e6,
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._append(ev)

    def async_event(self, phase: str, name: str, aid, **args) -> None:
        """An async-track event (Chrome phases ``b``/``n``/``e``): events
        sharing ``id`` render as one track across threads.  Chrome pairs
        ``b``/``e`` by name, cat and id, so callers keep those stable per
        track and put the detail in ``args``."""
        if phase not in ("b", "n", "e"):
            raise ValueError(f"async phase must be 'b', 'n' or 'e', "
                             f"got {phase!r}")
        now = time.perf_counter()
        ev = {"name": name, "ph": phase, "cat": "request",
              "id": str(aid),
              "ts": (now - self._t_epoch) * 1e6,
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._append(ev)

    def _record(self, name: str, t0: float, t1: float,
                args: Optional[Dict[str, Any]]) -> None:
        ev = {"name": name, "ph": "X", "cat": "host",
              "ts": (t0 - self._t_epoch) * 1e6,
              "dur": (t1 - t0) * 1e6,
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._append(ev)

    def _append(self, ev: Dict[str, Any]) -> None:
        tid = ev["tid"]
        rotate = None
        with self._lock:
            if self._closed:
                return  # a straggler thread after close: dropped
            if tid not in self._named_tids:
                self._named_tids.add(tid)
                self._events.append({
                    "name": "thread_name", "ph": "M", "pid": self._pid,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name},
                })
            self._events.append(ev)
            if len(self._events) >= self._max:
                rotate = self._take_events_locked()
        if rotate is not None:
            self._write_part(*rotate)

    def _take_events_locked(self):
        """-> (events, part path); the part number is claimed under the
        lock, so concurrent rotations never share a file name."""
        events, self._events = self._events, []
        # Thread names reappear in every part, so each loads on its own.
        self._named_tids.clear()
        suffix = "" if self._part == 0 else f"_part{self._part}"
        self._part += 1
        return events, os.path.join(
            self._dir, f"trace_{self._pid}r{self._run}{suffix}.json")

    # -- export ------------------------------------------------------------

    def _write_part(self, events: List[Dict[str, Any]], path: str) -> None:
        if not events:
            return
        from ..resilience.integrity import atomic_json_write

        atomic_json_write(path, {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "pid": self._pid,
                "process_index": self._process_index,
                "wall_epoch_unix_s": self._wall_epoch,
            },
        })

    def flush(self) -> None:
        """Write the buffered events out now, as a complete part file."""
        with self._lock:
            events, path = self._take_events_locked()
        self._write_part(events, path)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            events, path = self._take_events_locked()
            self._closed = True
        self._write_part(events, path)
