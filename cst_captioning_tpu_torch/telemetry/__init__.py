"""Training telemetry: span tracing, the metrics registry, step phases
and MFU (own copy of the reference's ``telemetry/__init__.py``).

One bundle, :class:`Telemetry`, is threaded explicitly through the parts
that host an instrumentation point (the trainer's loop, the prefetch
workers, the checkpoint manager, the host reward and its pipeline), as
``FaultPlan`` is: no module globals, and a disarmed hook costs its call
site one is-None check.

- :mod:`.spans`: host spans written as Chrome-trace JSON (``--trace_dir``;
  Perfetto or chrome://tracing loads them);
- :mod:`.registry`: counters, gauges and histograms fanned out to
  ``metrics.jsonl`` and TensorBoard, with the ``telemetry.json`` snapshot
  at exit;
- :mod:`.phases`: the per-interval ``data_wait_ms``/``compute_ms``/
  ``score_ms``/``ckpt_ms`` gauges (``--step_timing``);
- :mod:`.flops`: model FLOPs and MFU, shared with the bench.
"""

from __future__ import annotations

import os
from typing import Optional

from .flops import caption_step_flops, mfu_fields, peak_tflops
from .phases import STEP_PHASES, StepPhases
from .registry import (METRICS_SCHEMA, JsonlSink, MetricsRegistry,
                       ScalarWriterSink)
from .spans import NULL_SPAN, SpanTracer, trace_span

__all__ = [
    "METRICS_SCHEMA", "NULL_SPAN", "STEP_PHASES", "JsonlSink",
    "MetricsRegistry", "ScalarWriterSink", "SpanTracer", "StepPhases",
    "Telemetry", "caption_step_flops", "mfu_fields", "peak_tflops",
    "trace_span",
]


class Telemetry:
    """The registry (always), and the span tracer and phase timer when the
    flags arm them.

    ``tracer`` and ``phases`` are None unless ``--trace_dir`` or
    ``--step_timing`` arm them; hot call sites hold the attribute in a
    local and branch on is-None, so a run without the flags allocates
    nothing per step.  ``profiling`` is True while the trainer's
    ``torch.profiler`` window is open: :meth:`annotate` then names a range
    in the profiler's trace (``record_function``), and is the shared
    no-op otherwise.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[SpanTracer] = None,
                 phases: Optional[StepPhases] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        self.phases = phases
        self.profiling = False
        self._closed = False

    @classmethod
    def from_opts(cls, opt, registry: Optional[MetricsRegistry] = None,
                  process_index: int = 0) -> "Telemetry":
        """From the CLI namespace: ``--trace_dir`` arms the tracer (its
        trace names ``process_index``), ``--step_timing`` (on by default
        under ``--trace_dir``) the phase gauges.  The owner attaches the
        sinks."""
        tracer = None
        trace_dir = getattr(opt, "trace_dir", None)
        if trace_dir:
            tracer = SpanTracer(trace_dir, process_index=process_index)
        step_timing = getattr(opt, "step_timing", None)
        if step_timing is None:
            step_timing = tracer is not None
        phases = (StepPhases(tracer)
                  if int(step_timing) or tracer is not None else None)
        return cls(registry=registry, tracer=tracer, phases=phases)

    # -- hooks ---------------------------------------------------------------

    def span(self, name: str, **args):
        """A tracer span, or the shared no-op without a tracer."""
        tracer = self.tracer
        if tracer is None:
            return NULL_SPAN
        return tracer.span(name, **args)

    def phase(self, name: str):
        """A phase-timed (and traced) interval; the no-op when both are
        off."""
        phases = self.phases
        if phases is not None:
            return phases.phase(name)
        tracer = self.tracer
        if tracer is not None:
            return tracer.span(name)
        return NULL_SPAN

    def annotate(self, name: str):
        """``torch.profiler.record_function(name)`` inside the profiler
        window (the reference's ``jax.profiler.TraceAnnotation``), else
        the no-op."""
        if not self.profiling:
            return NULL_SPAN
        from torch.profiler import record_function

        return record_function(name)

    def flush(self, fsync: bool = False) -> None:
        self.registry.flush(fsync=fsync)
        if self.tracer is not None and fsync:
            self.tracer.flush()

    def close(self, snapshot_path: Optional[str] = None) -> None:
        """Idempotent: write the ``telemetry.json`` snapshot (where a path
        is given), close the sinks and the tracer."""
        if self._closed:
            return
        self._closed = True
        if snapshot_path:
            os.makedirs(os.path.dirname(os.path.abspath(snapshot_path)),
                        exist_ok=True)
            self.registry.write_snapshot(snapshot_path)
        self.registry.close()
        if self.tracer is not None:
            self.tracer.close()
