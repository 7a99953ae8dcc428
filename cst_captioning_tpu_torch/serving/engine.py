"""Step-driven continuous-batching scheduler over the decode path
(counterpart of the reference's single-process ``serving/engine.py``).

The engine owns the batch dimension as a set of SLOTS:

- **Admission costs one encoder pass.**  A queued request is encoded at
  batch 1 and its encoder outputs and fresh decoder carry are written
  into the free slot's rows in place.  Resident rows are never
  re-decoded.
- **Each engine step runs one chunk**: ``decode_chunk`` eager decode
  steps over the whole slot batch, through ``make_decode_step`` (so
  ``decode_kernel="fused"`` runs every step on the K2 kernel).  Tokens
  and the finished buffer reach the host once per chunk.
- **A per-row finished predicate frees a slot mid-flight**
  (``ops.sampling.finished_mask``, the early-exit predicate), and each
  freed slot admits the next queued video before the following chunk.
- **Same captions as the offline decoders.**  The chunk bodies are the
  offline greedy / beam bodies, with the step-0 beam mask folded into the
  admission scores (``(0 + logp) + NEG_INF == NEG_INF + logp`` exactly)
  and a per-slot force-finish at ``max_len`` in place of the global step
  bound.
- **Buckets.**  Slot counts come from a small fixed ladder; demand beyond
  the current bucket grows the state to the next one (residents keep
  their slots).  Empty slots are finished rows with ``steps == max_len``:
  provable no-ops.

Faults:

- **Deadlines.**  A request may carry a deadline (the engine's default or
  its own).  A resident past it is evicted mid-flight (its slot frees as
  at an EOS) and answered by an ``expired`` drop record; a queued one
  past it is dropped, and one whose remaining time cannot cover one
  chunk at the p99 chunk time is shed (``deadline_shed``).
- **The ladder** (``recover=True``).  A chunk is computed into new
  tensors and committed only after its fetch passed the garble check
  (``resilience/garble.py``), so a chunk that raises (a device error,
  the injected ``serve_wedge``) or comes back garbled (``serve_garble``)
  leaves the pre-chunk state intact and is re-run from it, up to
  ``retry_limit`` times.  Then the engine rebuilds: fresh slot state,
  the residents re-admitted from their requests, their emitted tokens
  kept as the prefix the replay must reproduce at harvest.  A rebuild
  builds and loads no kernel library (``serve_rebuild_recompiles`` counts
  any).  After ``rebuild_limit`` failed rebuilds it raises
  :class:`ServingUnrecoverable`, which the CLI turns into exit 124.
- **Admission errors** (``admit_err``) put the request back at the head
  of the queue, up to ``retry_limit`` times, then drop it
  (``admit_failed``).

Latency:

- **Streaming** (``stream=True``): a greedy resident's new caption tokens
  leave as a :class:`StreamChunk` after every chunk, from the fetch the
  scheduler makes anyway; their concatenation is the final caption, also
  across a rebuild (a watermark that only moves forward).  Beam emits one
  terminal chunk at harvest, after the backtrack.
- **The exact-result cache** (``result_cache=``, ``serving/cache.py``):
  a submit is looked up by (configuration identity, weights fingerprint,
  features fingerprint) before the queue.  A hit completes at once, with
  no admission, no chunk and no kernel launch; a miss decodes and writes
  back at harvest.  A failing lookup (``serve_cache``) is counted, marks
  health degraded, and the request decodes fresh.

Tracing (``telemetry/``): ``tracer=`` (a ``SpanTracer``) times admission
and each decode chunk as host spans; ``lifecycle=`` (a ``LifecycleTracer``
or a fleet replica's view of one) receives every request's lifecycle
events, stamped from the engine's clock.  Disarmed, each hook costs one
is-None check.

The fleet surface (``serving/fleet.py``): ``evacuate`` strips the engine
of its queued (and resident) requests and ``requeue`` adopts one evacuated
elsewhere, keeping its first arrival clock and what is left of its
deadline.  An evacuated resident's device rows are abandoned in place; the
caching allocator reuses memory in stream order, so nothing a launched
chunk still writes is handed out again.

The engine is single-owner: ``submit``/``step``/``drain`` are called from
one thread (the server's scheduler loop).  Deadlines, TTFT and chunk
gaps read the injected ``clock``.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import _cuda, launch_counts
from ..ops import attention_kernel, decode_cell_kernel
from ..ops.beam import NEG_INF, _expand_to_beams, beam_step, rank_beams
from ..ops.sampling import finished_mask, make_decode_step
from ..resilience.faults import InjectedFault
from ..resilience.garble import (GarbledChunk, garbled_decode_slots,
                                 health_status)
from ..telemetry.spans import trace_span
from .buckets import DEFAULT_BUCKETS, config_key, pick_bucket
from .cache import ResultCache, feature_fingerprint, params_fingerprint

log = logging.getLogger(__name__)

#: Counters the engine owns, declared at 0 in the registry it is given
#: (the reference's, less its program-build counter: eager PyTorch
#: builds no programs).
COUNTERS = ("serve_requests", "serve_admitted", "serve_completed",
            "serve_shed", "serve_rejected_drain",
            "serve_expired", "serve_deadline_shed", "serve_chunk_retries",
            "serve_rebuilds", "serve_rebuild_recompiles",
            "serve_garble_detected", "serve_wedge_detected",
            "serve_admit_errors", "serve_replay_divergence",
            "serve_slow_chunks",
            "serve_stream_chunks", "serve_cache_hits", "serve_cache_misses",
            "serve_cache_evictions", "serve_cache_bypass",
            "serve_cache_errors")

#: ``health()`` reads ``degraded`` this long after a recovery event.
DEGRADED_WINDOW_S = 60.0


class ServingUnrecoverable(RuntimeError):
    """The ladder is exhausted: retries failed, rebuilds failed.  The CLI
    exits 124 (``exitcodes.EXIT_WEDGE``) so a supervisor restarts it."""


@dataclass
class Request:
    """One queued video: opaque id + per-modality ``(T, D)`` features."""

    request_id: Any
    feats: List[np.ndarray]
    arrival: float = 0.0
    meta: Optional[dict] = None
    #: Submission ordinal (0-based): the ``@req=N`` fault-plan axis.
    index: int = -1
    #: Absolute engine-clock deadline; None = none.
    deadline: Optional[float] = None
    admit_attempts: int = 0
    #: Emit StreamChunk records for this request.
    stream: bool = False
    #: Skip the result cache for this request.
    no_cache: bool = False
    #: Result-cache key to write back at harvest (None = no write-back).
    cache_key: Optional[tuple] = None


@dataclass
class Completion:
    """One finished caption, 0-terminated in the label convention."""

    request_id: Any
    tokens: np.ndarray            # (max_len,) int32
    slot: int
    admit_at: float
    done_at: float
    latency_s: float
    decode_steps: int
    meta: Optional[dict] = None
    #: Stream chunks emitted before this completion, and the time to the
    #: first one (0 / None for a request that did not stream).
    stream_chunks: int = 0
    ttft_s: Optional[float] = None
    #: The caption came from the result cache (no decode paid).
    cache_hit: bool = False


@dataclass
class StreamChunk:
    """The new caption tokens of one request after one chunk (EOS
    trimmed; the whole caption for a beam or cache-hit terminal).  A
    request's chunks in ``seq`` order concatenate to its caption."""

    request_id: Any
    seq: int
    tokens: np.ndarray
    meta: Optional[dict] = None


@dataclass
class Dropped:
    """A request the scheduler gave up on.  ``reason``: ``expired``
    (``where`` is ``queued`` or ``resident``), ``deadline_shed`` (queued,
    its deadline cannot cover one p99 chunk) or ``admit_failed``."""

    request_id: Any
    reason: str
    where: str
    deadline: Optional[float] = None
    meta: Optional[dict] = None


@dataclass
class _Resident:
    request: Request
    slot: int
    admit_at: float
    steps: int = 0
    toks: List[np.ndarray] = field(default_factory=list)
    pars: List[np.ndarray] = field(default_factory=list)
    #: Tokens emitted before a rebuild: what the replay must reproduce.
    prefix: Optional[np.ndarray] = None
    #: Streaming: caption tokens already emitted (the watermark), chunks
    #: emitted, and the clocks of the first and the last.
    streamed: int = 0
    chunks_emitted: int = 0
    first_emit: Optional[float] = None
    last_emit: Optional[float] = None


#: Why the engine refuses the transformer (the reference's reason).
TRANSFORMER_REFUSAL = (
    "serving requires per-row decoder state; the transformer carry holds "
    "a batch-shared position counter, so a slot admitted mid-flight cannot "
    "start at position 0 (SERVING.md 'Model support')")


class ServingRefused(ValueError):
    """A model the engine cannot serve (the transformer)."""


def refuse_unservable(model_type: str) -> None:
    """Raise ``ServingRefused`` unless ``model_type`` is the LSTM's."""
    if model_type != "lstm":
        raise ServingRefused(TRANSFORMER_REFUSAL)


class ServingEngine:
    """Continuous batching over the greedy / beam decode.

    ``model`` is a ``CaptionModel`` already on its device (the engine runs
    there); ``feat_shapes`` the per-modality ``(T, D)`` geometry every
    request must match.  ``queue_limit`` bounds the submit queue (0/None =
    unbounded); ``clock`` is injectable for deterministic tests.

    Faults: ``deadline_ms`` is the default request deadline (0 = none;
    ``submit``'s ``deadline_ms`` overrides it); ``fault_plan`` arms the
    plan's ``@req=N`` kinds; ``recover`` arms the ladder (retry ->
    rebuild -> raise), bounded by ``retry_limit`` and ``rebuild_limit``;
    ``step_budget_ms`` counts slower chunks (0 = off); ``health()`` reads
    ``degraded`` for :data:`DEGRADED_WINDOW_S` after a recovery event.
    ``result_cache`` arms the exact-result cache (None: every request
    decodes, and nothing counts as bypass).  ``registry`` (a
    ``telemetry.registry.MetricsRegistry``) gets :data:`COUNTERS`.
    ``tracer`` and ``lifecycle`` arm the span and request-lifecycle
    tracers (module docstring).
    """

    def __init__(self, model, feat_shapes: Sequence[Tuple[int, int]], *,
                 max_len: int, beam_size: int = 1, length_norm: float = 0.0,
                 decode_chunk: int = 8,
                 bucket_sizes: Sequence[int] = DEFAULT_BUCKETS,
                 queue_limit: Optional[int] = 64,
                 deadline_ms: float = 0.0,
                 fault_plan=None,
                 recover: bool = False,
                 retry_limit: int = 2,
                 rebuild_limit: int = 2,
                 step_budget_ms: float = 0.0,
                 result_cache: Optional[ResultCache] = None,
                 registry=None, tracer=None, lifecycle=None,
                 clock: Callable[[], float] = time.monotonic):
        refuse_unservable(model.decoder_type)
        self.model = model
        self.device = model.device
        self._feat_shapes = tuple(tuple(int(x) for x in s)
                                  for s in feat_shapes)
        self.max_len = int(max_len)
        self.beam_size = max(1, int(beam_size))
        self.length_norm = float(length_norm)
        chunk = int(decode_chunk)
        # chunk 0 (one full-length loop) has no mid-caption boundary to
        # recycle slots at; run it as one max_len-sized chunk.
        self.chunk = chunk if 0 < chunk < self.max_len else self.max_len
        self.buckets = tuple(sorted(set(int(b) for b in bucket_sizes)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad bucket_sizes {bucket_sizes!r}")
        self.queue_limit = int(queue_limit or 0)
        self.deadline_ms = float(deadline_ms or 0.0)
        self._plan = fault_plan
        self.recover = bool(recover)
        self.retry_limit = max(0, int(retry_limit))
        self.rebuild_limit = max(0, int(rebuild_limit))
        self.step_budget_ms = float(step_budget_ms or 0.0)
        self._registry = registry
        self._tracer = tracer
        self._lifecycle = lifecycle
        self.clock = clock
        self._queue: deque = deque()
        self._residents: List[Optional[_Resident]] = []
        self._slots_n = 0
        self._dev: Optional[Dict[str, Any]] = None
        self._latencies: deque = deque(maxlen=1024)
        self._chunk_wall: deque = deque(maxlen=128)
        self._dropped: List[Dropped] = []
        self._stream_chunks: List[StreamChunk] = []
        self._hits: List[Completion] = []
        self._ttft: deque = deque(maxlen=1024)
        self._gaps: deque = deque(maxlen=4096)
        self._stream_emitted = 0
        self._result_cache = result_cache
        self._cache_hits = 0
        self._cache_misses = 0
        self._cache_evictions = 0
        self._cache_bypass = 0
        self._cache_errors = 0
        if result_cache is not None:
            # Paid once: a shared cache never replays a caption across
            # weights or decode configurations.  K1 in the reference cell
            # rounds otherwise than the plain attention, so it is part of
            # the kernel's name here.
            kernel = model.decode_kernel
            if kernel != "fused" and getattr(
                    getattr(model.cell, "attn", None), "use_kernel", False):
                kernel += "+k1"
            self._params_fp = params_fingerprint(model)
            self._result_identity = config_key(
                kind="result", bucket=0, beam_size=self.beam_size,
                max_len=self.max_len, decode_chunk=self.chunk,
                length_norm=self.length_norm, decode_kernel=kernel,
                scan_unroll=1, feat_shapes=self._feat_shapes,
                dtype=str(model.dtype))
        self._submitted = 0
        self._completed = 0
        self._shed = 0
        self._rejected = 0
        self._expired = 0
        self._deadline_shed = 0
        self._chunk_retries = 0
        self._rebuilds = 0
        self._rebuild_recompiles = 0
        self._garbles = 0
        self._wedges = 0
        self._admit_errors = 0
        self._replay_divergence = 0
        self._slow_chunks = 0
        self._last_recovery_at: Optional[float] = None
        self._chunk_dispatches = 0
        self._decode_s = 0.0
        self._admit_s = 0.0
        self._launches0 = launch_counts()
        if registry is not None:
            registry.declare(*COUNTERS)

    # -- device state ------------------------------------------------------

    def _init_state(self, slots: int) -> Dict[str, Any]:
        """All-slots-empty state: finished=True / steps=max_len, so empty
        rows are provable no-ops until an admission claims them."""
        m, k, dev = self.model, self.beam_size, self.device
        rows = slots * k
        # The memory's tokens: every frame, or one per modality (manet).
        t = (len(self._feat_shapes) if m.fusion_type == "modality"
             else sum(s[0] for s in self._feat_shapes))

        def z(*shape, dtype=torch.float32, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        # The carry and the encodings in the model's compute dtype (the
        # bf16 decode variant takes a float32 model's float32 buffers).
        act = m.dtype
        state = {
            "carry": tuple((z(rows, m.hidden_size, dtype=act),
                            z(rows, m.hidden_size, dtype=act))
                           for _ in range(m.num_layers)),
            "memory": z(rows, t, m.hidden_size, dtype=act),
            "proj_mem": z(rows, t, m.attn_size, dtype=act),
            "pooled": z(rows, m.hidden_size, dtype=act),
            "steps": z(slots, dtype=torch.long, fill=self.max_len),
        }
        shape = (slots,) if k == 1 else (slots, k)
        state["prev"] = z(*shape, dtype=torch.long)
        state["finished"] = z(*shape, dtype=torch.bool, fill=True)
        if k > 1:
            state["scores"] = z(slots, k)
            state["lengths"] = z(slots, k, dtype=torch.long)
        return state

    @torch.no_grad()
    def _admit(self, slot: int, req: Request) -> None:
        """Encode one request (batch 1), expand to beam rows, and write
        encodings + fresh carry + reset per-slot columns into ``slot``'s
        rows in place.  ``finished`` and ``steps`` are written last, so
        an admission that fails midway leaves the slot a finished no-op."""
        k, st = self.beam_size, self._dev
        feats = [torch.as_tensor(f, device=self.device)[None]
                 for f in req.feats]
        memory, proj_mem, pooled = self.model.encode(feats)
        if k > 1:
            memory, proj_mem, pooled = _expand_to_beams(
                (memory, proj_mem, pooled), k, 1)
        carry = self.model.init_carry(pooled)
        r = slice(slot * k, (slot + 1) * k)
        for (c_buf, h_buf), (c, h) in zip(st["carry"], carry):
            c_buf[r] = c
            h_buf[r] = h
        st["memory"][r] = memory
        st["proj_mem"][r] = proj_mem
        st["pooled"][r] = pooled
        st["prev"][slot] = 0
        if k > 1:
            # Step-0 beam mask as ADMISSION SCORES: only beam 0 live.
            st["scores"][slot] = NEG_INF
            st["scores"][slot, 0] = 0.0
            st["lengths"][slot] = 0
        st["steps"][slot] = 0
        st["finished"][slot] = False

    # The chunk bodies compute the next state into new tensors and leave
    # ``self._dev`` as it was: ``_dispatch_chunk`` commits it after the
    # fetch passed the garble check, so a failed chunk re-runs from the
    # pre-chunk state.

    @torch.no_grad()
    def _run_greedy_chunk(self):
        st = self._dev
        step = make_decode_step(self.model, st["memory"], st["proj_mem"],
                                st["pooled"])
        carry, prev = st["carry"], st["prev"]
        finished, steps = st["finished"], st["steps"]
        emits = []
        for _ in range(self.chunk):
            # The offline greedy body plus a per-slot force-finish at
            # max_len (a no-op while steps < max_len).
            finished = finished | (steps >= self.max_len)
            carry, logits = step(carry, prev)
            emit = torch.where(finished, 0, logits.argmax(dim=-1))
            finished = finished | (emit == 0)
            steps = steps + 1
            prev = emit
            emits.append(emit)
        new = dict(st, carry=carry, prev=prev, finished=finished,
                   steps=steps)
        return new, torch.stack(emits, dim=1), None     # (slots, chunk)

    @torch.no_grad()
    def _run_beam_chunk(self):
        st = self._dev
        k, slots = self.beam_size, self._slots_n
        step = make_decode_step(self.model, st["memory"], st["proj_mem"],
                                st["pooled"])
        carry, prev, scores = st["carry"], st["prev"], st["scores"]
        finished, lengths, steps = st["finished"], st["lengths"], st["steps"]
        toks, pars = [], []
        for _ in range(self.chunk):
            finished = finished | (steps >= self.max_len)[:, None]
            carry, prev, scores, finished, lengths, parent = beam_step(
                step, carry, prev, scores, finished, lengths, slots, k)
            steps = steps + 1
            toks.append(prev)
            pars.append(parent)
        new = dict(st, carry=carry, prev=prev, scores=scores,
                   finished=finished, lengths=lengths, steps=steps)
        # (slots, chunk, k) for the per-slot harvest.
        return new, torch.stack(toks, dim=1), torch.stack(pars, dim=1)

    # -- queue -------------------------------------------------------------

    def submit(self, request_id, feats: Sequence[np.ndarray],
               meta: Optional[dict] = None,
               deadline_ms: Optional[float] = None,
               stream: bool = False, no_cache: bool = False,
               _requeued: bool = False,
               _arrival: Optional[float] = None) -> bool:
        """Queue one request.  Returns False (sheds) when the bounded
        queue is full: the engine's backpressure signal.  ``deadline_ms``
        overrides the engine's default (None: the default; 0: none);
        ``stream`` emits :class:`StreamChunk` records
        (``pop_stream_chunks``); ``no_cache`` skips the result cache
        (counted as bypass).  A cache hit completes here and is returned
        by the next ``step``.  ``_requeued``/``_arrival`` are
        ``requeue``'s: the lifecycle records a re-entry, and the request
        keeps its first arrival clock."""
        self._submitted += 1
        index = self._submitted - 1        # submission ordinal (@req=N)
        self._inc("serve_requests")
        feats = [np.asarray(f, np.float32) for f in feats]
        shapes = tuple(f.shape for f in feats)
        if shapes != self._feat_shapes:
            raise ValueError(
                f"request {request_id!r} feature shapes {shapes} do not "
                f"match the engine's geometry {self._feat_shapes}")
        arrival = self.clock() if _arrival is None else float(_arrival)
        if self._lifecycle is not None:
            # "received" at the arrival clock; a re-entry after a replica
            # kill or rotation is "requeued", now.  A front end's trace
            # context (meta["trace"]) rides along as trace_id.
            tr = (meta or {}).get("trace")
            attrs = ({"trace_id": tr.get("id")}
                     if isinstance(tr, dict) else {})
            if _requeued:
                self._lifecycle.emit("requeued", request_id, **attrs)
            else:
                self._lifecycle.emit("received", request_id, ts=arrival,
                                     **attrs)
        # The result cache, before the bounded queue: a hit takes no
        # slot, no queue depth and no decode.
        cache_key = None
        if self._result_cache is not None:
            if no_cache:
                self._cache_bypass += 1
                self._inc("serve_cache_bypass")
            else:
                row = None
                try:
                    if self._plan is not None and \
                            self._plan.fire("serve_cache", index):
                        raise InjectedFault(
                            f"injected serve_cache at request {index}")
                    cache_key = (self._result_identity, self._params_fp,
                                 feature_fingerprint(feats))
                    row = self._result_cache.get(cache_key)
                except Exception as e:
                    # A broken cache may cost a decode, never a request:
                    # decode fresh, with no write-back.
                    cache_key = None
                    self._cache_errors += 1
                    self._inc("serve_cache_errors")
                    self._note_recovery_event()
                    log.warning("result-cache lookup failed for request "
                                "%r (%s); decoding fresh", request_id, e)
                if row is not None:
                    self._cache_hits += 1
                    self._inc("serve_cache_hits")
                    self._complete_hit(request_id, row, arrival,
                                       stream=stream, meta=meta)
                    self._update_gauges()
                    return True
        if self.queue_limit and len(self._queue) >= self.queue_limit:
            self._shed += 1
            self._inc("serve_shed")
            if self._lifecycle is not None:
                # Terminal for a lone engine; a fleet replica's view drops
                # it (the router may still place the request).
                self._lifecycle.emit("shed", request_id, where="queue")
            self._update_gauges()
            return False
        # A miss is counted at harvest, beside its write-back: a queued
        # request may still shed, expire or fail admission undecoded.
        ttl = self.deadline_ms if deadline_ms is None else float(deadline_ms)
        deadline = (self.clock() + ttl / 1e3) if ttl and ttl > 0 else None
        self._queue.append(Request(request_id, feats, arrival=arrival,
                                   meta=meta, index=index,
                                   deadline=deadline, stream=bool(stream),
                                   no_cache=bool(no_cache),
                                   cache_key=cache_key))
        if self._lifecycle is not None:
            self._lifecycle.emit("queued", request_id,
                                 depth=len(self._queue))
        self._update_gauges()
        return True

    def _complete_hit(self, request_id, row: np.ndarray, arrival: float,
                      *, stream: bool, meta: Optional[dict]) -> None:
        """A cache hit completes at submit time (no admission, no chunk);
        a streamed hit emits its whole caption as one terminal chunk."""
        now = self.clock()
        chunks = 0
        ttft = None
        if stream:
            trimmed = _trim_eos(row)
            if trimmed.size:
                self._stream_chunks.append(
                    StreamChunk(request_id, 0, trimmed, meta=meta))
                self._stream_emitted += 1
                self._inc("serve_stream_chunks")
                chunks = 1
                ttft = now - arrival
                self._ttft.append(ttft)
                self._observe("serve_ttft_ms", ttft * 1e3)
        comp = Completion(
            request_id=request_id, tokens=row, slot=-1, admit_at=now,
            done_at=now, latency_s=now - arrival, decode_steps=0,
            meta=meta, stream_chunks=chunks, ttft_s=ttft, cache_hit=True)
        self._hits.append(comp)
        self._completed += 1
        self._inc("serve_completed")
        self._latencies.append(comp.latency_s)
        self._observe("serve_request_latency_ms", comp.latency_s * 1e3)
        if self._lifecycle is not None:
            self._lifecycle.emit("cache_hit", request_id, ts=now)
            self._lifecycle.emit("completed", request_id, ts=now,
                                 latency_ms=round(comp.latency_s * 1e3, 3),
                                 cached=True)

    @property
    def idle(self) -> bool:
        return (not self._queue and not any(self._residents)
                and not self._hits)

    @property
    def resident_count(self) -> int:
        return sum(1 for r in self._residents if r is not None)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def resident_requests(self) -> List[Request]:
        """The requests holding slots: after an aborted drain, the ones
        the front end still owes an answer."""
        return [r.request for r in self._residents if r is not None]

    def pop_dropped(self) -> List[Dropped]:
        """The drop records since the last call."""
        out, self._dropped = self._dropped, []
        return out

    def pop_stream_chunks(self) -> List[StreamChunk]:
        """The stream chunks since the last call."""
        out, self._stream_chunks = self._stream_chunks, []
        return out

    def min_service_s(self) -> Optional[float]:
        """The shed floor: one p99 chunk (None under 4 samples)."""
        return self._min_service_s()

    def degraded(self) -> bool:
        """A recovery event happened within :data:`DEGRADED_WINDOW_S`."""
        return (self._last_recovery_at is not None
                and (self.clock() - self._last_recovery_at)
                < DEGRADED_WINDOW_S)

    def latency_window_s(self) -> List[float]:
        """Raw request latencies (seconds) of the retained window."""
        return list(self._latencies)

    def stream_windows_s(self) -> Tuple[List[float], List[float]]:
        """Raw (TTFT, chunk gap) windows, seconds: a fleet computes its
        percentiles over the replicas' samples."""
        return list(self._ttft), list(self._gaps)

    def evacuate(self, include_residents: bool = True
                 ) -> Tuple[List[Completion], List[Request]]:
        """Strip the engine of what it still owes: the pending cache-hit
        completions (finished; returned for the caller's responses) and
        the queued requests, plus the residents when
        ``include_residents``, returned for re-routing.  A resident's
        device rows are abandoned; another engine decodes it again from
        step 0 to the same caption.  The fleet calls this with residents
        on a replica it kills or restarts, without on one it rotates."""
        done = list(self._hits)
        self._hits.clear()
        reqs: List[Request] = list(self._queue)
        self._queue.clear()
        if include_residents:
            for slot, res in enumerate(self._residents):
                if res is not None:
                    reqs.append(res.request)
                    self._residents[slot] = None
        self._update_gauges()
        return done, reqs

    def requeue(self, req: Request) -> bool:
        """Adopt a request evacuated from another engine: a fresh local
        submission (a new ``@req`` ordinal) that keeps the first arrival
        clock, so its latency counts from its first submission, and what
        is left of its absolute deadline (a lapsed one expires at
        admission)."""
        if req.deadline is not None:
            remaining_ms = max((req.deadline - self.clock()) * 1e3, 1e-3)
        else:
            remaining_ms = 0.0
        return self.submit(req.request_id, req.feats, meta=req.meta,
                           deadline_ms=remaining_ms, stream=req.stream,
                           no_cache=req.no_cache,
                           _requeued=True, _arrival=req.arrival)

    # -- deadlines ---------------------------------------------------------

    def _drop(self, req: Request, reason: str, where: str) -> None:
        self._dropped.append(Dropped(req.request_id, reason, where,
                                     deadline=req.deadline, meta=req.meta))
        if self._lifecycle is not None:
            self._lifecycle.emit("dropped", req.request_id,
                                 reason=reason, where=where)
        if reason == "expired":
            self._expired += 1
            self._inc("serve_expired")
        elif reason == "deadline_shed":
            self._deadline_shed += 1
            self._inc("serve_deadline_shed")

    def _min_service_s(self) -> Optional[float]:
        """The p99 of the last 128 chunks' wall times: a queued request
        needs at least one chunk, costed at the tail, so the floor errs
        on shedding early."""
        if len(self._chunk_wall) < 4:
            return None
        return float(np.percentile(np.asarray(self._chunk_wall), 99))

    def _expire_residents(self, now: float) -> None:
        """Evict every resident past its deadline: its slot frees now (the
        next admission overwrites its rows, as after an EOS)."""
        for slot, res in enumerate(self._residents):
            if res is None or res.request.deadline is None:
                continue
            if now >= res.request.deadline:
                self._residents[slot] = None
                self._drop(res.request, "expired", "resident")
                log.info("request %r expired mid-flight (slot %d, %d decode "
                         "steps paid)", res.request.request_id, slot,
                         res.steps)

    def _next_admittable(self) -> Optional[Request]:
        """Pop the next queued request worth admitting: drop expired ones
        and shed those whose remaining time is under one p99 chunk."""
        now = self.clock()
        min_s = self._min_service_s()
        while self._queue:
            req = self._queue.popleft()
            if req.deadline is not None:
                if now >= req.deadline:
                    self._drop(req, "expired", "queued")
                    continue
                if min_s is not None and (req.deadline - now) < min_s:
                    self._drop(req, "deadline_shed", "queued")
                    continue
            return req
        return None

    # -- scheduling --------------------------------------------------------

    def _ensure_bucket(self) -> None:
        needed = self.resident_count + len(self._queue)
        if self._dev is None:
            slots = pick_bucket(self.buckets, max(needed, 1))
            self._dev = self._init_state(slots)
            self._slots_n = slots
            self._residents = [None] * slots
            return
        if needed <= self._slots_n:
            return
        target = pick_bucket(self.buckets, needed)
        if target > self._slots_n:
            self._grow(target)

    def _grow(self, new_slots: int) -> None:
        """Migrate to a larger bucket: append empty-slot rows (finished /
        steps=max_len no-ops); residents keep their slot indices."""
        fresh = self._init_state(new_slots - self._slots_n)
        old = self._dev

        def cat(a, b):
            return torch.cat([a, b], dim=0)

        self._dev = {
            key: (tuple((cat(c0, c1), cat(h0, h1)) for (c0, h0), (c1, h1)
                        in zip(val, fresh[key]))
                  if key == "carry" else cat(val, fresh[key]))
            for key, val in old.items()}
        self._residents.extend([None] * (new_slots - self._slots_n))
        self._slots_n = new_slots

    def _admit_pending(self) -> None:
        if not self._queue:
            return
        for slot, res in enumerate(self._residents):
            if res is not None:
                continue
            req = self._next_admittable()
            if req is None:
                break
            try:
                if self._plan is not None and \
                        self._plan.fire("admit_err", req.index):
                    raise InjectedFault(
                        f"injected admit_err at request {req.index}")
                with trace_span(self._tracer, "serve.admit"):
                    t0 = time.perf_counter()
                    self._admit(slot, req)
                    admit_s = time.perf_counter() - t0
            except Exception as e:
                # Without the ladder only an injected fault (raised before
                # any write) is absorbed.
                if not self.recover and not isinstance(e, InjectedFault):
                    raise
                self._inc("serve_admit_errors")
                self._admit_errors += 1
                self._note_recovery_event()
                req.admit_attempts += 1
                if req.admit_attempts > self.retry_limit:
                    self._drop(req, "admit_failed", "admit")
                    log.warning("admission of request %r failed %d times "
                                "(%s); dropping", req.request_id,
                                req.admit_attempts, e)
                else:
                    self._queue.appendleft(req)  # head: retried next step
                    log.warning("admission of request %r failed (%s); "
                                "retry %d/%d at the next scheduler step",
                                req.request_id, e, req.admit_attempts,
                                self.retry_limit)
                break
            self._admit_s += admit_s
            self._residents[slot] = _Resident(req, slot,
                                              admit_at=self.clock())
            self._inc("serve_admitted")
            self._observe("serve_admit_ms", admit_s * 1e3)
            if self._lifecycle is not None:
                # admit_ms lets attribution carve the encoder pass out of
                # the queue wait.
                self._lifecycle.emit("admitted", req.request_id, slot=slot,
                                     admit_ms=round(admit_s * 1e3, 3))

    def _dispatch_chunk(self):
        """Run ONE chunk and fetch (fin, toks, pars), with the fault hooks
        and the garble check in the fetch path; commit the new state only
        after both passed."""
        k = self.beam_size
        live = [(slot, res) for slot, res in enumerate(self._residents)
                if res is not None]
        if self._plan is not None:
            for slot, res in live:
                if self._plan.fire("serve_wedge", res.request.index):
                    raise InjectedFault(
                        f"injected serve_wedge while request "
                        f"{res.request.index} resident in slot {slot}")
        # A host span: the launches and the fetch's wait on the device.
        with trace_span(self._tracer, "serve.decode_chunk"):
            t0 = time.perf_counter()
            self._chunk_dispatches += 1
            new, toks_d, pars_d = (self._run_greedy_chunk() if k == 1
                                   else self._run_beam_chunk())
            # One fetch per chunk (it waits for the device).
            fin = finished_mask(new["finished"]).cpu().numpy()
            toks = toks_d.cpu().numpy().astype(np.int32)
            pars = None if pars_d is None else pars_d.cpu().numpy()
            chunk_s = time.perf_counter() - t0
        if self._plan is not None:
            fired = [slot for slot, res in live
                     if self._plan.fire("serve_garble", res.request.index)]
            if fired:
                # A garbled device zeroes its buffers wholesale; zeroing
                # the fetch (copies: ``fin`` may view the state) is what
                # the scheduler would read.
                toks, fin = np.array(toks), np.array(fin)
                for slot in fired:
                    toks[slot] = 0
                    fin[slot] = False
        bad = garbled_decode_slots(toks, fin, [s for s, _ in live])
        if bad:
            self._inc("serve_garble_detected", len(bad))
            self._garbles += len(bad)
            if self.recover:
                raise GarbledChunk(bad)
            self._note_recovery_event()
            log.warning("garbled decode chunk (slots %s) with recovery "
                        "disabled; reporting as computed", bad)
        self._dev = new
        self._chunk_wall.append(chunk_s)
        self._decode_s += chunk_s
        chunk_ms = chunk_s * 1e3
        self._observe("serve_decode_step_ms", chunk_ms / self.chunk)
        if self.step_budget_ms and chunk_ms > self.step_budget_ms:
            self._slow_chunks += 1
            self._inc("serve_slow_chunks")
            self._note_recovery_event()
            log.warning("decode chunk took %.1fms (> %.1fms budget)",
                        chunk_ms, self.step_budget_ms)
        return fin, toks, pars

    def _run_chunk_recovered(self):
        """The ladder: bounded re-runs of the chunk from its pre-chunk
        state, then a rebuild, then :class:`ServingUnrecoverable`."""
        attempts = 0
        rebuilds = 0
        while True:
            try:
                return self._dispatch_chunk()
            except (InjectedFault, GarbledChunk, RuntimeError, OSError) as e:
                if isinstance(e, ServingUnrecoverable):
                    raise
                if not isinstance(e, GarbledChunk):
                    # The dispatch itself failed (serve_wedge, or a real
                    # device error): counted before the recover gate.
                    self._inc("serve_wedge_detected")
                    self._wedges += 1
                    self._note_recovery_event()
                if not self.recover:
                    raise
                self._note_recovery_event()
                attempts += 1
                self._inc("serve_chunk_retries")
                self._chunk_retries += 1
                if self._lifecycle is not None:
                    # Every resident aboard pays the failed dispatch.
                    for res in self._residents:
                        if res is not None:
                            self._lifecycle.emit(
                                "retry", res.request.request_id,
                                attempt=attempts, error=type(e).__name__)
                log.warning("serving chunk failed (%s); re-run %d/%d", e,
                            attempts, max(self.retry_limit, 1))
                if attempts <= self.retry_limit:
                    continue
                rebuilds += 1
                if rebuilds > self.rebuild_limit:
                    raise ServingUnrecoverable(
                        f"serving chunk failed through {attempts} "
                        f"re-run(s) and {rebuilds - 1} rebuild(s); last "
                        f"error: {e}") from e
                self._rebuild()
                attempts = 0

    def _rebuild(self) -> None:
        """Fresh slot state, residents re-admitted from their requests.
        Their emitted tokens become ``prefix``: the replay re-derives them
        from step 0 and harvest checks the match.  A kernel library built
        or loaded here counts in ``serve_rebuild_recompiles``."""
        events0 = _cuda.library_events()
        self._rebuilds += 1
        self._inc("serve_rebuilds")
        log.warning("serving engine rebuild #%d: re-initializing %d slots, "
                    "re-admitting %d resident(s)", self._rebuilds,
                    self._slots_n, self.resident_count)
        self._dev = self._init_state(self._slots_n)
        for slot, res in enumerate(self._residents):
            if res is None:
                continue
            if res.toks:
                prior = np.concatenate(res.toks, axis=0)
                # Both records start at step 0: extend the prefix by what
                # this run emitted past it.
                if res.prefix is None:
                    res.prefix = prior
                elif len(prior) > len(res.prefix):
                    res.prefix = np.concatenate(
                        [res.prefix, prior[len(res.prefix):]], axis=0)
            res.toks, res.pars, res.steps = [], [], 0
            self._admit(slot, res.request)
            if self._lifecycle is not None:
                self._lifecycle.emit("rebuild", res.request.request_id,
                                     slot=slot, rebuild=self._rebuilds)
        delta = _cuda.library_events() - events0
        if delta:
            self._rebuild_recompiles += delta
            self._inc("serve_rebuild_recompiles", delta)
            log.error("engine rebuild built or loaded %d kernel "
                      "librar(y/ies)", delta)
        self._note_recovery_event()

    def step(self) -> List[Completion]:
        """One scheduler step: evict past-deadline residents, fill free
        slots from the queue, run ONE chunk over the slot batch (through
        the ladder), harvest every row whose per-row finished mask went
        True (freeing its slot), expire again, refill.  Cache hits since
        the last step come first."""
        done: List[Completion] = list(self._hits)
        self._hits.clear()
        self._expire_residents(self.clock())
        self._ensure_bucket()
        self._admit_pending()
        if self.resident_count == 0:
            self._update_gauges()
            return done
        k = self.beam_size
        fin, toks, pars = self._run_chunk_recovered()
        scores_h = lengths_h = None
        for slot, res in enumerate(self._residents):
            if res is None:
                continue
            res.toks.append(toks[slot])
            if pars is not None:
                res.pars.append(pars[slot])
            res.steps += self.chunk
            if self._lifecycle is not None:
                self._lifecycle.emit("decode_chunk", res.request.request_id,
                                     k=res.steps // self.chunk, slot=slot)
            if res.request.stream and k == 1:
                # Greedy tokens are final once fetched; beam emits its
                # one chunk in _harvest, after the backtrack.
                self._emit_stream_delta(res)
            if fin[slot] or res.steps >= self.max_len:
                if k > 1 and scores_h is None:
                    scores_h = self._dev["scores"].cpu()
                    lengths_h = self._dev["lengths"].cpu()
                done.append(self._harvest(slot, scores_h, lengths_h))
        self._expire_residents(self.clock())
        self._admit_pending()
        self._update_gauges()
        return done

    # -- streaming ---------------------------------------------------------

    def _caption_so_far(self, res: _Resident) -> np.ndarray:
        """The resident's caption tokens as of its latest chunk: its
        harvested chunks (not ``prefix``: a replay re-derives those into
        ``toks``), clamped at max_len, EOS-trimmed."""
        if not res.toks:
            return np.zeros((0,), np.int32)
        return _trim_eos(np.concatenate(res.toks, axis=0)[:self.max_len])

    def _emit_stream_delta(self, res: _Resident) -> None:
        """Emit the caption tokens past the watermark as one chunk.  The
        watermark only moves forward: mid-replay the re-derived caption
        is shorter than what was emitted, and nothing is emitted twice."""
        cap = self._caption_so_far(res)
        new = cap[res.streamed:]
        res.streamed = max(res.streamed, int(cap.size))
        if not new.size:
            return
        self._push_stream_chunk(res, new)

    def _push_stream_chunk(self, res: _Resident, tokens: np.ndarray) -> None:
        now = self.clock()
        if res.chunks_emitted == 0:
            res.first_emit = now
            ttft = now - res.request.arrival
            self._ttft.append(ttft)
            self._observe("serve_ttft_ms", ttft * 1e3)
        else:
            gap = now - res.last_emit
            self._gaps.append(gap)
            self._observe("serve_chunk_gap_ms", gap * 1e3)
        res.last_emit = now
        self._stream_chunks.append(
            StreamChunk(res.request.request_id, res.chunks_emitted,
                        np.asarray(tokens, np.int32), meta=res.request.meta))
        res.chunks_emitted += 1
        self._stream_emitted += 1
        self._inc("serve_stream_chunks")

    def _harvest(self, slot: int, scores_h, lengths_h) -> Completion:
        res = self._residents[slot]
        self._residents[slot] = None
        max_len = self.max_len
        all_toks = np.concatenate(res.toks, axis=0)
        diverged = False
        if res.prefix is not None:
            # The replay after a rebuild runs the same decode on the same
            # inputs: it must reproduce the emitted prefix bit for bit.
            n = min(len(res.prefix), len(all_toks))
            if not np.array_equal(all_toks[:n], res.prefix[:n]):
                diverged = True
                self._inc("serve_replay_divergence")
                self._replay_divergence += 1
                log.warning("request %r: the replay after a rebuild "
                            "diverged from its emitted prefix (slot %d)",
                            res.request.request_id, slot)
        if self.beam_size == 1:
            hist = all_toks[:max_len]
            row = np.zeros((max_len,), np.int32)
            row[:hist.shape[0]] = hist
        else:
            pars = np.concatenate(res.pars, axis=0)[:max_len]
            row = _backtrack_best(all_toks[:max_len], pars, scores_h[slot],
                                  lengths_h[slot], max_len, self.length_norm)
            if res.request.stream:
                trimmed = _trim_eos(row)
                if trimmed.size:
                    self._push_stream_chunk(res, trimmed)
        if res.request.cache_key is not None and \
                self._result_cache is not None:
            if diverged:
                # A diverged caption is suspect: never cached.
                self._result_cache.invalidate(res.request.cache_key)
            else:
                self._cache_misses += 1
                self._inc("serve_cache_misses")
                evicted = self._result_cache.put(res.request.cache_key, row)
                if evicted:
                    self._cache_evictions += evicted
                    self._inc("serve_cache_evictions", evicted)
        now = self.clock()
        comp = Completion(
            request_id=res.request.request_id, tokens=row, slot=slot,
            admit_at=res.admit_at, done_at=now,
            latency_s=now - res.request.arrival,
            decode_steps=min(res.steps, max_len), meta=res.request.meta,
            stream_chunks=res.chunks_emitted,
            ttft_s=(None if res.first_emit is None
                    else res.first_emit - res.request.arrival))
        self._completed += 1
        self._inc("serve_completed")
        self._latencies.append(comp.latency_s)
        self._observe("serve_request_latency_ms", comp.latency_s * 1e3)
        if res.request.deadline is not None:
            self._observe("serve_deadline_slack_ms",
                          (res.request.deadline - now) * 1e3)
        if self._lifecycle is not None:
            self._lifecycle.emit("completed", comp.request_id, ts=now,
                                 latency_ms=round(comp.latency_s * 1e3, 3),
                                 slot=slot, decode_steps=comp.decode_steps)
        return comp

    def drain(self, abort: Optional[Callable[[], bool]] = None
              ) -> Tuple[List[Completion], List[Request]]:
        """Graceful shutdown: reject everything still queued, run the
        resident rows to completion with admissions closed, return
        (completions, rejected requests).  ``abort`` is polled between
        steps: True stops the drain with the residents abandoned."""
        rejected = list(self._queue)
        self._queue.clear()
        if rejected:
            self._rejected += len(rejected)
            self._inc("serve_rejected_drain", len(rejected))
            if self._lifecycle is not None:
                for req in rejected:
                    self._lifecycle.emit("dropped", req.request_id,
                                         reason="rejected_draining",
                                         where="drain")
        done: List[Completion] = list(self._hits)
        self._hits.clear()
        while any(r is not None for r in self._residents):
            if abort is not None and abort():
                log.warning("drain aborted with %d resident(s) unfinished",
                            self.resident_count)
                break
            done.extend(self.step())
        self._update_gauges()
        return done, rejected

    def run_until_idle(self) -> List[Completion]:
        """Step until queue and slots are empty.  Progress is guaranteed:
        every resident force-finishes at max_len steps."""
        done: List[Completion] = []
        while not self.idle:
            done.extend(self.step())
        return done

    # -- warm-up, stats and health ------------------------------------------

    def kernel_functions(self) -> List[Tuple[str, str]]:
        """The (library, function) pairs of ``ops/_cuda.py`` this engine's
        decode path launches: K2's launcher for ``decode_kernel="fused"``,
        K1's for the reference cell with the attention kernel."""
        m = self.model
        if m.decode_kernel == "fused":
            return [("decode_cell", decode_cell_kernel.LAUNCHERS[m.dtype])]
        if getattr(getattr(m.cell, "attn", None), "use_kernel", False):
            return [("attention", attention_kernel.LAUNCHERS[m.dtype])]
        return []

    def warm(self) -> Dict[str, Any]:
        """Build (where not built yet) and load the kernel library of this
        engine's configuration, so no request pays for it; a second
        engine's, or a restarted replica's, warm-up loads nothing.  There
        are no programs to compile.  -> ``stats()`` plus ``compiles``, the
        kernel-library builds and loads this call made (0 once loaded;
        0 on the CPU, where the plain versions run)."""
        events0 = _cuda.library_events()
        if self.device.type == "cuda":
            for lib, fn in self.kernel_functions():
                _cuda.load(lib, fn)
        return {**self.stats(),
                "compiles": _cuda.library_events() - events0}

    def stats(self) -> Dict[str, Any]:
        lat = np.asarray(self._latencies, np.float64) * 1e3
        pct = (lambda q: float(np.percentile(lat, q)) if lat.size else None)
        steps = self._chunk_dispatches * self.chunk
        now = launch_counts()
        out = {
            "slots": self._slots_n,
            "buckets": list(self.buckets),
            "beam_size": self.beam_size,
            "decode_chunk": self.chunk,
            "decode_kernel": self.model.decode_kernel,
            "residents": self.resident_count,
            "queue_depth": len(self._queue),
            "submitted": self._submitted,
            "completed": self._completed,
            "shed": self._shed,
            "rejected_drain": self._rejected,
            "chunk_dispatches": self._chunk_dispatches,
            "decode_steps": steps,
            "decode_ms_per_step": (self._decode_s * 1e3 / steps
                                   if steps else None),
            "admit_ms_total": self._admit_s * 1e3,
            "latency_p50_ms": pct(50),
            "latency_p99_ms": pct(99),
            "latency_mean_ms": float(lat.mean()) if lat.size else None,
            # Kernel launches since this engine was built (process-wide
            # counters, so another engine running meanwhile adds to them).
            "kernel_launches": {name: now[name] - self._launches0[name]
                                for name in now},
            **self.recovery_counters(),
            **self.cache_counters(),
            **self.stream_stats(),
        }
        # A lone engine holds the base tracer and reports attribution; a
        # fleet replica holds a labeled view, and the router reports it.
        if self._lifecycle is not None and \
                hasattr(self._lifecycle, "attribution_report"):
            out["attribution"] = self._lifecycle.attribution_report()
        return out

    def cache_counters(self) -> Dict[str, Any]:
        """The result cache's counters (stats, the bench probe)."""
        armed = self._result_cache is not None
        return {
            "cache_armed": armed,
            "cache_hits": self._cache_hits,
            "cache_misses": self._cache_misses,
            "cache_evictions": self._cache_evictions,
            "cache_bypass": self._cache_bypass,
            "cache_errors": self._cache_errors,
            "cache_entries": len(self._result_cache) if armed else 0,
            "cache_capacity": (self._result_cache.capacity if armed
                               else 0),
        }

    def stream_stats(self) -> Dict[str, Any]:
        """Stream chunks emitted, and TTFT and chunk-gap percentiles over
        the retained windows."""
        ttft = np.asarray(self._ttft, np.float64) * 1e3
        gaps = np.asarray(self._gaps, np.float64) * 1e3
        p = (lambda a, q: round(float(np.percentile(a, q)), 3)
             if a.size else None)
        return {
            "stream_chunks": self._stream_emitted,
            "ttft_p50_ms": p(ttft, 50),
            "ttft_p99_ms": p(ttft, 99),
            "chunk_gap_p50_ms": p(gaps, 50),
            "chunk_gap_p99_ms": p(gaps, 99),
        }

    def recovery_counters(self) -> Dict[str, int]:
        """The recovery counters: the one dict that ``stats()``,
        ``health()`` and the bench probe all report."""
        return {
            "expired": self._expired,
            "deadline_shed": self._deadline_shed,
            "chunk_retries": self._chunk_retries,
            "rebuilds": self._rebuilds,
            "rebuild_recompiles": self._rebuild_recompiles,
            "garble_detected": self._garbles,
            "wedge_detected": self._wedges,
            "admit_errors": self._admit_errors,
            "replay_divergence": self._replay_divergence,
        }

    def health(self) -> Dict[str, Any]:
        """``ok`` | ``degraded`` (a recovery event within
        :data:`DEGRADED_WINDOW_S`), queue depth and the recovery counters.
        Reads the scheduler's deques: call it from the scheduler's thread
        (the server publishes a copy for the watchdog's)."""
        floor = self.min_service_s()
        return {
            "status": health_status(draining=False,
                                    recovering=self.degraded()),
            "queue_depth": len(self._queue),
            "residents": self.resident_count,
            "slots": self._slots_n,
            "completed": self._completed,
            "recovery": self.recovery_counters(),
            "slow_chunks": self._slow_chunks,
            "min_service_ms": (None if floor is None
                               else round(floor * 1e3, 3)),
        }

    # -- telemetry ---------------------------------------------------------

    def _note_recovery_event(self) -> None:
        self._last_recovery_at = self.clock()

    def _inc(self, name: str, n: float = 1) -> None:
        if self._registry is not None:
            self._registry.inc(name, n)

    def _observe(self, name: str, value: float) -> None:
        if self._registry is not None:
            self._registry.observe(name, value)

    def _update_gauges(self) -> None:
        if self._registry is None:
            return
        self._registry.set_gauge("serve_queue_depth", len(self._queue))
        self._registry.set_gauge(
            "serve_slot_occupancy",
            self.resident_count / self._slots_n if self._slots_n else 0.0)
        if self._latencies:
            lat = np.asarray(self._latencies, np.float64) * 1e3
            self._registry.set_gauge("serve_latency_p50_ms",
                                     float(np.percentile(lat, 50)))
            self._registry.set_gauge("serve_latency_p99_ms",
                                     float(np.percentile(lat, 99)))


def _trim_eos(tokens: np.ndarray) -> np.ndarray:
    """Caption tokens up to (excluding) the first EOS/PAD 0."""
    t = np.asarray(tokens, np.int32).reshape(-1)
    nz = np.flatnonzero(t == 0)
    return t[: int(nz[0])] if nz.size else t


def _backtrack_best(toks: np.ndarray, pars: np.ndarray, scores, lengths,
                    max_len: int, length_norm: float) -> np.ndarray:
    """Host-side twin of ``ops/beam.py``'s backtrack + ranking for ONE
    slot.  ``toks``/``pars`` are the slot's executed steps (T <= max_len;
    steps past a slot's finish are the all-finished no-op — token 0 at
    parent identity — so backtracking through them reproduces the
    full-length backtrack).  Ranking goes through ``rank_beams`` and a
    stable argsort, as offline."""
    steps, k = toks.shape
    beam_ix = np.arange(k)
    seq = np.zeros((k, max_len), np.int32)
    for t in range(steps - 1, -1, -1):
        seq[:, t] = toks[t, beam_ix]
        beam_ix = pars[t, beam_ix]
    ranked = rank_beams(scores, lengths, length_norm)
    order = torch.argsort(-ranked, stable=True)
    return seq[int(order[0])]


def serve_decode_batch(model, feats_list: Sequence[Sequence[np.ndarray]],
                       max_len: int, beam_size: int = 1,
                       length_norm: float = 0.0, decode_chunk: int = 8,
                       bucket_sizes: Sequence[int] = DEFAULT_BUCKETS
                       ) -> List[np.ndarray]:
    """Decode a batch of videos through the serving engine (offline load)
    -> one 0-terminated (max_len,) token row per video, in input order."""
    feats_list = [list(f) for f in feats_list]
    if not feats_list:
        return []
    engine = ServingEngine(
        model, [f.shape for f in feats_list[0]], max_len=max_len,
        beam_size=beam_size, length_norm=length_norm,
        decode_chunk=decode_chunk, bucket_sizes=bucket_sizes,
        queue_limit=0)
    for i, feats in enumerate(feats_list):
        engine.submit(i, feats)
    tokens = {c.request_id: c.tokens for c in engine.run_until_idle()}
    return [tokens[i] for i in range(len(feats_list))]


def serve_decode_split(model, loader, vocab, max_len: int,
                       beam_size: int = 1, length_norm: float = 0.0,
                       decode_chunk: int = 8,
                       bucket_sizes: Sequence[int] = DEFAULT_BUCKETS
                       ) -> List[Dict[str, str]]:
    """Decode a whole split through the serving engine (offline load) ->
    ``[{"image_id", "caption"}]`` in dataset order: the twin of
    ``training.evaluation.decode_split`` that ``eval --engine serving``
    holds caption for caption against it.  Every video is submitted once
    (the loader's wrap padding skipped); the engine steps after each
    batch is submitted and then runs to idle."""
    ds = loader.ds
    engine = ServingEngine(
        model, list(zip(ds.feat_times, ds.feat_dims)), max_len=max_len,
        beam_size=beam_size, length_norm=length_norm,
        decode_chunk=decode_chunk, bucket_sizes=bucket_sizes,
        queue_limit=0)
    order, seen, tokens = [], set(), {}
    for batch in loader.iter_eval():
        for j, vid in enumerate(batch.video_ids):
            if vid in seen:
                continue
            seen.add(vid)
            order.append(vid)
            engine.submit(vid, [f[j] for f in batch.feats])
        for comp in engine.step():
            tokens[comp.request_id] = comp.tokens
    for comp in engine.run_until_idle():
        tokens[comp.request_id] = comp.tokens
    return [{"image_id": vid, "caption": vocab.decode(tokens[vid])}
            for vid in order]
