"""Step-driven continuous-batching scheduler over the decode path
(counterpart of the core of the reference's ``serving/engine.py``).

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

Deadlines, fault recovery, streaming, the result cache and the fleet of
the reference engine are not ported yet.  The engine is single-owner:
``submit``/``step``/``drain`` are called from one thread.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import launch_counts
from ..ops.beam import NEG_INF, _expand_to_beams, beam_step, rank_beams
from ..ops.sampling import finished_mask, make_decode_step
from .buckets import DEFAULT_BUCKETS, pick_bucket


@dataclass
class Request:
    """One queued video: opaque id + per-modality ``(T, D)`` features."""

    request_id: Any
    feats: List[np.ndarray]
    arrival: float = 0.0
    meta: Optional[dict] = None


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


@dataclass
class _Resident:
    request: Request
    slot: int
    admit_at: float
    steps: int = 0
    toks: List[np.ndarray] = field(default_factory=list)
    pars: List[np.ndarray] = field(default_factory=list)


class ServingEngine:
    """Continuous batching over the greedy / beam decode.

    ``model`` is a ``CaptionModel`` already on its device (the engine runs
    there); ``feat_shapes`` the per-modality ``(T, D)`` geometry every
    request must match.  ``queue_limit`` bounds the submit queue (0/None =
    unbounded); ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, model, feat_shapes: Sequence[Tuple[int, int]], *,
                 max_len: int, beam_size: int = 1, length_norm: float = 0.0,
                 decode_chunk: int = 8,
                 bucket_sizes: Sequence[int] = DEFAULT_BUCKETS,
                 queue_limit: Optional[int] = 64,
                 clock: Callable[[], float] = time.monotonic):
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
        self.clock = clock
        self._queue: deque = deque()
        self._residents: List[Optional[_Resident]] = []
        self._slots_n = 0
        self._dev: Optional[Dict[str, Any]] = None
        self._latencies: deque = deque(maxlen=1024)
        self._submitted = 0
        self._completed = 0
        self._shed = 0
        self._rejected = 0
        self._chunk_dispatches = 0
        self._decode_s = 0.0
        self._admit_s = 0.0
        self._launches0 = launch_counts()

    # -- device state ------------------------------------------------------

    def _init_state(self, slots: int) -> Dict[str, Any]:
        """All-slots-empty state: finished=True / steps=max_len, so empty
        rows are provable no-ops until an admission claims them."""
        m, k, dev = self.model, self.beam_size, self.device
        rows = slots * k
        t = sum(s[0] for s in self._feat_shapes)

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
        rows in place."""
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
        st["steps"][slot] = 0
        st["prev"][slot] = 0
        st["finished"][slot] = False
        if k > 1:
            # Step-0 beam mask as ADMISSION SCORES: only beam 0 live.
            st["scores"][slot] = NEG_INF
            st["scores"][slot, 0] = 0.0
            st["lengths"][slot] = 0

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
        st.update(carry=carry, prev=prev, finished=finished, steps=steps)
        return torch.stack(emits, dim=1), None          # (slots, chunk)

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
        st.update(carry=carry, prev=prev, scores=scores, finished=finished,
                  lengths=lengths, steps=steps)
        # (slots, chunk, k) for the per-slot harvest.
        return torch.stack(toks, dim=1), torch.stack(pars, dim=1)

    # -- queue -------------------------------------------------------------

    def submit(self, request_id, feats: Sequence[np.ndarray],
               meta: Optional[dict] = None) -> bool:
        """Queue one request.  Returns False (sheds) when the bounded
        queue is full — the engine's backpressure signal."""
        self._submitted += 1
        feats = [np.asarray(f, np.float32) for f in feats]
        shapes = tuple(f.shape for f in feats)
        if shapes != self._feat_shapes:
            raise ValueError(
                f"request {request_id!r} feature shapes {shapes} do not "
                f"match the engine's geometry {self._feat_shapes}")
        if self.queue_limit and len(self._queue) >= self.queue_limit:
            self._shed += 1
            return False
        self._queue.append(Request(request_id, feats, arrival=self.clock(),
                                   meta=meta))
        return True

    @property
    def idle(self) -> bool:
        return not self._queue and not any(self._residents)

    @property
    def resident_count(self) -> int:
        return sum(1 for r in self._residents if r is not None)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

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
        for slot, res in enumerate(self._residents):
            if not self._queue:
                return
            if res is not None:
                continue
            req = self._queue.popleft()
            t0 = time.perf_counter()
            self._admit(slot, req)
            self._admit_s += time.perf_counter() - t0
            self._residents[slot] = _Resident(req, slot,
                                              admit_at=self.clock())

    def step(self) -> List[Completion]:
        """One scheduler step: fill free slots from the queue, run ONE
        chunk over the slot batch, harvest every row whose per-row
        finished mask went True (freeing its slot), refill."""
        self._ensure_bucket()
        self._admit_pending()
        done: List[Completion] = []
        if self.resident_count == 0:
            return done
        k = self.beam_size
        t0 = time.perf_counter()
        self._chunk_dispatches += 1
        toks_d, pars_d = (self._run_greedy_chunk() if k == 1
                          else self._run_beam_chunk())
        # One fetch per chunk (it waits for the device).
        fin = finished_mask(self._dev["finished"]).cpu().numpy()
        toks = toks_d.cpu().numpy().astype(np.int32)
        pars = None if pars_d is None else pars_d.cpu().numpy()
        self._decode_s += time.perf_counter() - t0
        scores_h = lengths_h = None
        for slot, res in enumerate(self._residents):
            if res is None:
                continue
            res.toks.append(toks[slot])
            if pars is not None:
                res.pars.append(pars[slot])
            res.steps += self.chunk
            if fin[slot] or res.steps >= self.max_len:
                if k > 1 and scores_h is None:
                    scores_h = self._dev["scores"].cpu()
                    lengths_h = self._dev["lengths"].cpu()
                done.append(self._harvest(slot, scores_h, lengths_h))
        self._admit_pending()
        return done

    def _harvest(self, slot: int, scores_h, lengths_h) -> Completion:
        res = self._residents[slot]
        self._residents[slot] = None
        max_len = self.max_len
        all_toks = np.concatenate(res.toks, axis=0)[:max_len]
        if self.beam_size == 1:
            row = np.zeros((max_len,), np.int32)
            row[:all_toks.shape[0]] = all_toks
        else:
            pars = np.concatenate(res.pars, axis=0)[:max_len]
            row = _backtrack_best(all_toks, pars, scores_h[slot],
                                  lengths_h[slot], max_len, self.length_norm)
        now = self.clock()
        comp = Completion(
            request_id=res.request.request_id, tokens=row, slot=slot,
            admit_at=res.admit_at, done_at=now,
            latency_s=now - res.request.arrival,
            decode_steps=min(res.steps, max_len), meta=res.request.meta)
        self._completed += 1
        self._latencies.append(comp.latency_s)
        return comp

    def drain(self) -> Tuple[List[Completion], List[Request]]:
        """Graceful shutdown: reject everything still queued, run the
        resident rows to completion with admissions closed, return
        (completions, rejected requests)."""
        rejected = list(self._queue)
        self._queue.clear()
        self._rejected += len(rejected)
        done: List[Completion] = []
        while self.resident_count:
            done.extend(self.step())
        return done, rejected

    def run_until_idle(self) -> List[Completion]:
        """Step until queue and slots are empty.  Progress is guaranteed:
        every resident force-finishes at max_len steps."""
        done: List[Completion] = []
        while not self.idle:
            done.extend(self.step())
        return done

    # -- stats -------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        lat = np.asarray(self._latencies, np.float64) * 1e3
        pct = (lambda q: float(np.percentile(lat, q)) if lat.size else None)
        steps = self._chunk_dispatches * self.chunk
        now = launch_counts()
        return {
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
        }


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
