"""JSONL caption server over one ``ServingEngine`` (counterpart of the
stdin front end of the reference's ``serving/server.py``).

Protocol: one JSON object per line on stdin, one per line on stdout::

    {"id": 1, "video_id": "v3"}
    -> {"id": 1, "video_id": "v3", "caption": "...", "latency_ms": 12.3}

Failures answer on the same line protocol: ``bad_request`` (unparseable
line, no ``video_id``, wrong feature shapes), ``unknown_video``, ``shed``
(the bounded queue is full) and, during a drain, ``rejected_draining``.

Shutdown: stdin EOF finishes every accepted request and exits 0.
SIGTERM/SIGINT drains: resident captions complete, queued requests are
rejected, and the process exits 75 (``EXIT_PREEMPTED``: transient,
retry).  The socket front end, streaming, deadlines and the health plane
of the reference server are not ported yet.

A reader thread moves stdin lines into an inbox; only the scheduler loop
touches the engine.
"""

from __future__ import annotations

import json
import queue
import signal
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..resilience.exitcodes import EXIT_OK, EXIT_PREEMPTED
from .engine import Completion, ServingEngine

IDLE_SLEEP_S = 0.002     # scheduler nap when idle with nothing to read


class PreemptionHandler:
    """SIGTERM/SIGINT -> ``requested``, checked between scheduler steps."""

    def __init__(self):
        self.requested = False

    def _on_signal(self, signum, frame) -> None:
        self.requested = True

    def install(self) -> "PreemptionHandler":
        signal.signal(signal.SIGTERM, self._on_signal)
        signal.signal(signal.SIGINT, self._on_signal)
        return self


class CaptionServer:
    """Line-protocol server around one :class:`ServingEngine`.

    ``feats_for(video_id)`` -> per-modality ``(T, D)`` feature list, or
    None for an unknown id.  ``handler`` is anything with a ``requested``
    attribute (a :class:`PreemptionHandler` or a test stub)."""

    def __init__(self, engine: ServingEngine, vocab,
                 feats_for: Callable[[Any], Optional[list]], *,
                 handler=None, out=None):
        self.engine = engine
        self.vocab = vocab
        self.feats_for = feats_for
        self.handler = handler
        self.out = out if out is not None else sys.stdout
        self._inbox: "queue.Queue[str]" = queue.Queue()
        self._eof = threading.Event()

    def _write(self, obj: Dict[str, Any]) -> None:
        self.out.write(json.dumps(obj) + "\n")
        self.out.flush()

    def _respond_completion(self, comp: Completion) -> None:
        meta = comp.meta or {}
        self._write({"id": meta.get("id"),
                     "video_id": meta.get("video_id"),
                     "caption": self.vocab.decode(comp.tokens),
                     "latency_ms": round(comp.latency_s * 1e3, 3),
                     "decode_steps": int(comp.decode_steps)})

    def _handle_line(self, line: str) -> None:
        line = line.strip()
        if not line:
            return
        try:
            req = json.loads(line)
        except ValueError:
            self._write({"id": None, "error": "bad_request",
                         "detail": "unparseable JSON line"})
            return
        if not isinstance(req, dict) or req.get("video_id") is None:
            self._write({"id": req.get("id") if isinstance(req, dict)
                         else None, "error": "bad_request",
                         "detail": "expected {'id', 'video_id'}"})
            return
        rid, vid = req.get("id"), req["video_id"]
        feats = self.feats_for(vid)
        if feats is None:
            self._write({"id": rid, "error": "unknown_video",
                         "video_id": vid})
            return
        try:
            ok = self.engine.submit((rid, vid),
                                    [np.asarray(f) for f in feats],
                                    meta={"id": rid, "video_id": vid})
        except ValueError as e:
            self._write({"id": rid, "error": "bad_request",
                         "detail": str(e)})
            return
        if not ok:
            self._write({"id": rid, "error": "shed", "video_id": vid,
                         "queue_depth": self.engine.queue_depth})

    def _drain_and_exit(self) -> int:
        print(f"serve: draining {self.engine.resident_count} resident(s), "
              f"{self.engine.queue_depth} queued", file=sys.stderr)
        done, rejected = self.engine.drain()
        for comp in done:
            self._respond_completion(comp)
        for req in rejected:
            meta = req.meta or {}
            self._write({"id": meta.get("id"),
                         "video_id": meta.get("video_id"),
                         "error": "rejected_draining"})
        print(f"serve: drained {len(done)} in-flight, rejected "
              f"{len(rejected)} queued; exiting {EXIT_PREEMPTED}",
              file=sys.stderr)
        return EXIT_PREEMPTED

    def _loop(self) -> int:
        while True:
            if self.handler is not None and self.handler.requested:
                return self._drain_and_exit()
            moved = False
            while True:
                try:
                    line = self._inbox.get_nowait()
                except queue.Empty:
                    break
                self._handle_line(line)
                moved = True
            comps = self.engine.step()
            for comp in comps:
                self._respond_completion(comp)
            moved = moved or bool(comps)
            if self._eof.is_set() and self.engine.idle \
                    and self._inbox.empty():
                return EXIT_OK
            if not moved and self.engine.idle:
                time.sleep(IDLE_SLEEP_S)

    def run_stdin(self, lines=None) -> int:
        """Serve JSONL requests from ``lines`` (default: sys.stdin) until
        EOF (exit 0) or a preemption signal (drain, exit 75)."""
        src = lines if lines is not None else sys.stdin

        def read():
            try:
                for line in src:
                    self._inbox.put(line)
            finally:
                self._eof.set()

        threading.Thread(target=read, name="serve-stdin",
                         daemon=True).start()
        return self._loop()
