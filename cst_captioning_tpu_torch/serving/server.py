"""JSONL caption server over one ``ServingEngine``: stdin/stdout or a
localhost socket (counterpart of the reference's ``serving/server.py``).

Protocol, one JSON object per line either way::

    request:  {"id": <any>, "video_id": "<key>"}
              optional: "op": "caption" (default) | "stream" | "health"
                        | "stats" | "ping" | "dump",
                        "deadline_ms": <this request's deadline>,
                        "no_cache": true (skip the result cache),
                        "idem": "<key>" (a string, echoed on the terminal
                        response), "trace": {"id", ...} (a front end's
                        trace context, echoed as the lifecycle events'
                        trace_id)
    response: {"id", "video_id", "caption", "latency_ms", "decode_steps"}
              (a cache hit adds "cached": true; a streamed final adds
              "stream": true, "final": true, "chunks": N, "ttft_ms")
    stream:   {"id", "video_id", "stream": true, "seq": k, "tokens": [..],
               "text": "<new words>", "final": false}: one line per chunk
              with new tokens, before the final; the "text" fragments
              joined by spaces are the caption
    health:   {"op": "health", "status": "ok"|"degraded"|"draining",
               "queue_depth", "residents", "recovery": {...}, ...}
    stats:    {"op": "stats", ...the engine's (or fleet's) stats()...},
              with the latency attribution when lifecycle tracing is on
    ping:     {"op": "ping", "seq", "t0", "mono", "wall", "pid"}
    dump:     {"op": "dump"} -> the flight recorder writes blackbox.json
              (atomically) and answers {"op": "dump", "path", "events",
              "emitted"}; "path" in the request overrides the configured
              one.  Errors: "no_recorder" (tracing off), "no_path"
    reject:   {"id", "error": "shed" | "bad_request" | "unknown_video"
               | "unknown_op" | "rejected_draining" | "expired"
               | "admit_failed", ...}; "expired" carries "where"
              ("queued" | "resident" | "fleet"), and a deadline shed adds
              "why": "deadline_unmeetable"; a fleet's "admit_failed" says
              "where": "fleet".  A streamed request's terminal line
              carries "stream": true, "final": true whatever it says.

``engine`` is one ``ServingEngine`` or a ``serving.fleet.FleetRouter``:
both speak the same scheduler surface.  ``health_source`` replaces
``engine.health`` as the health reply's body (the fleet's worst-of view
with every replica's detail); the server folds its own draining state on
top.  ``lifecycle`` (the base ``LifecycleTracer``) gets the terminal
``responded`` events, and the flight recorder is written to
``blackbox_path`` on the ``dump`` op and on an aborted drain.

Reader threads (stdin, or one per socket connection) only put ``(line,
respond)`` into an inbox; the scheduler loop alone touches the engine.
A bad line gets a per-line error and counts ``serve_bad_lines``; it
never stops the loop.  Responses are written under one write lock, and a
socket connection's ``respond`` then takes its own connection lock:
write before connection, always in that order.

Shutdown: stdin EOF finishes every accepted request and exits 0.
SIGTERM/SIGINT (``resilience.preemption.PreemptionHandler``) drains:
resident captions complete, queued requests are answered
``rejected_draining``, and the process exits 75 (``EXIT_PREEMPTED``).  A
second signal during the drain aborts it: the unfinished residents are
answered ``rejected_draining`` too, and the exit is 143
(``EXIT_SIGTERM``).  With a watchdog attached the loop beats it once per
iteration, so a wedged loop becomes exit 124, and publishes a copy of
the health reply once per iteration (``published_health``): the
watchdog's heartbeat reads that copy and never the engine.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import socket
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..ops import _cuda
from ..resilience.exitcodes import EXIT_OK, EXIT_PREEMPTED, EXIT_SIGTERM
from ..resilience.garble import health_status
from ..utils.locksan import LockOrderViolation, declare_order, named_lock
from .engine import Completion, Dropped, ServingEngine, StreamChunk

log = logging.getLogger(__name__)

#: Declared acquisition order (``utils/locksan.py``): ``_write`` holds the
#: write lock while a socket's ``respond`` takes its connection lock.
LOCK_ORDER = ("serving.server.write", "serving.server.conn")
declare_order(*LOCK_ORDER)

_warned_stream_legacy = False


def warn_stream_legacy_scan() -> None:
    """Once per process, on the first ``stream`` op an engine built with
    ``--decode_chunk 0`` gets: the whole caption is one chunk, so the
    stream is one terminal chunk after the whole decode."""
    global _warned_stream_legacy
    if _warned_stream_legacy:
        return
    _warned_stream_legacy = True
    print("warning: {\"op\": \"stream\"} with --decode_chunk 0 (one "
          "full-length decode loop) emits everything at once; streaming "
          "degenerates to one terminal chunk; pass a chunked "
          "--decode_chunk (e.g. 8) to stream tokens per chunk",
          file=sys.stderr)

IDLE_SLEEP_S = 0.002     # scheduler nap when idle with nothing to read


class CaptionServer:
    """Line-protocol server around one :class:`ServingEngine`.

    ``feats_for(video_id)`` -> per-modality ``(T, D)`` feature list, or
    None for an unknown id.  ``handler`` is anything with ``requested``
    and ``signal_count`` attributes (a ``PreemptionHandler`` or a test
    stub).  ``watchdog`` (optional) is beaten once per loop iteration;
    ``registry`` (optional) counts bad lines and queries;
    ``health_source``, ``lifecycle`` and ``blackbox_path`` as in the
    module docstring.  The loop naps :data:`IDLE_SLEEP_S` when it is idle
    with nothing to read."""

    def __init__(self, engine: ServingEngine, vocab,
                 feats_for: Callable[[Any], Optional[list]], *,
                 handler=None, out=None, watchdog=None, registry=None,
                 health_source=None, lifecycle=None, blackbox_path=None):
        self.engine = engine  # cstlint-torch: owned_by=scheduler
        self.vocab = vocab
        self.feats_for = feats_for
        self.handler = handler
        self.out = out if out is not None else sys.stdout
        self.watchdog = watchdog
        self.registry = registry
        self._health_source = health_source
        self._lifecycle = lifecycle
        self.blackbox_path = blackbox_path
        if registry is not None:
            registry.declare("serve_bad_lines", "serve_health_queries",
                             "serve_stats_queries", "serve_dump_queries",
                             "serve_ping_queries")
        self._inbox: "queue.Queue" = queue.Queue()
        self._eof = threading.Event()
        self._write_lock = named_lock("serving.server.write")
        self._draining = False  # cstlint-torch: owned_by=scheduler
        #: The socket front end's bound port; None until it binds.
        self.bound_port: Optional[int] = None
        self._published_health = self.health_payload()

    # -- responses ---------------------------------------------------------

    def _write(self, respond: Callable[[str], None], obj: Dict[str, Any]):
        with self._write_lock:
            respond(json.dumps(obj))

    def _stdout_respond(self, line: str) -> None:
        self.out.write(line + "\n")
        self.out.flush()

    @staticmethod
    def _mark_stream_terminal(obj: Dict[str, Any], streamed) -> Dict[str, Any]:
        """Every streamed request's last line carries ``"final": true``,
        whatever it says, so a client reading until it never hangs."""
        if streamed:
            obj["stream"] = True
            obj["final"] = True
        return obj

    def _respond_completion(self, comp: Completion) -> None:
        meta = comp.meta or {}
        obj = {"id": meta.get("id"),
               "video_id": meta.get("video_id"),
               "caption": self.vocab.decode(comp.tokens),
               "latency_ms": round(comp.latency_s * 1e3, 3),
               "decode_steps": int(comp.decode_steps)}
        if comp.cache_hit:
            obj["cached"] = True
        if meta.get("stream"):
            obj["stream"] = True
            obj["final"] = True
            obj["chunks"] = int(comp.stream_chunks)
            if comp.ttft_s is not None:
                obj["ttft_ms"] = round(comp.ttft_s * 1e3, 3)
        if meta.get("idem") is not None:
            obj["idem"] = meta["idem"]
        self._write(meta.get("respond", self._stdout_respond), obj)
        if self._lifecycle is not None:
            self._lifecycle.emit("responded", comp.request_id, status="ok")

    def _respond_stream_chunk(self, chunk: StreamChunk) -> None:
        meta = chunk.meta or {}
        self._write(meta.get("respond", self._stdout_respond), {
            "id": meta.get("id"),
            "video_id": meta.get("video_id"),
            "stream": True,
            "seq": int(chunk.seq),
            "tokens": [int(t) for t in chunk.tokens],
            "text": self.vocab.decode(chunk.tokens),
            "final": False,
        })

    def _respond_stream_all(self) -> bool:
        chunks = self.engine.pop_stream_chunks()
        for chunk in chunks:
            self._respond_stream_chunk(chunk)
        return bool(chunks)

    def _respond_dropped(self, drop: Dropped) -> None:
        meta = drop.meta or {}
        obj = self._mark_stream_terminal(
            {"id": meta.get("id"), "video_id": meta.get("video_id"),
             "error": ("admit_failed" if drop.reason == "admit_failed"
                       else "expired")}, meta.get("stream"))
        if drop.reason in ("expired", "deadline_shed") or (
                drop.reason == "admit_failed" and drop.where == "fleet"):
            obj["where"] = drop.where      # "queued" | "resident" | "fleet"
        if drop.reason == "deadline_shed":
            obj["why"] = "deadline_unmeetable"
        if meta.get("idem") is not None:
            obj["idem"] = meta["idem"]
        self._write(meta.get("respond", self._stdout_respond), obj)
        if self._lifecycle is not None:
            self._lifecycle.emit("responded", drop.request_id,
                                 status=obj["error"])

    def _respond_dropped_all(self) -> bool:
        drops = self.engine.pop_dropped()
        for drop in drops:
            self._respond_dropped(drop)
        return bool(drops)

    def _count(self, name: str) -> None:
        if self.registry is not None:
            self.registry.inc(name)

    # -- the health plane --------------------------------------------------

    def health_payload(self) -> Dict[str, Any]:
        """The ``{"op": "health"}`` reply: the health source's view
        (``engine.health()`` by default) with the server's draining state
        folded in.  A source that already says ``draining`` (a fleet with
        a rotating replica) stays ``draining``."""
        source = (self._health_source if self._health_source is not None
                  else self.engine.health)
        h = source()
        if h["status"] != "draining":
            h["status"] = health_status(
                draining=self._draining or bool(
                    self.handler is not None and self.handler.requested),
                recovering=(h["status"] == "degraded"))
        h["op"] = "health"
        # The process's kernel-library builds and loads so far: a process
        # fleet's supervisor reads the first value after warm-up as the
        # baseline that no later request may move.
        h["compiles"] = _cuda.library_events()
        return h

    def published_health(self) -> Dict[str, Any]:
        """The health reply as the scheduler loop last published it (once
        per iteration, and when a drain starts): what another thread, the
        watchdog's heartbeat, reads instead of the engine's live state.
        A published dict is never mutated; the loop replaces it whole."""
        return self._published_health

    # -- intake (reader threads -> inbox -> scheduler loop) ----------------

    def _handle_line(self, line: str, respond: Callable[[str], None]):
        """Parse and act on one client line.  Every failure answers with
        a per-line error and counts: the loop survives any input."""
        try:
            self._handle_line_inner(line, respond)
        except LockOrderViolation:
            raise  # a fault of this process, not of the line: die loudly
        except Exception as e:  # one bad line must never kill the loop
            self._count("serve_bad_lines")
            try:
                self._write(respond, {"id": None, "error": "bad_request",
                                      "detail": f"line handling failed: {e}"})
            except LockOrderViolation:
                raise
            except Exception as werr:   # the client went away mid-line
                log.debug("error response write failed: %r", werr)

    def _bad(self, respond, rid, detail: str) -> None:
        self._count("serve_bad_lines")
        self._write(respond, {"id": rid, "error": "bad_request",
                              "detail": detail})

    def _handle_line_inner(self, line: str,
                           respond: Callable[[str], None]) -> None:
        line = line.strip()
        if not line:
            return
        try:
            req = json.loads(line)
        except ValueError:
            self._bad(respond, None, "unparseable JSON line")
            return
        if not isinstance(req, dict):
            self._bad(respond, None, "expected {'id', 'video_id'}")
            return
        op = req.get("op", "caption")
        if op == "health":
            self._count("serve_health_queries")
            self._write(respond, self.health_payload())
            return
        if op == "stats":
            self._count("serve_stats_queries")
            self._write(respond, {"op": "stats", **self.engine.stats(),
                                  "compiles": _cuda.library_events(),
                                  "library_builds": _cuda.library_builds()})
            return
        if op == "ping":
            # Clock echo: both reads back to back.
            self._count("serve_ping_queries")
            self._write(respond, {"op": "ping", "seq": req.get("seq"),
                                  "t0": req.get("t0"),
                                  "mono": time.monotonic(),
                                  "wall": time.time(), "pid": os.getpid()})
            return
        if op == "dump":
            self._count("serve_dump_queries")
            if self._lifecycle is None:
                self._write(respond, {"op": "dump", "error": "no_recorder",
                                      "detail": "lifecycle tracing is not "
                                                "armed"})
                return
            path = req.get("path") or self.blackbox_path
            if not path:
                self._write(respond, {"op": "dump", "error": "no_path",
                                      "detail": "no blackbox path "
                                                "configured or supplied"})
                return
            doc = self._lifecycle.dump(path, reason="wire_dump")
            self._write(respond, {"op": "dump", "path": str(path),
                                  "events": doc["events_retained"],
                                  "emitted": doc["events_emitted"]})
            return
        rid = req.get("id")
        if op not in ("caption", "stream"):
            self._count("serve_bad_lines")
            self._write(respond, {"id": rid, "error": "unknown_op",
                                  "op": op,
                                  "detail": "expected op 'caption', "
                                            "'stream', 'health', 'stats', "
                                            "'ping' or 'dump'"})
            return
        stream = op == "stream"
        if stream and self.engine.chunk >= self.engine.max_len:
            warn_stream_legacy_scan()
        vid = req.get("video_id")
        if vid is None:
            self._bad(respond, rid, "expected {'id', 'video_id'}")
            return
        deadline_ms = req.get("deadline_ms")
        if deadline_ms is not None:
            try:
                deadline_ms = float(deadline_ms)
                if not deadline_ms >= 0:
                    raise ValueError
            except (TypeError, ValueError):
                self._bad(respond, rid, "deadline_ms must be a number >= 0")
                return
        idem = req.get("idem")
        if idem is not None and not isinstance(idem, str):
            self._bad(respond, rid, "idem must be a string")
            return
        feats = self.feats_for(vid)
        if feats is None:
            self._write(respond, {"id": rid, "error": "unknown_video",
                                  "video_id": vid})
            return
        meta = {"id": rid, "video_id": vid, "respond": respond,
                "stream": stream}
        if idem is not None:
            meta["idem"] = idem
        tr = req.get("trace")
        if isinstance(tr, dict):
            meta["trace"] = tr     # the engine's lifecycle events echo it
        try:
            ok = self.engine.submit((rid, vid),
                                    [np.asarray(f) for f in feats],
                                    meta=meta, deadline_ms=deadline_ms,
                                    stream=stream,
                                    no_cache=bool(req.get("no_cache")))
        except ValueError as e:
            self._bad(respond, rid, str(e))
            return
        if not ok:
            self._write(respond, self._mark_stream_terminal(
                {"id": rid, "error": "shed", "video_id": vid,
                 "queue_depth": self.engine.queue_depth}, stream))
            if self._lifecycle is not None:
                self._lifecycle.emit("responded", (rid, vid), status="shed")

    # -- scheduler loop ----------------------------------------------------

    def _drain_and_exit(self) -> int:
        self._draining = True
        self._published_health = self.health_payload()
        # A second signal during the drain aborts it.  The baseline is
        # read before the announcement, so any signal after it aborts.
        count0 = getattr(self.handler, "signal_count", 0)

        def aborted() -> bool:
            return getattr(self.handler, "signal_count", 0) > count0

        print(f"serve: draining {self.engine.resident_count} resident(s), "
              f"{self.engine.queue_depth} queued; a second signal aborts",
              file=sys.stderr)
        sys.stderr.flush()
        done, rejected = self.engine.drain(abort=aborted)
        self._respond_stream_all()     # chunks before their finals
        for comp in done:
            self._respond_completion(comp)
        self._respond_dropped_all()
        unfinished = self.engine.resident_count
        # Every request gets an answer: an aborted drain's residents are
        # rejected like the queued ones.
        abandoned = self.engine.resident_requests()
        for req, was_resident in ([(r, False) for r in rejected]
                                  + [(r, True) for r in abandoned]):
            meta = req.meta or {}
            self._write(meta.get("respond", self._stdout_respond),
                        self._mark_stream_terminal(
                            {"id": meta.get("id"),
                             "video_id": meta.get("video_id"),
                             "error": "rejected_draining"},
                            meta.get("stream")))
            if self._lifecycle is not None:
                # The engine's drain already dropped the queued ones; the
                # abandoned residents get their terminal here.
                if was_resident:
                    self._lifecycle.emit("dropped", req.request_id,
                                         reason="rejected_draining",
                                         where="drain_abort")
                self._lifecycle.emit("responded", req.request_id,
                                     status="rejected_draining")
        if aborted() and self._lifecycle is not None and self.blackbox_path:
            # What was in flight when the operator said "stop now".
            self._lifecycle.dump(self.blackbox_path, reason="drain_abort")
        if aborted():
            print(f"serve: drain aborted by a second signal with "
                  f"{unfinished} resident(s) unfinished; exiting "
                  f"{EXIT_SIGTERM}", file=sys.stderr)
            return EXIT_SIGTERM
        print(f"serve: drained {len(done)} in-flight, rejected "
              f"{len(rejected)} queued; exiting {EXIT_PREEMPTED}",
              file=sys.stderr)
        return EXIT_PREEMPTED

    def _loop(self) -> int:
        while True:
            if self.watchdog is not None:
                self.watchdog.beat()
            if self.handler is not None and self.handler.requested:
                return self._drain_and_exit()
            moved = False
            while True:
                try:
                    line, respond = self._inbox.get_nowait()
                except queue.Empty:
                    break
                self._handle_line(line, respond)
                moved = True
            comps = self.engine.step()
            # A request's stream lines precede its final response.
            moved = self._respond_stream_all() or moved
            for comp in comps:
                self._respond_completion(comp)
            # cstlint-torch: disable=device-scalar-fetch -- comps is the engine's host list of completions; bool() of a list fetches nothing
            moved = self._respond_dropped_all() or bool(comps) or moved
            self._published_health = self.health_payload()
            if self._eof.is_set() and self.engine.idle \
                    and self._inbox.empty():
                return EXIT_OK
            if not moved and self.engine.idle:
                time.sleep(IDLE_SLEEP_S)

    # -- front ends --------------------------------------------------------

    def run_stdin(self, lines=None) -> int:
        """Serve JSONL requests from ``lines`` (default: sys.stdin) until
        EOF (exit 0) or a preemption signal (drain, exit 75 or 143)."""
        src = lines if lines is not None else sys.stdin

        def read():
            try:
                for line in src:
                    self._inbox.put((line, self._stdout_respond))
            finally:
                self._eof.set()

        threading.Thread(target=read, name="serve-stdin",
                         daemon=True).start()
        return self._loop()

    def run_socket(self, port: int) -> int:
        """Serve the line protocol on 127.0.0.1:``port`` (0: an ephemeral
        port), announced on stderr as ``serve: listening on
        127.0.0.1:<port>``, until a preemption signal drains it (or
        ``_eof`` is set with the engine idle)."""
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", int(port)))
        srv.listen()
        srv.settimeout(0.2)
        self.bound_port = srv.getsockname()[1]
        print(f"serve: listening on 127.0.0.1:{self.bound_port}",
              file=sys.stderr)
        sys.stderr.flush()
        conns: List[socket.socket] = []

        def reader(conn: socket.socket) -> None:
            lock = named_lock("serving.server.conn")

            def respond(line: str) -> None:
                with lock:
                    try:
                        conn.sendall(line.encode() + b"\n")
                    except OSError:
                        pass  # the client went away; its answer is lost

            try:
                with conn.makefile("r", encoding="utf-8",
                                   errors="replace") as f:
                    for line in f:
                        self._inbox.put((line, respond))
            except OSError:
                pass

        def accept() -> None:
            while not self._eof.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                conns.append(conn)
                threading.Thread(target=reader, args=(conn,),
                                 name="serve-conn", daemon=True).start()

        threading.Thread(target=accept, name="serve-accept",
                         daemon=True).start()
        try:
            return self._loop()
        finally:
            self._eof.set()  # stops the accept loop
            for conn in conns:
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                conn.close()
            srv.close()
