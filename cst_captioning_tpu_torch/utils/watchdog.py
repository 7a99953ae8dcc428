"""Progress watchdog: a wedged step becomes a fast exit 124 (own copy of
the reference's ``utils/watchdog.py``).

A hung CUDA call, a device that stops answering or a blocked host thread
does not raise: the loop sits in a wait for ever while the card's hours
run on.  A daemon thread watches a monotonic heartbeat that the loop
touches at every progress point; after ``timeout_s`` seconds without a
beat it writes its last word to stderr and ``os._exit``\\ s with
:data:`WEDGE_EXIT_CODE` (124, the coreutils ``timeout`` convention), and
the stage harness resumes from the newest checkpoint.

``os._exit`` (not ``sys.exit``): the main thread is stuck in a call no
Python exception can unwind, and a graceful shutdown would block on the
very thing that hung.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional

from ..resilience.exitcodes import EXIT_WEDGE
from ..resilience.integrity import atomic_json_write

WEDGE_EXIT_CODE = EXIT_WEDGE


class ProgressWatchdog:
    """Daemon-thread heartbeat monitor.

    ``beat()`` is one monotonic read and store, safe from any thread.  A
    ``timeout_s`` of 0 disables the exit; without a heartbeat interval
    every method is then a no-op.

    With ``heartbeat_path`` set, the thread also writes a small JSON file
    at start and once per poll (the gap since the last beat and
    ``payload()``); a positive ``heartbeat_interval_s`` keeps it writing
    at that interval even with the timeout at 0 (the serving health
    plane: liveness without a kill policy).  ``describe`` and ``payload``
    must read host state only: they run while the main thread may be
    stuck inside a device call, and a device read here would hang the
    thread reporting the hang.
    """

    def __init__(self, timeout_s: float,
                 describe: Optional[Callable[[], str]] = None,
                 on_timeout: Optional[Callable[[float], None]] = None,
                 heartbeat_path: Optional[str] = None,
                 payload: Optional[Callable[[], Dict]] = None,
                 heartbeat_interval_s: float = 0.0):
        self.timeout_s = float(timeout_s)
        self._hb_interval = float(heartbeat_interval_s or 0.0)
        self._describe = describe or (lambda: "")
        self._on_timeout = on_timeout or self._die
        self._heartbeat_path = heartbeat_path
        self._payload = payload
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _armed(self) -> bool:
        return self.timeout_s > 0 or (
            self._heartbeat_path is not None and self._hb_interval > 0)

    def _poll_s(self) -> float:
        polls = []
        if self.timeout_s > 0:
            polls.append(max(1.0, min(30.0, self.timeout_s / 4.0)))
        if self._heartbeat_path is not None and self._hb_interval > 0:
            polls.append(max(0.05, self._hb_interval))
        return min(polls)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ProgressWatchdog":
        if self._armed() and self._thread is None:
            self._stop.clear()
            self.beat()
            self._thread = threading.Thread(
                target=self._run, name="progress-watchdog", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
            # The file's last state is the run's end, not the last poll.
            self._write_heartbeat(time.monotonic() - self._last)

    def __enter__(self) -> "ProgressWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- heartbeat ---------------------------------------------------------
    def beat(self) -> None:
        self._last = time.monotonic()

    # -- internals ---------------------------------------------------------
    def _write_heartbeat(self, gap: float) -> None:
        if self._heartbeat_path is None:
            return
        try:
            doc = {"time": time.time(), "pid": os.getpid(),
                   "beat_gap_s": round(gap, 3),
                   "timeout_s": self.timeout_s}
            if self._payload is not None:
                doc.update(self._payload() or {})
            target = os.path.abspath(self._heartbeat_path)
            os.makedirs(os.path.dirname(target), exist_ok=True)
            atomic_json_write(target, doc, default=str)
        except Exception:
            pass  # best-effort: a full disk must not look like a wedge

    def _run(self) -> None:
        poll = self._poll_s()
        self._write_heartbeat(time.monotonic() - self._last)
        while not self._stop.wait(poll):
            gap = time.monotonic() - self._last
            self._write_heartbeat(gap)
            if self.timeout_s > 0 and gap > self.timeout_s:
                self._on_timeout(gap)
                # The default handler never returns (os._exit); an
                # injected one that does wants monitoring to go on from a
                # fresh gap.
                self.beat()

    def _die(self, gap: float) -> None:  # pragma: no cover - exits process
        msg = ("no progress for %.0fs (timeout %.0fs); exiting %d for a "
               "checkpointed resume. %s"
               % (gap, self.timeout_s, WEDGE_EXIT_CODE, self._describe()))
        # Not logging: the wedged main thread may hold the logging lock.
        # A raw non-blocking write, so even a full dead pipe cannot block
        # this thread, then exit unconditionally.
        try:
            import fcntl

            fl = fcntl.fcntl(2, fcntl.F_GETFL)
            fcntl.fcntl(2, fcntl.F_SETFL, fl | os.O_NONBLOCK)
        except Exception:
            pass
        try:
            os.write(2, ("WATCHDOG: " + msg + "\n").encode())
        except Exception:
            pass
        os._exit(WEDGE_EXIT_CODE)
