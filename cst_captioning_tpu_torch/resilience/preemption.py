"""Signal-driven checkpoint-and-exit (own copy of the reference's
``resilience/preemption.py``).

- :class:`PreemptionHandler` (installed by ``train.py`` before the
  ``Trainer`` is built) catches SIGTERM and SIGINT and only sets a flag:
  the handler takes no lock, logs nothing and allocates little, since it
  may interrupt a thread that holds the logging or registry lock;
- the trainer reads the flag at every step boundary, forces a verified
  checkpoint save, counts it and raises :class:`PreemptedExit`;
- ``train.py`` maps :class:`PreemptedExit` to exit 75
  (``exitcodes.EXIT_PREEMPTED``).

The first Ctrl-C asks for the same graceful exit and hands SIGINT back to
its previous disposition, so a second Ctrl-C is a hard
``KeyboardInterrupt``.  Repeated SIGTERMs are counted and absorbed: the
hard stop of a scheduler is its SIGKILL.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, Optional


class PreemptedExit(RuntimeError):
    """Raised by the trainer at the step boundary that honors a preemption
    signal; ``train.py`` maps it to ``exitcodes.EXIT_PREEMPTED``."""

    def __init__(self, step: int, signal_name: str, saved: bool):
        super().__init__(
            f"preempted by {signal_name} at step {step} "
            f"({'checkpoint saved' if saved else 'checkpoint already current'})")
        self.step = int(step)
        self.signal_name = signal_name
        self.saved = bool(saved)


class PreemptionHandler:
    """SIGTERM/SIGINT -> checkpoint-requested flag (main-thread install).

    ``requested`` is the only thing hot paths read (one attribute load per
    step boundary).  Signal counts accumulate handler-side and are drained
    into the metrics registry by the trainer at safe points
    (``drain_signal_count``) — never from the handler itself, which may be
    interrupting a thread that holds the registry lock.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        # A plain bool, NOT a threading.Event: Event.set() takes the
        # event's non-reentrant lock, and a second SIGTERM landing while
        # the first handler sits inside set() would deadlock the main
        # thread on a lock it already holds.
        self._requested = False
        self.signal_name: Optional[str] = None
        self.signal_monotonic: Optional[float] = None
        self.signal_count = 0
        self._drained = 0
        self._prev: Dict[int, object] = {}

    # -- lifecycle ---------------------------------------------------------

    def install(self) -> "PreemptionHandler":
        """Install the handlers; safe no-op (logged to stderr) off the main
        thread, where CPython forbids ``signal.signal``."""
        if threading.current_thread() is not threading.main_thread():
            os.write(2, b"preemption handler not installed: "
                        b"not on the main thread\n")
            return self
        for sig in self.SIGNALS:
            self._prev[sig] = signal.signal(sig, self._handle)
        return self

    def uninstall(self) -> None:
        """Restore the previous dispositions (idempotent)."""
        prev, self._prev = self._prev, {}
        for sig, handler in prev.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError, TypeError):
                pass

    # -- state -------------------------------------------------------------

    @property
    def requested(self) -> bool:
        return self._requested

    def drain_signal_count(self) -> int:
        """Signals received since the last drain (for registry counters)."""
        n = self.signal_count - self._drained
        self._drained += n
        return n

    # -- the handler (async-signal context: flag + bookkeeping only) -------

    def _handle(self, signum, frame) -> None:
        self.signal_count += 1
        if not self._requested:
            self.signal_name = signal.Signals(signum).name
            self.signal_monotonic = time.monotonic()
            self._requested = True
        if signum == signal.SIGINT:
            # Second Ctrl-C must be a hard stop: hand SIGINT back to the
            # previous disposition (normally KeyboardInterrupt).
            try:
                signal.signal(
                    signal.SIGINT,
                    self._prev.get(signal.SIGINT, signal.default_int_handler))
            except (ValueError, OSError, TypeError):
                pass
        # Raw fd write, not logging: the interrupted thread may hold the
        # logging lock.
        try:
            os.write(2, (f"PREEMPT: {self.signal_name or signum} received; "
                         "will checkpoint and exit at the next step "
                         "boundary\n").encode())
        except OSError:
            pass
