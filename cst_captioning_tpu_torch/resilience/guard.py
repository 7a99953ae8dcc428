"""Host half of the divergence guard: lagged bad-step accounting and
rollback (own copy of the reference's ``resilience/guard.py``).

The device half lives in ``training/steps.py``: a guarded step checks
``isfinite(loss) & isfinite(grad_norm)`` on the device, keeps the
parameters and optimizer state when the check fails, and reports a 0-d
``bad_step`` tensor (0.0 or 1.0).  The skip decision never leaves the
device.

This class reads those ``bad_step`` tensors without stalling the
dispatch loop: ``observe`` starts a non-blocking device-to-host copy into
pinned memory and records an event behind it; ``poll`` only reaps
entries at least ``lag`` steps old, whose steps have long completed, so
the read is a reap, not a wait.  After ``max_bad`` CONSECUTIVE bad steps
it asks the trainer to roll back to the last known-good state;
``max_rollbacks`` bounds how often that can happen before the run is
declared unrecoverable (a deterministic divergence would otherwise replay
forever).  The reference's telemetry counters are left out: the port has
no metrics registry; ``total_skipped`` and ``rollbacks`` carry the same
counts.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Deque, Optional, Tuple

import torch

from ..training.pipeline import HostCopy

log = logging.getLogger(__name__)


class DivergenceUnrecoverable(RuntimeError):
    """Raised when divergence persists past the rollback budget."""


class DivergenceGuard:
    """Counts consecutive non-finite steps; decides skip vs rollback."""

    def __init__(self, max_bad: int = 3, max_rollbacks: int = 2,
                 lag: int = 1):
        self.max_bad = max(1, int(max_bad))
        self.max_rollbacks = max(0, int(max_rollbacks))
        self.lag = max(0, int(lag))
        self._queue: Deque[Tuple[int, HostCopy]] = deque()
        self.consecutive = 0
        self.total_skipped = 0
        self.rollbacks = 0
        self.last_bad_step: Optional[int] = None

    # -- ingestion ---------------------------------------------------------

    def observe(self, step_ix: int, bad_step: Optional[torch.Tensor]
                ) -> None:
        """Queue one step's ``bad_step`` tensor (None when the step ran
        unguarded) and start its copy to the host."""
        if bad_step is None:
            return
        self._queue.append((int(step_ix), HostCopy(bad_step)))

    def _reap_one(self) -> None:
        step_ix, pending = self._queue.popleft()
        if float(pending.wait()) > 0.0:
            self.consecutive += 1
            self.total_skipped += 1
            self.last_bad_step = step_ix
            log.warning(
                "divergence guard: non-finite loss/grad at step %d; update "
                "skipped on the device (%d consecutive, %d total)",
                step_ix + 1, self.consecutive, self.total_skipped)
        else:
            self.consecutive = 0

    # -- decisions ---------------------------------------------------------

    def poll(self) -> bool:
        """Reap every entry older than ``lag`` steps; True when the
        consecutive-bad threshold is crossed (the trainer rolls back)."""
        while len(self._queue) > self.lag:
            self._reap_one()
        return self.consecutive >= self.max_bad

    def flush(self) -> bool:
        """Reap everything (epoch boundary, end of run)."""
        while self._queue:
            self._reap_one()
        return self.consecutive >= self.max_bad

    def note_rollback(self) -> None:
        """Record one rollback; raise once the budget is spent."""
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            raise DivergenceUnrecoverable(
                f"training diverged again after {self.max_rollbacks} "
                "rollback(s) to known-good states: a deterministic "
                "divergence (bad data, runaway lr) that replaying cannot "
                "fix; fix the config instead of rolling back forever")
        self.reset()

    def reset(self) -> None:
        """Clear the consecutive counter and any queued observations (the
        steps they belong to were discarded by a rollback)."""
        self.consecutive = 0
        self._queue.clear()
