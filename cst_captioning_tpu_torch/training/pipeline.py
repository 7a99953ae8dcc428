"""The overlapped CST reward pipeline of the host-reward path (own copy of
the reference's ``training/pipeline.py``).

Under ``--device_rewards 0`` the CST iteration is rollout -> host CIDEr-D
advantage -> gradient step.  Run serially, the device idles through the
host work.  ``RewardPipeline`` keeps up to ``depth`` rollouts in flight:
the reward of step t is computed while the device already runs rollouts
t+1..t+depth.

Semantics: depth 0 is the reference's strictly serial loop; depth k >= 1
grades each sample under parameters up to k updates newer than the ones
that drew it (stale-sample REINFORCE).  ``drain()`` completes every
in-flight step, so validation and checkpoints see fully updated
parameters; ``abort()`` drops them unapplied (a divergence rollback).

Each rollout's host-bound rows (``cat([sampled, greedy])`` under the
greedy baseline, the samples alone otherwise) start a non-blocking copy
into pinned host memory when the rollout is dispatched, with an event
behind it; completing the step waits on that event only.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


class HostCopy:
    """A tensor on its way to the host: on CUDA a non-blocking copy into
    pinned memory with an event recorded behind it, started when this is
    made; on the CPU the tensor itself.  ``wait()`` waits for that event
    only, never for the whole device."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class RewardPipeline:
    """k-deep rollout -> host advantage -> gradient-step pipeline.

    Args:
      rollout_fn: ``(feats, ctx) -> (sampled (N, L), greedy (B, L) or
        None, steps)`` (``steps.rollout``): ``sampled`` stays on the
        device for the gradient step.
      rl_step_fn: ``(feats, sampled, advantage (N,) numpy, ctx) ->
        metrics`` (``steps.rl_grad_step``).
      advantage_fn: host callback ``(ctx, sampled_rows, greedy_rows or
        None) -> (advantage (N,), stats)``: the ``RewardComputer`` call;
        ``ctx`` is the caller's per-batch payload (step index, video ids).
      depth: rollouts kept in flight (``--overlap_rewards``); 0 = serial.
    """

    def __init__(self, rollout_fn: Callable, rl_step_fn: Callable,
                 advantage_fn: Callable, depth: int):
        self.rollout_fn = rollout_fn
        self.rl_step_fn = rl_step_fn
        self.advantage_fn = advantage_fn
        self.depth = max(0, int(depth))
        self._pending: List[Tuple] = []

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, feats, ctx: Any) -> List[Tuple[Any, Dict[str, Any]]]:
        """Dispatch one rollout; complete the oldest step once more than
        ``depth`` are in flight.  -> the steps completed by this call as
        ``(ctx, metrics)`` pairs: empty while the pipeline fills, one at
        steady state.  Metrics carry ``fetch_wait_s`` and ``reward_s``
        (host seconds) and ``overlap_inflight``."""
        sampled, greedy, _ = self.rollout_fn(feats, ctx)
        rows = sampled if greedy is None else torch.cat([sampled, greedy])
        self._pending.append((sampled, HostCopy(rows), feats, ctx))
        if len(self._pending) > self.depth:
            return [self._complete_one()]
        return []

    def _complete_one(self) -> Tuple[Any, Dict[str, Any]]:
        sampled, fetch, feats, ctx = self._pending.pop(0)
        inflight = len(self._pending)   # rollouts still covering this wait
        t0 = time.perf_counter()
        fetched = fetch.wait()
        t1 = time.perf_counter()
        n = sampled.shape[0]
        greedy_rows: Optional[np.ndarray] = (
            fetched[n:] if fetched.shape[0] > n else None)
        advantage, stats = self.advantage_fn(ctx, fetched[:n], greedy_rows)
        t2 = time.perf_counter()
        metrics = dict(self.rl_step_fn(feats, sampled, advantage, ctx))
        metrics.update(stats)
        metrics.update({"overlap_inflight": float(inflight),
                        "fetch_wait_s": t1 - t0, "reward_s": t2 - t1})
        return ctx, metrics

    def drain(self) -> List[Tuple[Any, Dict[str, Any]]]:
        """Complete every in-flight step (epoch boundary, checkpoint,
        end)."""
        completed = []
        while self._pending:
            completed.append(self._complete_one())
        return completed

    def abort(self) -> int:
        """Drop every in-flight rollout WITHOUT its gradient step; ->
        how many were dropped.  Used by the divergence rollback: pending
        rollouts were drawn from the diverged parameters."""
        dropped = len(self._pending)
        self._pending.clear()
        return dropped
