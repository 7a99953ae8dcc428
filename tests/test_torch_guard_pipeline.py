"""The port's divergence guard (``resilience/guard.py``) and host-reward
pipeline (``training/pipeline.py``) against the reference's.

The guard: the same scripted stream of ``bad_step`` flags through both
guards gives the same decision after every call (``poll``, ``flush``,
``note_rollback``), the same counters and the same
``DivergenceUnrecoverable``.  The pipeline: fake step functions on both
sides at depths 0, 1 and 2 (with greedy rows and without) give the same
completions per push, the same rows handed to the reward, the same
gradient-step order and advantages, and the same ``overlap_inflight``.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.resilience import guard as jguard
from cst_captioning_tpu.training import pipeline as jpipeline
from cst_captioning_tpu_torch.resilience import guard
from cst_captioning_tpu_torch.training import pipeline

# (action, argument): observe a flag, poll, flush, or roll back when the
# previous decision asked for it.
SCRIPT = [("observe", 0), ("poll", None), ("observe", 1), ("poll", None),
          ("observe", 1), ("poll", None), ("observe", 0), ("poll", None),
          ("observe", 1), ("observe", 1), ("poll", None), ("observe", 1),
          ("poll", None), ("flush", None), ("observe", 1), ("observe", 1),
          ("observe", 1), ("observe", 1), ("poll", None), ("flush", None),
          ("observe", 0), ("observe", 1), ("observe", 1), ("observe", 1),
          ("flush", None), ("observe", 1), ("observe", 1), ("observe", 1),
          ("flush", None)]


def _drive(module, make_flag, lag):
    g = module.DivergenceGuard(max_bad=2, max_rollbacks=2, lag=lag)
    trace, step, wants_rollback = [], 0, False
    for action, arg in SCRIPT:
        try:
            if wants_rollback:
                g.note_rollback()
                wants_rollback = False
                trace.append(("rollback", g.rollbacks))
            if action == "observe":
                g.observe(step, make_flag(float(arg)))
                step += 1
                continue
            wants_rollback = g.poll() if action == "poll" else g.flush()
        except module.DivergenceUnrecoverable:
            trace.append(("unrecoverable", g.rollbacks))
            break
        trace.append((action, wants_rollback, g.consecutive, g.total_skipped,
                      g.last_bad_step))
    return trace


@pytest.mark.parametrize("lag", [0, 1, 2])
def test_guard_decisions_match_reference(lag):
    want = _drive(jguard, jnp.asarray, lag)
    got = _drive(guard, torch.tensor, lag)
    assert got == want
    assert ("unrecoverable", 3) in got


def test_guard_ignores_unguarded_steps():
    g = guard.DivergenceGuard(max_bad=1)
    g.observe(0, None)
    assert g.flush() is False and g.total_skipped == 0


class _Log:
    def __init__(self):
        self.rewards, self.steps = [], []


def _fake_rows(k, n, greedy):
    sampled = np.full((n, 3), k, np.int64) + np.arange(n)[:, None]
    g = np.full((2, 3), 100 + k, np.int64) if greedy else None
    return sampled, g


def _reference_run(depth, greedy, n, pushes, abort_at):
    log = _Log()

    def rollout(params, feats, rng):
        s, g = _fake_rows(feats, n, greedy)
        fetch = s if g is None else np.concatenate([s, g])
        return jnp.asarray(s), jnp.asarray(fetch)

    def rl_step(state, feats, sampled, adv, rng):
        log.steps.append((feats, np.asarray(adv).tolist()))
        return SimpleNamespace(params=None, n=state.n + 1), \
            {"loss": float(feats)}

    def advantage(ctx, s, g):
        log.rewards.append((ctx, np.asarray(s).tolist(),
                            None if g is None else np.asarray(g).tolist()))
        return s[:, 0].astype(np.float32) - ctx, {"reward": float(ctx)}

    pipe = jpipeline.RewardPipeline(rollout, rl_step, advantage, depth)
    state, done = SimpleNamespace(params=None, n=0), []
    for k in range(pushes):
        if k == abort_at:
            done.append(("abort", pipe.abort()))
        state, out = pipe.push(state, k, None, None, k)
        done.append([(c, m["loss"], m["reward"], m["overlap_inflight"])
                     for c, m in out])
    state, out = pipe.drain(state)
    done.append([(c, m["loss"], m["reward"], m["overlap_inflight"])
                 for c, m in out])
    return done, log.rewards, log.steps, state.n


def _port_run(depth, greedy, n, pushes, abort_at):
    log = _Log()

    def rollout(feats, ctx):
        s, g = _fake_rows(feats, n, greedy)
        return (torch.from_numpy(s), None if g is None
                else torch.from_numpy(g), 3)

    def rl_step(feats, sampled, adv, ctx):
        log.steps.append((feats, np.asarray(adv).tolist()))
        return {"loss": float(feats)}

    def advantage(ctx, s, g):
        log.rewards.append((ctx, np.asarray(s).tolist(),
                            None if g is None else np.asarray(g).tolist()))
        return s[:, 0].astype(np.float32) - ctx, {"reward": float(ctx)}

    pipe = pipeline.RewardPipeline(rollout, rl_step, advantage, depth)
    done = []
    for k in range(pushes):
        if k == abort_at:
            done.append(("abort", pipe.abort()))
        out = pipe.push(k, k)
        done.append([(c, m["loss"], m["reward"], m["overlap_inflight"])
                     for c, m in out])
        assert all(m["fetch_wait_s"] >= 0 and m["reward_s"] >= 0
                   for _, m in out)
    done.append([(c, m["loss"], m["reward"], m["overlap_inflight"])
                 for c, m in pipe.drain()])
    return done, log.rewards, log.steps, len(log.steps)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "scb"])
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_pipeline_matches_reference(depth, greedy):
    want = _reference_run(depth, greedy, n=4, pushes=7, abort_at=4)
    got = _port_run(depth, greedy, n=4, pushes=7, abort_at=4)
    assert got == want
    # depth k: the first completion comes with push k (0-based); the
    # abort drops what was in flight
    assert got[0][0] == ([] if depth else [(0, 0.0, 0.0, 0.0)])
