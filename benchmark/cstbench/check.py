"""The comparison that decides ``correct``: the program's first steps
against the reference's, each number beside its limit from the cell's
file (``benchmark/workloads/<cell>.json``).

The numbers (each the worst over the compared steps or leaves, but
``change_median``):

- ``batch``: caption rows of the program's batches that are not one of
  their video's captions, or steps that repeat a video (exact: 0);
- ``loss``: the gap between the program's and the reference's loss at
  each step, over the reference's;
- ``grad``: per leaf, the gap between the norms of the first gradient as
  the optimizer got it (read from Adam's first moment after one step)
  and the reference's, over the larger of the reference's norm of that
  leaf and of the median leaf;
- ``change`` and ``change_median``: the worst and the median leaf's same
  gap of each leaf's change over the steps, leaving out leaves whose
  reference gradient is under a thousandth of the median leaf's (they
  move under Adam by round-off alone).  The worst leaf catches a fault in
  a few leaves; the median one a small fault in all of them, under the
  round-off of the one element whose first moment nearly cancels, which
  can set the worst leaf's gap;
- XE with dropout: ``dropout_z``, the largest deviation of a mask's kept
  share from ``1 - p``, in standard errors of that share, over every mask
  the program drew at the model's sites (the reference applies the
  program's masks, so it judges their draw here; a step whose masks are
  not one a site reads 1e9);
- CST: ``greedy_gap``, the widest gap by which a greedy token's logit lies
  below the reference's best; ``sample_gap``, the same of a sampled
  token's logit plus its noise (the Gumbel-max draw under the program's
  noise); ``noise_z``, the largest deviation of the sampled rows' noise
  from the Gumbel law (its mean from Euler's constant, its variance from
  pi^2 / 6, in standard errors), per rollout; ``reward`` and
  ``baseline``, the gaps in CIDEr-D (x10) between the program's mean
  sampled and greedy rewards and the reference's scores of the same
  captions (absolute: from seeded weights the mean is near 0, and on some
  seeds every greedy caption scores 0).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

B1 = 0.9
#: Leaves whose reference gradient is under this share of the median
#: leaf's are left out of ``change``.
STILL = 1e-3
#: A mask set that is not the model's sites reads this in ``dropout_z``.
MISSING = 1e9
EULER = 0.5772156649015329
GUMBEL_VAR = math.pi ** 2 / 6
#: The Gumbel law's fourth central moment over its variance squared.
GUMBEL_KURTOSIS = 5.4


def _rel(p: float, r: float) -> float:
    if p == r:
        return 0.0
    return abs(p - r) / max(abs(r), 1e-30)


def _norm(t) -> float:
    """A tensor's norm summed in float64 (a float32 sum over millions of
    elements on the host drifts by a part in a thousand)."""
    return float(t.double().norm())


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               leaves: List[str]) -> List[float]:
    med = statistics.median(ref[n] for n in ref)
    return [abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves]


def batch_faults(batches, labels: np.ndarray, seq_per_img: int) -> int:
    """Rows not among their video's captions, plus videos drawn twice."""
    bad = 0
    seen: set = set()
    for batch in batches:
        for i, row in enumerate(batch.labels):
            v = int(batch.video_ix[i // seq_per_img])
            if not (labels[v] == row[None, :]).all(axis=1).any():
                bad += 1
        vids = set(int(v) for v in batch.video_ix)
        bad += len(vids & seen) + len(batch.video_ix) - len(vids)
        seen |= vids
    return bad


def dropout_sites(masks: Sequence[torch.Tensor],
                  shapes: Sequence[Tuple[int, ...]]
                  ) -> Optional[List[torch.Tensor]]:
    """One step's masks if they are, in draw order, of the model's sites'
    ``shapes`` (pooled, memory, one a decode step), else None."""
    if [tuple(m.shape) for m in masks] != [tuple(s) for s in shapes]:
        return None
    return list(masks)


def dropout_z(steps: Sequence[Optional[List[torch.Tensor]]],
              p: float) -> float:
    """The largest ``|kept share - (1 - p)|`` of a mask, in standard
    errors; a step without its masks reads ``MISSING``."""
    worst = 0.0
    for masks in steps:
        if masks is None:
            return MISSING
        for m in masks:
            n = m.numel()
            share = float(m.double().mean())
            worst = max(worst, abs(share - (1 - p))
                        / math.sqrt(p * (1 - p) / n))
    return worst


def noise_z(rollouts: Sequence[Sequence[torch.Tensor]]) -> float:
    """The largest deviation, in standard errors, of a rollout's noise
    from the Gumbel law: its mean from Euler's constant and its variance
    from pi^2 / 6 (summed in float64, a decode step at a time)."""
    worst = 0.0
    for drawn in rollouts:
        n, s1, s2 = 0, 0.0, 0.0
        for g in drawn:
            g = g.double()
            n += g.numel()
            s1 += float(g.sum())
            s2 += float((g * g).sum())
        if not n:
            return MISSING
        mean = s1 / n
        var = s2 / n - mean * mean
        z_mean = abs(mean - EULER) / math.sqrt(GUMBEL_VAR / n)
        z_var = abs(var - GUMBEL_VAR) / (
            GUMBEL_VAR * math.sqrt((GUMBEL_KURTOSIS - 1) / n))
        worst = max(worst, z_mean, z_var)
    return worst


def numbers(program: dict, reference: dict) -> Dict[str, float]:
    """``program``: {"batch", "loss": [...], "mu1": {name: tensor},
    "params0"/"params3": {name: tensor}, for XE with dropout "dropout_z",
    and for CST "reward", "baseline": [...] and "noise_z"};
    ``reference``: ``reference.train.run``'s."""
    grad_p = {n: _norm(m) / (1 - B1) for n, m in program["mu1"].items()}
    change_p = {n: _norm(program["params3"][n].double()
                         - program["params0"][n].double())
                for n in program["params0"]}
    g_ref = reference["grad"]
    med = statistics.median(g_ref.values())
    moving = [n for n in g_ref if g_ref[n] >= STILL * med]
    change = _leaf_gaps(change_p, reference["change"], moving)
    out = {"batch": float(program["batch"]),
           "loss": max(_rel(p, r) for p, r in zip(program["loss"],
                                                   reference["loss"])),
           "grad": max(_leaf_gaps(grad_p, g_ref, list(g_ref))),
           "change": max(change),
           "change_median": statistics.median(change)}
    if "dropout_z" in program:
        out["dropout_z"] = program["dropout_z"]
    if reference["reward"]:
        out["greedy_gap"] = max(reference["greedy_gap"])
        out["sample_gap"] = max(reference["sample_gap"])
        out["noise_z"] = program["noise_z"]
        out["reward"] = max(abs(p - r) for p, r in zip(
            program["reward"], reference["reward"]))
        out["baseline"] = max(abs(p - r) for p, r in zip(
            program["baseline"], reference["baseline"]))
    return out


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a number without a limit, or
    a limit without its number, fails)."""
    return set(nums) == set(limits) and all(
        nums[k] <= limits[k] for k in limits)
