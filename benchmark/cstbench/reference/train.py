"""The reference's training steps: the losses, their gradients by
autograd, the global-norm clip and Adam, in plain float32 PyTorch with
TF32 off, over the first steps of a cell from the benchmark's weights.

XE: the masked cross-entropy of the batch's captions, summed over
positions up to each caption's EOS and divided by the number of those
positions, with dropout under the program's masks (the reference cannot
draw the program's random numbers; ``check.dropout_z`` judges the masks
apart).  CST (self-critical, greedy baseline): each sampled caption's
CIDEr-D minus its video's greedy caption's is its advantage, and the loss
is ``-sum(advantage * log p(sampled token))`` over the same positions,
divided the same way, without dropout; the sampled and greedy captions
are the program's, scored here, and each sampled token is held against
the reference's Gumbel-max choice under the program's noise
(``sample_gap``; ``check.noise_z`` judges the noise apart).

Adam as optax's chain: the gradients clipped to a global norm of
``grad_clip`` (unchanged below it, scaled to it above), then b1 0.9, b2
0.999, eps 1e-8 outside the square root, bias-corrected moments, the
update ``-lr * m_hat / (sqrt(v_hat) + eps)``.

Rows go through the model in blocks of videos, with the gradients summed
over the blocks, so the reference fits beside nothing at any batch.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

from . import models
from .ciderd import CiderD

B1, B2, EPS = 0.9, 0.999, 1e-8


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def loss_and_grads(P: Dict[str, torch.Tensor], feats: Sequence[torch.Tensor],
                   targets: torch.Tensor, seq_per_img: int,
                   advantage: Optional[torch.Tensor], block_videos: int,
                   drops=None, noise=None, temperature: float = 1.0):
    """-> (loss, {name: gradient}, sample gap) of the XE loss
    (``advantage`` None) or the REINFORCE loss over ``targets`` (B*S, L).
    ``drops(v0, v1)`` gives the dropout masks of videos v0:v1, or None;
    ``noise``, per decode step the (B*S, V) noise the program sampled
    ``targets`` with, gives the sample gap (else None)."""
    total = models.caption_mask(targets).sum()
    names = list(P)
    grads = {n: torch.zeros_like(P[n]) for n in names}
    loss = torch.zeros((), device=targets.device)
    gap = None
    b = feats[0].shape[0]
    for v0 in range(0, b, block_videos):
        v1 = min(v0 + block_videos, b)
        rows = slice(v0 * seq_per_img, v1 * seq_per_img)
        tok = targets[rows]
        lg = models.logits(P, [f[v0:v1] for f in feats], tok, seq_per_img,
                           None if drops is None else drops(v0, v1))
        logp = torch.log_softmax(lg, -1).gather(-1, tok[..., None])[..., 0]
        weight = models.caption_mask(tok)
        if noise is not None:
            g = torch.stack([n[rows] for n in noise], 1).to(lg.device)
            part_gap = sample_gap(lg.detach(), tok, g, temperature)
            gap = part_gap if gap is None else max(gap, part_gap)
        if advantage is not None:
            weight = weight * advantage[rows, None]
        part = -(logp * weight).sum() / total
        got = torch.autograd.grad(part, [P[n] for n in names],
                                  allow_unused=True)
        for n, g in zip(names, got):
            if g is not None:
                grads[n] += g
        loss += part.detach()
    return loss, grads, gap


def sample_gap(lg: torch.Tensor, tokens: torch.Tensor, noise: torch.Tensor,
               temperature: float) -> float:
    """The widest gap by which a sampled token's ``logit / temperature +
    noise`` lies below the best at its position (positions up to the
    first EOS): 0 where the reference's Gumbel-max draw under the same
    noise picks the program's token."""
    z = lg / max(temperature, 1e-6) + noise
    chosen = z.gather(-1, tokens[..., None])[..., 0]
    gap = (z.max(-1).values - chosen) * models.caption_mask(tokens)
    return float(gap.max())


def clip_and_adam(P, grads, state, count: int, lr: float, clip: float):
    """One update in place; -> the clipped gradients."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = 1.0 if norm < clip else float(clip / norm)
    clipped = {n: g * scale for n, g in grads.items()}
    bc1, bc2 = 1 - B1 ** count, 1 - B2 ** count
    with torch.no_grad():
        for n, g in clipped.items():
            mu, nu = state.setdefault(n, (torch.zeros_like(g),
                                          torch.zeros_like(g)))
            mu = (1 - B1) * g + B1 * mu
            nu = (1 - B2) * g * g + B2 * nu
            state[n] = (mu, nu)
            P[n] -= lr * (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
    return clipped


def greedy_gap(P, feats, greedy: torch.Tensor) -> float:
    """The widest gap by which a greedy token's logit lies below the
    reference's best at its position (positions up to the first EOS),
    teacher-forcing the program's greedy captions."""
    with torch.no_grad():
        lg = models.logits(P, feats, greedy, 1)
        chosen = lg.gather(-1, greedy[..., None])[..., 0]
        gap = (lg.max(-1).values - chosen) * models.caption_mask(greedy)
    return float(gap.max())


def run(weights: Dict[str, torch.Tensor], config: dict, traffic: dict,
        split, batches: List, rollouts: List, device: torch.device,
        masks: Optional[List] = None, noise: Optional[List] = None,
        block_videos: int = 16) -> dict:
    """The reference's readings over the program's first steps:
    ``batches`` (the loader's draws: ``video_ix`` and ``labels``); for XE
    with dropout, ``masks`` (per step the program's masks in draw order,
    or None where they are not the model's sites, which then go
    undropped); for CST, ``rollouts`` (the program's (sampled, greedy)
    tokens) and ``noise`` (per rollout the sampled rows' noise).
    -> {"loss": [...], "grad": {name: norm}, "change": {name: norm},
    and for CST "reward", "baseline", "greedy_gap", "sample_gap": [...]}."""
    opts = traffic["options"]
    lr, clip = float(opts["learning_rate"]), float(opts["grad_clip"])
    spi = int(config["captions_per_video"])
    cst = bool(int(opts.get("use_rl", 0)))
    p = float(opts.get("drop_prob", 0.0))
    P = {n: w.detach().clone().to(device).requires_grad_()
         for n, w in weights.items()}
    P0 = {n: w.detach().clone() for n, w in P.items()}
    scorer = CiderD(split.labels.tolist()) if cst else None
    out: Dict[str, list] = {"loss": [], "reward": [], "baseline": [],
                            "greedy_gap": [], "sample_gap": []}
    state: dict = {}
    with no_tf32():
        for k, batch in enumerate(batches):
            vix = torch.as_tensor(batch.video_ix).long()
            feats = [torch.from_numpy(f[batch.video_ix]).to(device)
                     for f in split.feats]
            adv = drops = step_noise = None
            if cst:
                sampled, greedy = (t.to(device) for t in rollouts[k])
                videos = vix.repeat_interleave(spi).tolist()
                r_s = torch.tensor([scorer.score(row, v) for row, v in
                                    zip(sampled.tolist(), videos)],
                                   dtype=torch.float64)
                r_g = torch.tensor([scorer.score(row, v) for row, v in
                                    zip(greedy.tolist(), vix.tolist())],
                                   dtype=torch.float64)
                r_b = r_g.repeat_interleave(spi)
                out["reward"].append(float(r_s.mean()))
                out["baseline"].append(float(r_b.mean()))
                out["greedy_gap"].append(greedy_gap(P, feats, greedy))
                adv = (r_s - r_b).float().to(device)
                targets = sampled
                step_noise = noise[k]
            else:
                targets = torch.from_numpy(batch.labels).long().to(device)
                if p > 0 and masks is not None and masks[k] is not None:
                    drops = _block_drops(masks[k], p, spi, device)
            loss, grads, gap = loss_and_grads(
                P, feats, targets, spi, adv, block_videos, drops, step_noise,
                float(opts.get("temperature", 1.0)))
            if gap is not None:
                out["sample_gap"].append(gap)
            out["loss"].append(float(loss))
            clipped = clip_and_adam(P, grads, state, k + 1, lr, clip)
            if k == 0:
                out["grad"] = {n: float(g.double().norm())
                               for n, g in clipped.items()}
    out["change"] = {n: float((P[n].detach().double() - P0[n].double()).norm())
                     for n in P}
    return out


def _block_drops(masks: List[torch.Tensor], p: float, spi: int,
                 device: torch.device):
    """One step's masks in the model's draw order (pooled, memory, then
    one a decode step) -> ``drops(v0, v1)``, those of videos v0:v1."""
    def drops(v0: int, v1: int) -> models.Drops:
        rows = slice(v0 * spi, v1 * spi)
        return models.Drops(p, masks[0][v0:v1].to(device),
                            masks[1][v0:v1].to(device),
                            [m[rows].to(device) for m in masks[2:]])
    return drops
