"""The optimizer (counterpart of the reference's ``training/state.py``).

The reference builds one optax chain: clip by global norm, then the
optimizer with a staircase learning-rate schedule baked in.  Here that is
``Optimizer``: a ``torch.optim`` optimizer, optax's clip rule applied to
the gradients in place (``g`` unchanged below the threshold ``c``, else
``g / ||g|| * c``; ``clip_grad_norm_`` divides by ``||g|| + 1e-6`` and
would not match), and the learning rate ``lr * rate ** (count //
every)`` set before each update, ``count`` being the updates made so
far, as optax's ``exponential_decay(staircase=True)`` counts them.

``--optim`` takes ``adam`` (beta 0.9 / 0.999, eps 1e-8, as optax's) and
``sgd`` (no momentum).  optax's adamax, adamw, rmsprop and adagrad differ
from torch's defaults (eps inside the square root, the initial
accumulator, the weight-decay default) and are not ported yet.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

OPTIMIZERS = ("adam", "sgd")


class Optimizer:
    """Global-norm clip + optimizer + staircase schedule over ``params``."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 optim: str = "adam", learning_rate: float = 2e-4,
                 grad_clip: float = 0.0, decay_rate: float = 1.0,
                 decay_every_steps: int = 0):
        if optim not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {optim!r}; this port has "
                             f"{OPTIMIZERS}")
        self.params: List[torch.nn.Parameter] = list(params)
        self.base_lr = learning_rate
        self.grad_clip = grad_clip
        self.decay_rate = decay_rate
        self.decay_every_steps = decay_every_steps
        self.count = 0
        if optim == "adam":
            self.opt = torch.optim.Adam(self.params, lr=learning_rate,
                                        betas=(0.9, 0.999), eps=1e-8)
        else:
            self.opt = torch.optim.SGD(self.params, lr=learning_rate)

    def lr(self, count: int) -> float:
        """The learning rate of update number ``count`` (0 = the first)."""
        if self.decay_rate >= 1.0 or self.decay_every_steps <= 0:
            return self.base_lr
        return self.base_lr * self.decay_rate ** (
            count // self.decay_every_steps)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip the gradients, update the parameters, and return the global
        gradient norm taken before the clip (a 0-d tensor on the device;
        nothing here waits for the device)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        clip = self.grad_clip and self.grad_clip > 0
        keep = norm < self.grad_clip
        for p, g in zip(self.params, grads):
            # A parameter without a gradient gets zeros, as optax does
            # (torch's optimizers would skip it).
            p.grad = torch.where(keep, g, g / norm * self.grad_clip) \
                if clip else g
        for group in self.opt.param_groups:
            group["lr"] = self.lr(self.count)
        self.opt.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])
