"""The optimizer (counterpart of the reference's ``training/state.py``).

The reference builds one optax chain: clip by global norm, then the
optimizer with a staircase learning-rate schedule baked in.  ``Optimizer``
is that chain over tensors it owns, with optax's update rules (not
``torch.optim``'s, whose defaults differ):

- the clip: ``g`` unchanged below the threshold ``c``, else
  ``g / ||g|| * c`` (``clip_grad_norm_`` divides by ``||g|| + 1e-6``);
- the schedule: ``lr * rate ** floor(count / every)``, ``count`` being
  the updates made so far (``exponential_decay(staircase=True)``);
- ``--optim``: ``adam`` and ``adamw`` (b1 0.9, b2 0.999, eps 1e-8 outside
  the square root; adamw adds optax's weight decay 1e-4 times the
  parameter before the rate), ``adamax`` (the infinity moment
  ``max(|g| + eps, b2 * nu)``, eps inside the max), ``rmsprop`` (decay
  0.9, ``g / sqrt(nu + 1e-8)``), ``adagrad`` (accumulator starting at
  0.1, ``g / sqrt(acc + 1e-7)``), ``sgd`` (no momentum).

The update count and the learning rate are tensors on the device, and
``step(ok=...)`` selects, by one device flag, the new or the old value of
every parameter, every state tensor and the count: the divergence guard's
masked update, with no host sync.  On a good step the selection takes the
new values exactly, so a guarded and an unguarded trajectory are bit for
bit the same.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch

OPTIMIZERS = ("adam", "adamax", "adamw", "rmsprop", "sgd", "adagrad")

B1, B2, EPS = 0.9, 0.999, 1e-8
ADAMW_DECAY = 1e-4
RMSPROP_DECAY, RMSPROP_EPS = 0.9, 1e-8
ADAGRAD_INIT, ADAGRAD_EPS = 0.1, 1e-7

#: State tensors each optimizer keeps per parameter.
_STATE = {"adam": ("mu", "nu"), "adamw": ("mu", "nu"),
          "adamax": ("mu", "nu"), "rmsprop": ("nu",), "sgd": (),
          "adagrad": ("sum_of_squares",)}


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """``1 - decay ** count``: a moment is divided by it (optax's
    ``bias_correction``), once per step for every parameter."""
    return 1 - torch.pow(torch.full_like(count, decay), count)


class Optimizer:
    """Global-norm clip + optimizer + staircase schedule over ``params``."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 optim: str = "adam", learning_rate: float = 2e-4,
                 grad_clip: float = 0.0, decay_rate: float = 1.0,
                 decay_every_steps: int = 0):
        if optim not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {optim!r}; choose from "
                             f"{OPTIMIZERS}")
        self.params: List[torch.nn.Parameter] = list(params)
        self.optim = optim
        self.base_lr = learning_rate
        self.grad_clip = grad_clip
        self.decay_rate = decay_rate
        self.decay_every_steps = decay_every_steps
        dev = self.params[0].device
        #: Updates made so far (float32 on the device: exact to 2**24).
        self.count = torch.zeros((), dtype=torch.float32, device=dev)
        init = ADAGRAD_INIT if optim == "adagrad" else 0.0
        self.state: List[Dict[str, torch.Tensor]] = [
            {name: torch.full_like(p, init, memory_format=torch.
                                   contiguous_format)
             for name in _STATE[optim]} for p in self.params]

    def lr(self, count: torch.Tensor) -> torch.Tensor:
        """The learning rate of update number ``count`` (0 = the first),
        a float32 tensor on the count's device."""
        base = torch.full_like(count, self.base_lr)
        if self.decay_rate >= 1.0 or self.decay_every_steps <= 0:
            return base
        p = torch.floor(count / self.decay_every_steps)
        return base * torch.pow(torch.full_like(count, self.decay_rate), p)

    def current_lr(self) -> float:
        """The rate of the last update made (reads the device)."""
        return float(self.lr(torch.clamp(self.count - 1, min=0)))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def grad_norm(self) -> torch.Tensor:
        """Global norm of the gradients (a 0-d device tensor); a parameter
        without a gradient counts as zeros, as in optax."""
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in self.params
             if p.grad is not None]
            or [torch.zeros((), device=self.count.device)]))

    def _update(self, p: torch.Tensor, g: torch.Tensor,
                st: Dict[str, torch.Tensor], bc1: torch.Tensor,
                bc2: torch.Tensor):
        """-> (the optimizer's update before the rate, new state);
        ``bc1``, ``bc2`` are the step's bias corrections for b1 and b2."""
        if self.optim in ("adam", "adamw"):
            mu = (1 - B1) * g + B1 * st["mu"]
            nu = (1 - B2) * (g * g) + B2 * st["nu"]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            if self.optim == "adamw":
                u = u + ADAMW_DECAY * p
            return u, {"mu": mu, "nu": nu}
        if self.optim == "adamax":
            mu = (1 - B1) * g + B1 * st["mu"]
            nu = torch.maximum(torch.abs(g) + EPS, B2 * st["nu"])
            return (mu / bc1) / nu, {"mu": mu, "nu": nu}
        if self.optim == "rmsprop":
            nu = (1 - RMSPROP_DECAY) * (g * g) + RMSPROP_DECAY * st["nu"]
            return torch.rsqrt(nu + RMSPROP_EPS) * g, {"nu": nu}
        if self.optim == "adagrad":
            acc = g * g + st["sum_of_squares"]
            inv = torch.where(acc > 0, torch.rsqrt(acc + ADAGRAD_EPS),
                              torch.zeros_like(acc))
            return inv * g, {"sum_of_squares": acc}
        return g, {}                                        # sgd

    @torch.no_grad()
    def step(self, ok: Optional[torch.Tensor] = None,
             norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Clip the gradients, update the parameters and the state, and
        return the global gradient norm taken before the clip (a 0-d
        tensor on the device; nothing here waits for the device).

        ``ok``: a 0-d bool device tensor; where it is False every
        parameter, state tensor and the count keep their old values.
        ``norm``: the gradients' global norm, when the caller has it."""
        if norm is None:
            norm = self.grad_norm()
        clip = self.grad_clip and self.grad_clip > 0
        count = self.count + 1
        step_size = -self.lr(self.count)
        bc1, bc2 = _bias_correction(B1, count), _bias_correction(B2, count)
        for p, st in zip(self.params, self.state):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if clip:
                g = torch.where(norm < self.grad_clip, g,
                                g / norm * self.grad_clip)
            u, new = self._update(p, g, st, bc1, bc2)
            new_p = p + u * step_size
            if ok is not None:
                new_p = torch.where(ok, new_p, p)
                new = {k: torch.where(ok, v, st[k]) for k, v in new.items()}
            p.copy_(new_p)
            for k, v in new.items():
                st[k].copy_(v)
        self.count.copy_(count if ok is None
                         else torch.where(ok, count, self.count))
        return norm

    def state_dict(self) -> dict:
        """Host copies of the count and every state tensor."""
        return {"optim": self.optim, "count": self.count.detach().cpu().clone(),
                "state": [{k: v.detach().cpu().clone() for k, v in st.items()}
                          for st in self.state]}

    def load_state_dict(self, state: dict) -> None:
        if state["optim"] != self.optim:
            raise ValueError(f"optimizer state of {state['optim']!r}, this "
                             f"optimizer is {self.optim!r}")
        with torch.no_grad():
            self.count.copy_(torch.as_tensor(state["count"]))
            for st, saved in zip(self.state, state["state"], strict=True):
                for k, v in st.items():
                    v.copy_(saved[k])
