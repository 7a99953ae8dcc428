"""Compute dtype of the port's modules: the counterpart of flax's
``dtype=`` over ``param_dtype=float32`` (the reference's
``--use_bfloat16``).

Parameters, their gradients and the optimizer state stay float32 in
either dtype.  Each op casts at use, as flax does:

- ``dense``: input, kernel and bias cast to the compute dtype; a product
  in that dtype (float32 accumulation, rounded once), then the bias add
  in that dtype.  In float32 it is the one ``F.linear`` the port has
  always run, so the float32 path is unchanged bit for bit.
- ``embed``: the table cast to the compute dtype, then the gather.
- ``sigmoid``, ``log_softmax``, ``softmax`` and ``gelu`` in bfloat16
  take the reference's op order, each op rounding to bfloat16 as XLA runs them:
  ``1 / (1 + exp(-x))``, ``x - m - log(sum exp(x - m))`` and
  ``exp(x - m) / sum exp(x - m)`` with the sums taken in float32, and
  ``x * (0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 * x ** 3))))``.  ``torch.sigmoid`` and ``torch.log_softmax`` round
  once at the end, a different function in bfloat16 (3 in 10 sigmoids
  and 2 in 10 log-probabilities land on another bfloat16 value).  In
  float32 both are the torch ops the port has always run.

No ``torch.autocast``: it keeps softmax, log-softmax and the losses in
float32 and picks its own cast points, a different function from the
reference's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

#: The compute dtypes the port runs: float32, and bfloat16 as the
#: reference runs it under ``--use_bfloat16``.
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """``dtype`` if the port computes in it; ``ValueError`` otherwise."""
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype must be float32 or bfloat16, got "
                         f"{dtype!r}")
    return dtype


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` with a torch-layout ``(out, in)``
    weight.  float32: ``F.linear(x, weight, bias)``; bfloat16: a bfloat16
    product, then a bfloat16 bias add (two roundings, as XLA's dot and
    add)."""
    if dtype == torch.float32:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax ``nn.Embed(dtype=dtype)``: the table cast, then the gather."""
    return F.embedding(tokens, table.to(dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` in ``x``'s dtype: float32 ``torch.sigmoid``;
    bfloat16 ``1 / (1 + exp(-x))``, each op rounded to bfloat16."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.log_softmax`` in ``x``'s dtype: float32
    ``torch.log_softmax``; bfloat16 ``shifted - log(sum(exp(shifted)))``
    with ``shifted = x - max(x)`` (the max held constant, as the
    reference's ``stop_gradient``), each op rounded to bfloat16 and the
    sum accumulated in float32."""
    if x.dtype == torch.float32:
        return torch.log_softmax(x, dim=dim)
    shifted = x - x.detach().amax(dim=dim, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=dim, keepdim=True))


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax`` in ``x``'s dtype: float32 ``torch.softmax``;
    bfloat16 ``e / sum(e)`` with ``e = exp(x - max(x))``, each op rounded
    to bfloat16 and the sum accumulated in float32."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.detach().amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True, dtype=torch.float32).to(x.dtype)


_SQRT_2_OVER_PI = 0.7978845608028654


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (``approximate=True``, flax's ``nn.gelu``) in
    ``x``'s dtype: float32 ``F.gelu(x, approximate="tanh")``; bfloat16 the
    reference's formula, each op rounded to bfloat16."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                  * (x + 0.044715 * x ** 3)))
    return x * cdf
