"""The low-precision (bfloat16) decode-step variant behind
``--decode_kernel bf16`` (counterpart of the reference's
``ops/bf16_decode.py``).

The model's parameters stay float32; only the decode step computes in
bfloat16: the same cell as ``--use_bfloat16`` trains, cloned over the
same parameter tensors (``CaptionModel.clone``), scoped to
``make_decode_step`` so teacher forcing, the RL gradient and every
checkpoint are untouched.  With ``--pallas_attention 1`` the clone's
attention runs on K1 in bfloat16 storage.

Boundary contract, as the reference's:

- **float32 at the seams.**  The step takes the float32 carry its callers
  allocate (samplers, beam search, the serving engine's slot buffers),
  casts it to bfloat16 for the cell and the result back.  bfloat16 ->
  float32 is exact and float32 -> bfloat16 of a bfloat16 value is the
  identity, so this computes the sequence a bfloat16 carry would.  The
  encodings are cast once, when the step is bound.
- **float32 logits.**  Argmax, log-softmax and beam scores downstream see
  float32 logits holding bfloat16 values.

The parity gate: bfloat16 decode is not bit-identical to float32, so it
ships behind ``parity_gate``, one decision rule on the corpus CIDEr-D
delta against the float32 decode of the same checkpoint
(``DEFAULT_CIDER_DELTA_BOUND``); ``tools/bf16_parity.py`` measures it.
Outside the bound the recommendation is ``reference``, the bit-exact
path.

On a model that already computes in bfloat16 the variant IS the
reference cell (no casts to add): ``bf16_decode_supported`` says so and
``make_decode_step`` binds the reference cell, noting it once in the log.
That is the same function, not a fallback to another device or kernel.
"""

from __future__ import annotations

import logging
from typing import Callable, Tuple

import torch

log = logging.getLogger(__name__)

#: Declared bound of the parity gate: |CIDEr-D(bf16) - CIDEr-D(fp32)| on
#: the same checkpoint and split (the reference's value: well inside the
#: run-to-run spread of the training protocol).
DEFAULT_CIDER_DELTA_BOUND = 0.02

_noted = set()


def bf16_decode_supported(model) -> Tuple[bool, str]:
    """(eligible, reason): every decoder the reference step serves is
    eligible, except a model whose compute dtype is already bfloat16."""
    if getattr(model, "dtype", torch.float32) == torch.bfloat16:
        return False, "model compute dtype is already bfloat16"
    return True, ""


def note_reference_once(reason: str) -> None:
    """``--decode_kernel bf16`` on a model it does not wrap: one log line
    per reason per process; the reference cell, which already computes in
    bfloat16, is the step."""
    if reason not in _noted:
        _noted.add(reason)
        log.warning("decode_kernel=bf16: %s; the reference cell is the "
                    "bfloat16 step", reason)


def _cast_carry(carry, dtype: torch.dtype):
    """The carry's float leaves cast to ``dtype``; the transformer carry's
    token buffer and position keep theirs, as the reference's."""
    if isinstance(carry, (tuple, list)):
        return type(carry)(_cast_carry(x, dtype) for x in carry)
    if isinstance(carry, torch.Tensor) and carry.is_floating_point():
        return carry.to(dtype)
    return carry


def make_bf16_decode_step(model, memory: torch.Tensor,
                          proj_mem: torch.Tensor,
                          pooled: torch.Tensor) -> Callable:
    """``step(carry, token (N,)) -> (carry, logits (N, V))`` with the
    model's reference cell in bfloat16 (the contract of
    ``ops.sampling.make_decode_step``): carry and logits float32 at the
    boundary, encodings cast once here."""
    bf16 = torch.bfloat16
    m = model.clone(dtype=bf16, decode_kernel="reference")
    mem_b, proj_b, pooled_b = (x.to(bf16) for x in (memory, proj_mem,
                                                    pooled))

    def step(carry, token):
        carry, logits = m.decode(_cast_carry(carry, bf16), token[:, None],
                                 mem_b, proj_b, pooled_b)
        return _cast_carry(carry, torch.float32), logits[:, 0, :].float()

    return step


def parity_gate(cider_fp32: float, cider_bf16: float,
                bound: float = DEFAULT_CIDER_DELTA_BOUND) -> dict:
    """The one decision rule for shipping the bfloat16 decode variant ->
    ``{"cider_fp32", "cider_bf16", "delta", "bound", "within_bound",
    "kernel_recommendation"}``: within the bound ``"bf16"`` is eligible,
    outside it the recommendation is ``"reference"``."""
    delta = float(cider_bf16) - float(cider_fp32)
    within = abs(delta) <= float(bound)
    return {
        "cider_fp32": float(cider_fp32),
        "cider_bf16": float(cider_bf16),
        "delta": delta,
        "bound": float(bound),
        "within_bound": within,
        "kernel_recommendation": "bf16" if within else "reference",
    }
