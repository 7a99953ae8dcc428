"""PyTorch/CUDA port of ``cst_captioning_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here
mirrors its counterpart's path and names (``models/captioner.py`` ->
``models/captioner.py``), and the two Pallas kernels of the reference are
hand-written CUDA C++ under ``csrc/`` (``ops/attention_kernel.py`` and
``ops/decode_cell_kernel.py`` wrap them).

This package imports ``torch``, numpy and the standard library only —
never JAX, Flax or the reference package.  Entry points run on the CUDA
device unless the caller asks for the CPU (``device="cpu"``); without a
GPU they raise instead of quietly running on the CPU.

The model computes in float32, or in bfloat16 over float32 parameters
(``--use_bfloat16``, ``precision.py``).  TF32 is switched off for matmuls
and cuDNN at import so the card's float32 products are full float32, as
the JAX CPU reference is; and cuBLAS may not reduce split-K partial sums
of a bfloat16 product in bfloat16 (its default allows it), so a bfloat16
product is a float32 sum rounded once, as XLA computes it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def default_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` names
    another one.  Raises when CUDA is wanted and no GPU is visible — the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or "
            "--device cpu) to run on the CPU")
    return dev
