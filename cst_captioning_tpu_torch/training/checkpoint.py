"""Stage checkpoints (the role of the reference's
``training/checkpoint.py``, much reduced).

A stage directory holds ``best.pt`` (the parameters of the best
validation score) and ``last.pt`` (the state at the last epoch boundary),
each a ``torch.save`` of ``{"model", "optimizer", "step", "best_score",
"score", "opt"}`` written to a temporary file and renamed over the old
one, so a reader never sees a torn file.  ``--start_from DIR`` reads the
parameters of ``DIR/best.pt`` only, as the reference's ``--start_from``
warm-starts parameters and not the optimizer.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

BEST, LAST = "best.pt", "last.pt"


def save(directory: str, name: str, payload: Dict[str, Any]) -> str:
    """Write ``payload`` to ``directory/name`` atomically; -> the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load(directory: str, name: str = BEST) -> Dict[str, Any]:
    """The payload of ``directory/name``, tensors on the CPU."""
    path = os.path.join(directory, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint {path}")
    return torch.load(path, map_location="cpu", weights_only=True)
