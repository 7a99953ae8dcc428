"""The ``--feat_shapes`` option shared by the serving and training CLIs."""

from __future__ import annotations

from typing import List, Tuple


def parse_feat_shapes(spec: str) -> List[Tuple[int, int]]:
    """``"28x2048,1x4096"`` -> ``[(28, 2048), (1, 4096)]``."""
    shapes = []
    for tok in spec.replace(" ", "").split(","):
        try:
            t, d = (int(x) for x in tok.lower().split("x"))
        except ValueError:
            raise ValueError(f"bad feature shape {tok!r}; expected TxD, "
                             "e.g. '28x2048,1x4096'") from None
        if t < 1 or d < 1:
            raise ValueError(f"feature shape {tok!r} must be positive")
        shapes.append((t, d))
    return shapes
