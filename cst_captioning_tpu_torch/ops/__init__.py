"""Decode-time ops of the port and the wrappers of its CUDA kernels."""

from .attention_kernel import fused_additive_attention
from .decode_cell_kernel import fused_decode_cell

#: Every kernel wrapper of the port; each carries a ``launches`` count.
KERNEL_WRAPPERS = (fused_additive_attention, fused_decode_cell)


def launch_counts() -> dict:
    """``{wrapper name: launches}`` for every kernel wrapper."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
