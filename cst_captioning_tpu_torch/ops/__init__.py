"""Decode-time ops of the port and the wrappers of its CUDA kernels."""

from . import _cuda
from .attention_kernel import fused_additive_attention
from .decode_cell_kernel import fused_decode_cell

#: Every kernel wrapper of the port; each carries a ``launches`` count and
#: ``launches_by_dtype``, the same launches per storage dtype.
KERNEL_WRAPPERS = (fused_additive_attention, fused_decode_cell)


def launch_counts() -> dict:
    """``{wrapper name: launches}`` for every kernel wrapper."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def launch_counts_by_dtype() -> dict:
    """``{"wrapper name/storage dtype": launches}`` for every kernel
    wrapper and storage dtype (float32, bfloat16)."""
    return {f"{fn.__name__}/{dtype}": n for fn in KERNEL_WRAPPERS
            for dtype, n in fn.launches_by_dtype.items()}


def kernel_state() -> dict:
    """Kernel-library builds and loads, and launches: what a flight
    recorder's blackbox carries about the kernels."""
    return {"library_events": _cuda.library_events(),
            "launches": launch_counts()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        fn.launches_by_dtype = dict.fromkeys(fn.launches_by_dtype, 0)
