"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
full 700 W) and the least time a kernel call's work could take on it.

A call's work is counted from its shapes, whatever kernel implements it:
each input byte read once and each output byte written once, and the
operations at the peak of the storage's precision.  The least time is the
larger of bytes over the memory's rate and operations over the peak.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def least_seconds(n_bytes: float, n_ops: float, precision: str) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOPS[precision])


def attention_work(b: int, t: int, a: int, h: int, elem: int):
    """K1, one call of ``fused_additive_attention``: reads q (B, A),
    proj_mem (B, T, A), memory (B, T, H) in the storage and score_v (A,)
    in float32; writes ctx (B, H) and the weights (B, T).  Operations:
    the scores (add, tanh, multiply, sum: 4 T A), the softmax (5 T) and
    the context (2 T H), per row.  -> (bytes, operations)."""
    n_bytes = elem * (b * a + b * t * a + b * t * h + b * h + b * t) + 4 * a
    return n_bytes, b * (4 * t * a + 5 * t + 2 * t * h)


def decode_cell_work(b: int, t: int, e: int, a: int, h: int, elem: int):
    """K2, one call of ``fused_decode_cell``: reads x (B, E), c, h (B, H),
    q (B, A), proj_mem (B, T, A), memory (B, T, H), the gate weights
    (E + 2H, 4H) and bias (4H,) in the storage and score_v (A,) in
    float32; writes c' and h' (B, H).  Operations: the attention as K1's,
    the gate product (2 (E + 2H) 4H per row) and the state update (10 H
    per row).  -> (bytes, operations)."""
    n_bytes = (elem * (b * (e + 2 * h + a) + b * t * (a + h)
                       + (e + 2 * h) * 4 * h + 4 * h + 2 * b * h) + 4 * a)
    n_ops = (b * (4 * t * a + 5 * t + 2 * t * h)
             + 2 * b * (e + 2 * h) * 4 * h + 10 * b * h)
    return n_bytes, n_ops
