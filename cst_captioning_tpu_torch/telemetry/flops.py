"""Analytic model FLOPs of a training step and the MFU derived from them
(own copy of the reference's ``telemetry/flops.py``, with a peak table
keyed on the CUDA device name).

Counts the matmul work of the architecture (encoder projections, memory
projection, per-step attention, LSTM gates, vocab head) at 2 FLOPs per
multiply-add, the backward at twice the forward: the usual "model FLOPs",
so the MFU leaves out recomputation and the reward's integer hashing.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

#: Dense bfloat16 tensor-core peak, TFLOP/s, by a substring of
#: ``torch.cuda.get_device_name()`` (first match wins): NVIDIA's data
#: sheet for the H100 SXM at its full 700 W, the figure the kernel bounds
#: of ``chip_smoke.py`` use.  Another card reports ``mfu_pct`` null.
PEAK_BF16_TFLOPS = (("H100 80GB HBM3", 989.0),)

#: The MSR-VTT feature shapes (ResNet-152 + C3D) the bench runs at.
DEFAULT_FEAT_SHAPES: Tuple[Tuple[int, int], ...] = ((28, 2048), (1, 4096))


def peak_tflops(device_name: str) -> Optional[float]:
    for sub, peak in PEAK_BF16_TFLOPS:
        if sub in (device_name or ""):
            return peak
    return None


def caption_step_flops(
    batch_size: int,
    seq_per_img: int,
    seq_len: int,
    vocab: int,
    hidden: int,
    feat_shapes: Sequence[Tuple[int, int]] = DEFAULT_FEAT_SHAPES,
) -> Dict[str, float]:
    """Analytic matmul FLOPs of one optimizer step -> {"xe": F, "cst": F}.

    Embed = attention = hidden width.  CST counts the fused step: the
    sampled rollout and the greedy baseline rollout (forward only, one
    shared encode) and the REINFORCE gradient step (forward and backward)
    over the sampled captions.
    """
    B, S, L = batch_size, seq_per_img, seq_len
    N = B * S
    H = A = hidden
    V = vocab
    feat = list(feat_shapes)
    T = sum(t for t, _ in feat)
    enc = B * sum(t * d * H for t, d in feat)   # per-modality Dense
    enc += B * (len(feat) * H) * H              # fuse Dense
    enc += B * T * H * A                        # memory_proj (attention)
    enc += B * H * 2 * H                        # state_init
    # One decoder step of one caption: the attention query projection,
    # the additive scores and the context, the LSTM gates on
    # concat(embed, context) -> (3H x 4H), and the vocab head.
    per_step = H * A + T * A + T * H + 3 * H * 4 * H + H * V
    dec = N * L * per_step
    fwd = enc + dec
    xe = 3 * fwd * 2.0                          # fwd + 2x bwd, 2 FLOPs/MAC
    # The greedy baseline decodes one row per video (B rows, not B*S).
    greedy_dec = B * L * per_step
    cst = (enc + dec + greedy_dec) * 2.0 + xe
    return {"xe": xe, "cst": cst}


def mfu_fields(flops_per_step: float, captions_per_sec: Optional[float],
               ncaps: int, device_name: Optional[str]) -> dict:
    """captions/s -> {model_tflops_per_step, achieved_tflops, mfu_pct};
    ``mfu_pct`` is None on a device without a peak in the table (the CPU,
    an unknown card)."""
    if not captions_per_sec:
        return {}
    achieved = flops_per_step * captions_per_sec / ncaps / 1e12
    peak = peak_tflops(device_name or "")
    sig = lambda x: float(f"{x:.4g}")  # noqa: E731 (tiny shapes stay nonzero)
    return {
        "model_tflops_per_step": sig(flops_per_step / 1e12),
        "achieved_tflops": sig(achieved),
        "mfu_pct": None if peak is None else sig(100.0 * achieved / peak),
    }
