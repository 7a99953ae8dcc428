"""K1 (``fused_additive_attention``)'s share of its roofline in the traced segment: the least
time of every call's work (``cstbench/roofline.py``, from the call's
shapes) over the device time of the kernels launched inside the
benchmark's ``bench.k1`` ranges around the calls, matched by the
launches' correlation ids."""

from cstbench import roofline

RANGE = "bench.k1"


def read(run):
    if run.trace is None or not run.calls["k1"]:
        return None
    seconds, kernels = run.trace.ranges.get(RANGE, (0.0, 0))
    if not kernels or seconds <= 0:
        return None
    least = 0.0
    for *shape, elem in run.calls["k1"]:
        n_bytes, n_ops = roofline.attention_work(*shape, elem)
        least += roofline.least_seconds(
            n_bytes, n_ops, "float32" if elem == 4 else "bfloat16")
    return 100.0 * least / seconds
