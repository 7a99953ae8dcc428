"""The traced segment's reduction on a hand-made Chrome trace: the busy
union inside the window, the idle gaps by what the main thread was
doing, the top device operations, and the device time of the kernels
launched inside each ``bench.k*`` range, by correlation id."""

import pytest

from _tiny import BENCH  # noqa: F401  (the paths)

from cstbench import trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    ev("user_annotation", trace.WINDOW, 0, 100),
    ev("user_annotation", "bench.k1", 10, 5),
    ev("cuda_runtime", "cudaLaunchKernel", 11, 1, corr=7),
    ev("cpu_op", "aten::mm", 30, 40),
    ev("cuda_runtime", "cudaLaunchKernel", 31, 1, corr=8),
    ev("user_annotation", "bench.k2", 75, 5, tid=2),
    ev("cuda_driver", "cuLaunchKernelEx", 76, 1, tid=2, corr=9),
    ev("kernel", "attention_kernel", 20, 10, tid=99, corr=7),
    ev("kernel", "gemm", 40, 20, tid=99, corr=8),
    ev("kernel", "gemm", 55, 10, tid=99, corr=8),
    ev("kernel", "gate_tile_kernel", 80, 30, tid=99, corr=9),
]


def test_summary_of_a_hand_made_trace():
    s = trace.summarize(EVENTS)
    assert s.window_s == pytest.approx(100e-6)
    # busy: [20,30) + [40,65) + [80,100) clipped to the window = 55 us
    assert s.busy_s == pytest.approx(55e-6)
    assert dict(s.device_ops)["gemm"] == pytest.approx(30e-6)
    gaps = dict(s.idle_gaps)
    # [0,20) mid 10 -> bench.k1 starts at 10; [30,40) inside aten::mm;
    # [65,80) mid 72.5 -> nothing on the main thread
    assert gaps["bench.k1"] == pytest.approx(20e-6)
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert gaps["python"] == pytest.approx(15e-6)
    assert s.ranges["bench.k1"] == (pytest.approx(10e-6), 1)
    assert s.ranges["bench.k2"] == (pytest.approx(30e-6), 1)


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        trace.summarize(EVENTS[1:])


def test_a_trace_of_the_device_alone_takes_the_hosts_window():
    device_only = [e for e in EVENTS if e["cat"] == "kernel"]
    s = trace.summarize(device_only, window_s=200e-6)
    assert s.window_s == 200e-6
    # from the first kernel (20 us): [20,30) + [40,65) + [80,110)
    assert s.busy_s == pytest.approx(65e-6)
