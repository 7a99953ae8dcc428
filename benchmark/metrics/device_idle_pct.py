"""Share of the traced window in which no kernel, copy or memset ran on
the device (``torch.profiler``'s trace)."""


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
