"""Share of the window the training loop waited on the prefetcher for
its next batch: the program's ``data_wait`` phase (``--step_timing 1``,
``telemetry/phases.py``) summed over the window's steps."""


def read(run):
    if run.data_wait_s is None or not run.window_s:
        return None
    return 100.0 * run.data_wait_s / run.window_s
