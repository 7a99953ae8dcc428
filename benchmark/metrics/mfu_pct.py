"""The whole step's share of the chip's peak at the configuration's
precision: the configuration's model FLOPs a step (``benchmark/flops/``)
times the window's steps, over the window's seconds and the peak."""


def read(run):
    if not run.steps or not run.peak_flops:
        return None
    return (100.0 * run.flops_per_step * run.steps / run.window_s
            / run.peak_flops)
