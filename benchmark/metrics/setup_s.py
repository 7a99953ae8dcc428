"""Seconds from the run's start to the window's: imports, the CUDA
context, the inputs, the program's set-up (the kernels' build in a fresh
checkout, the reward tables), its first steps and the warm-up."""


def read(run):
    return run.setup_s if run.steps else None
