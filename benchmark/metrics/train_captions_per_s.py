"""Caption rows trained a second: every row of the window's completed
steps over the window's seconds (host clock, between two device
synchronisations)."""


def read(run):
    if not run.steps:
        return None
    return run.steps * run.rows_per_step / run.window_s
