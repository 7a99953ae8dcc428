"""The 95th percentile of all the window's step times: the intervals
between the CUDA events recorded after each step, idle gaps included."""

import numpy as np


def read(run):
    if not run.step_ms:
        return None
    return float(np.percentile(np.asarray(run.step_ms, dtype=np.float64),
                               95))
