"""``cn_step_p95_ms``: the 95th percentile, over every step of the window,
of the time between consecutive step ends on the device (CUDA events)."""

import numpy as np


def read(run):
    return float(np.percentile(run.window.intervals_ms, 95))
