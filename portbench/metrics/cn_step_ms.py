"""``cn_step_ms``: the window's wall time over the steps completed in it."""


def read(run):
    return run.window.wall_s / run.window.units * 1e3
