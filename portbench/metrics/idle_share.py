"""``idle_share.<cells>``: the share of a unit's wall time in which no
device operation (kernel, copy or set) runs: one less the device's busy
time a unit in the traced window over the wall time a unit in the
measured, untraced window. The profiler stretches the traced window's own
wall time, so that window's idle share (``busy_s`` and ``window_s`` of the
result's ``device``) reads the tracer too."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    busy = run.trace.busy_s / run.trace.units
    return 1.0 - busy / (run.window.wall_s / run.window.units)
