"""``host_syncs.<cells>``: host waits on the device a unit in the traced
window, counted from the trace's CUDA runtime and driver calls (the
synchronizes and synchronous copies, wherever in the process they were
made, the kernel library's included) that start while the units run, so
the window's own closing synchronize is not counted. Silent on a trace
that holds no device operation."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return run.trace.host_syncs / run.trace.units
