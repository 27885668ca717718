"""``step_roofline.<cells>``: the unit's least time at the card's peaks
(its counted FLOPs at the f32 peak or its bytes at the memory peak,
whichever is longer) over the device time of every kernel of the unit in
the traced window (the union of their intervals), in %."""

from portbench.core.peaks import least_seconds


def read(run):
    if run.trace is None or run.trace.kernel_s <= 0:
        return None
    return 100.0 * least_seconds(run.work) * run.trace.units / run.trace.kernel_s
