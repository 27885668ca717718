"""``kernel_launches.<cells>``: device kernels a unit in the traced window,
whichever code launched them."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.trace.units
