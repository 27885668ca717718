"""``setup_s``: seconds from the process's start to the first measured
unit (imports, the kernel library's build or load, inputs and port on the
device, the warm-up units)."""


def read(run):
    return run.setup_s
