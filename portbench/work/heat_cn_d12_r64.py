"""Work of one CN step of ``heat_cn_d12_r64``."""

from __future__ import annotations

import numpy as np

from portbench.work.counts import cn_step_flops

# I -/+ h/2 A with A the rank-3 QTT of the three-point Laplacian: rank 4
RA = 4


def unit_work(config, traffic) -> dict:
    """FLOPs at the configured CG iterations, each local solve applying its
    operator once for the warm start's residual and once an iteration;
    bytes of the state read and written once and of both packed operators
    read once."""
    d, R, n = config["d"], config["rmax"], config["n"]
    item = np.dtype(config["dtype"]).itemsize
    flops = cn_step_flops(d, R, RA, RA, n, config["sweep_count"],
                          config["cg_iters"] + 1)
    state = d * R * n * R * item
    operators = 2 * d * RA * n * n * RA * item
    return {"flops": flops, "bytes": 2 * state + operators}
