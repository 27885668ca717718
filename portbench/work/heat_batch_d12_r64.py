"""Work of one batched call of ``heat_batch_d12_r64``."""

from __future__ import annotations

import numpy as np

from portbench.work.counts import als_sweeps_flops

# I - h/2 A with A the rank-3 QTT of the three-point Laplacian: rank 4
RA = 4


def unit_work(config, traffic) -> dict:
    """FLOPs of ``batch`` ALS calls at the configured CG iterations, each
    local solve applying its operator once for the warm start's residual
    and once an iteration; bytes of the right-hand sides (which are also
    the warm start) read and the solutions written once, and of the
    packed operator read once."""
    d, R, n, B = config["d"], config["rmax"], config["n"], traffic["batch"]
    item = np.dtype(config["dtype"]).itemsize
    flops = B * als_sweeps_flops(d, R, RA, R, n, config["sweep_count"],
                                 config["cg_iters"] + 1)
    state = d * R * n * R * item
    return {"flops": flops,
            "bytes": 2 * B * state + d * RA * n * n * RA * item}
