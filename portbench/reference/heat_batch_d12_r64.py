"""Plain reference of ``heat_batch_d12_r64``: each implicit heat solve
``(I - h/2 A) x = b``, ``A`` the Dirichlet three-point Laplacian on
``2^d`` interior points, solved densely in float64 from the seed's sine
modes.

``judge`` reads every problem of each kept call on the grid and gives two
numbers a problem: ``sol_err``, ``|x - X| / |X|`` against the reference
solution ``X``, and ``residual``, ``|(I - h/2 A) x - b| / |b|``.
"""

from __future__ import annotations

import torch

from portbench.reference.heat import grid, sine_grid, stencil

__all__ = ["judge"]


def judge(config, traffic, draws, kept) -> dict:
    d, h = config["d"], config["h"]
    device = kept[0][1].device
    L = stencil(d, h / (2.0 * (1.0 / (2 ** d + 1)) ** 2), device)
    B = draws.batch
    err, res = [], []
    for i, out in kept:
        p = i % draws.pool
        b = sine_grid(draws.modes[p * B:(p + 1) * B],
                      draws.amps[p * B:(p + 1) * B], d, device)   # (B, N)
        X = torch.linalg.solve(L, b.T).T
        x = grid(out)
        err += (torch.linalg.norm(x - X, dim=1)
                / torch.linalg.norm(X, dim=1)).tolist()
        res += (torch.linalg.norm(x @ L - b, dim=1)
                / torch.linalg.norm(b, dim=1)).tolist()
    return {"sol_err": err, "residual": res}
