"""Plain reference of ``heat_cn_d12_r64``: Crank-Nicolson trajectories of
``u_t = u_xx`` with Dirichlet ends on ``2^d`` interior points, stepped
densely in float64 from the seed's sine modes.

Step ``i`` is step ``i % L`` of the trajectory that starts from state
``(i // L) % pool`` of the draws. ``judge`` reads each kept step of the
port (its input and output states) on the grid and gives two numbers an
answer:

- ``traj_err``: ``|u_i - U_i| / |U_i|`` against the reference trajectory
  ``U_i`` after as many steps from the same start, which covers every
  step of the trajectory so far;
- ``inc_err``: ``|(u_i - u_in) - (M u_in - u_in)| / |M u_in - u_in|``,
  the step's increment against the reference step ``M = L^-1 R`` from the
  port's own input ``u_in``, so a step that returns its input reads 1.
"""

from __future__ import annotations

import torch

from portbench.reference.heat import grid, sine_grid, stencil

__all__ = ["judge", "step_matrix", "trajectories"]


def step_matrix(d: int, h: float, device) -> torch.Tensor:
    """Dense ``M = (I + c T)^-1 (I - c T)``, ``c = h / (2 hg^2)``."""
    c = h / (2.0 * (1.0 / (2 ** d + 1)) ** 2)
    return torch.linalg.solve(stencil(d, c, device), stencil(d, -c, device))


def trajectories(M, starts, steps) -> torch.Tensor:
    """``(len(steps), N)``: ``M^(n + 1)`` applied to ``starts[a]`` for each
    ``n = steps[a]``, all trajectories stepped together."""
    n = torch.as_tensor(steps, device=starts.device)
    u, out = starts.clone(), torch.empty_like(starts)
    for s in range(int(n.max()) + 1):
        u = u @ M.T
        out[n == s] = u[n == s]
    return out


def judge(config, traffic, draws, kept) -> dict:
    d, h, L = config["d"], config["h"], traffic["trajectory"]
    device = kept[0][2].device
    M = step_matrix(d, h, device)
    first = [(i // L) % draws.pool for i, _, _ in kept]
    starts = sine_grid(draws.modes[first], draws.amps[first], d, device)
    exact = trajectories(M, starts, [i % L for i, _, _ in kept])
    traj, inc = [], []
    for (i, before, after), U in zip(kept, exact):
        u0, u1 = grid(before), grid(after)
        traj.append(float(torch.linalg.norm(u1 - U) / torch.linalg.norm(U)))
        Mu0 = M @ u0
        inc.append(float(torch.linalg.norm(u1 - Mu0)
                         / torch.linalg.norm(Mu0 - u0)))
    return {"traj_err": traj, "inc_err": inc}
