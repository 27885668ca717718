"""Plain reference of ``heat2d_cn_d20_r64``: Crank-Nicolson trajectories of
``u_t = u_xx + u_yy`` on the unit square with Dirichlet walls, ``N x N``
interior points (``N = 2^da``, ``hg = 1 / (N + 1)``), stepped in float64 in
the sine basis.

The step is separable: with ``S`` the orthonormal DST-I of size ``N`` (the
eigenvectors of ``T = tridiag(-1, 2, -1)``, ``S = S^T = S^-1``) and
``lam_k = 2 - 2 cos(k pi hg)``, one step maps the grid ``U`` to
``S (g * (S U S)) S`` with ``g_kl = (1 - c (lam_k + lam_l)) / (1 + c (lam_k
+ lam_l))`` and ``c = h / (2 hg^2)``. A dense step matrix of ``N^2`` rows is
never formed.

Each kept unit is ``(step index, input state, output state, starting state
of its trajectory)``, the port's own padded stacks; they are read on the
grid as a ``(N, N)`` plane, ``u[i, j]`` with ``i`` the first ``da`` sites.
``judge`` gives two numbers an answer:

- ``traj_err``: ``|u_i - U_i| / |U_i|`` against the reference trajectory
  ``U_i`` after as many steps from the starting state the port was given,
  which covers every step of the trajectory so far;
- ``inc_err``: ``|(u_i - u_in) - (M u_in - u_in)| / |M u_in - u_in|``,
  the step's increment against the reference step ``M`` from the port's
  own input ``u_in``, so a step that returns its input reads 1.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.heat import F64, grid

__all__ = ["judge", "dst_matrix", "gains", "plane", "steps"]


def dst_matrix(N: int, device) -> torch.Tensor:
    """Orthonormal DST-I: ``S[j, k] = sqrt(2 / (N + 1)) sin(pi (j + 1)
    (k + 1) / (N + 1))``."""
    j = torch.arange(1, N + 1, dtype=F64, device=device)
    return math.sqrt(2.0 / (N + 1)) * torch.sin(
        torch.pi * j[:, None] * j[None, :] / (N + 1))


def gains(da: int, h: float, device) -> torch.Tensor:
    """``(N, N)``: the factor one step puts on mode ``(k, l)``."""
    N = 2 ** da
    hg = 1.0 / (N + 1)
    c = h / (2.0 * hg ** 2)
    lam = 2.0 - 2.0 * torch.cos(
        torch.arange(1, N + 1, dtype=F64, device=device) * torch.pi * hg)
    s = c * (lam[:, None] + lam[None, :])
    return (1.0 - s) / (1.0 + s)


def plane(stack) -> torch.Tensor:
    """``(..., N, N)`` float64 grid of padded serial stacks ``(..., 2 da,
    R, 2, R)``."""
    N = 2 ** (stack.shape[-4] // 2)
    return grid(stack).reshape(*stack.shape[:-4], N, N)


def steps(S, g, U, n: int) -> torch.Tensor:
    """``n`` reference steps from the grid ``U``."""
    return S @ ((g ** n) * (S @ U @ S)) @ S


def judge(config, traffic, draws, kept) -> dict:
    da, h, L = config["d_axis"], config["h"], traffic["trajectory"]
    device = kept[0][2].device
    S, g = dst_matrix(2 ** da, device), gains(da, h, device)
    traj, inc = [], []
    for i, before, after, start in kept:
        U = steps(S, g, plane(start), i % L + 1)
        u0, u1 = plane(before), plane(after)
        Mu0 = steps(S, g, u0, 1)
        traj.append(float(torch.linalg.norm(u1 - U) / torch.linalg.norm(U)))
        inc.append(float(torch.linalg.norm(u1 - Mu0)
                         / torch.linalg.norm(Mu0 - u0)))
    return {"traj_err": traj, "inc_err": inc}
