"""Plain float64 pieces shared by the heat references: the grid, the
sampled sine states, the dense tridiagonal operators, and the contraction
that reads a padded QTT stack back on the grid.

Nothing here imports the port: the operators are rebuilt from the
three-point stencil, the states from the mode numbers and amplitudes, and
the ranks of a stack from the sizes alone.
"""

from __future__ import annotations

import torch

__all__ = ["sine_grid", "stencil", "grid", "feasible_ranks"]

F64 = torch.float64


def sine_grid(modes, amps, d: int, device) -> torch.Tensor:
    """``(S, 2^d)``: ``sum_m amps[s, m] sin(modes[s, m] pi hg (j + 1))``."""
    hg = 1.0 / (2 ** d + 1)
    j = torch.arange(1, 2 ** d + 1, dtype=F64, device=device)
    k = torch.as_tensor(modes, dtype=F64, device=device)
    a = torch.as_tensor(amps, dtype=F64, device=device)
    return torch.einsum("sm,smj->sj", a,
                        torch.sin(torch.pi * hg * k[..., None] * j))


def stencil(d: int, c: float, device) -> torch.Tensor:
    """Dense ``I + c T``, ``T = tridiag(-1, 2, -1)`` of size ``2^d``: with
    ``c = +-h / (2 hg^2)`` the two sides of a Crank-Nicolson step of
    ``u_t = u_xx`` with Dirichlet ends."""
    N = 2 ** d
    T = 2.0 * torch.eye(N, dtype=F64, device=device)
    idx = torch.arange(N - 1, device=device)
    T[idx, idx + 1] = -1.0
    T[idx + 1, idx] = -1.0
    return torch.eye(N, dtype=F64, device=device) + c * T


def feasible_ranks(d: int, R: int) -> list[int]:
    """Bond ranks ``min(2^k, 2^(d-k), R)`` of a binary QTT at buffer rank R."""
    return [min(2 ** k, 2 ** (d - k), R) for k in range(d + 1)]


def grid(stack) -> torch.Tensor:
    """``(..., 2^d)`` float64 values of padded stacks ``(..., d, R, 2, R)``,
    site 0 the most significant bit; padding beyond the feasible ranks is
    not read."""
    d, R = stack.shape[-4], stack.shape[-3]
    r = feasible_ranks(d, R)
    v = stack[..., 0, 0, :, :r[1]].to(F64)                    # (..., 2, r1)
    for k in range(1, d):
        core = stack[..., k, :r[k], :, :r[k + 1]].to(F64)    # (..., rk, 2, r)
        v = torch.einsum("...xa,...anb->...xnb", v, core).flatten(-3, -2)
    return v[..., 0]
