"""Interpolative QTT construction: a QTT of a 1-D function built without
sampling the full ``2^d`` grid, by Chebyshev–Lagrange interpolation of the
dyadic tail.

With ``x = 0.sigma_1 sigma_2 ...`` and tail ``t_k = 0.sigma_{k+1}...``, the
recursion ``t_{k-1} = (sigma_k + t_k) / 2`` turns barycentric interpolation
``f(x) ~ sum_a l_a(t) f(node_a)`` into an exact TT of rank N::

    core 1  [1, s, b] = f((s + c_b) / 2)          (scaled to [a, b])
    core k  [a, s, b] = l_a((s + c_b) / 2)
    core d  [a, s, 1] = l_a(s / 2)

the cascade of the quantics DFT cores (:mod:`ttnx_torch.ops.fourier`).
``2N`` evaluations of ``f``; the cores are assembled with numpy and placed
on ``device``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ttnx_torch.core.canonical import tt_round
from ttnx_torch.core.tt import TTVector
from ttnx_torch.ops.fourier import _lagrange_eval_matrix, cheb_lobatto_lagrange

__all__ = ["interpolating_qtt", "lagrange_rank_revealing"]


def interpolating_qtt(f: Callable, num_cores: int, N: int, a: float = 0.0,
                      b: float = 1.0, *, device) -> TTVector:
    """Rank-N QTT of ``f`` on the dyadic grid ``x_i = a + (b - a) i / 2^d``
    by Chebyshev–Lobatto Lagrange interpolation on N nodes."""
    if num_cores < 2:
        raise ValueError("num_cores must be >= 2")
    if N < 2:
        raise ValueError("N (number of interpolation nodes) must be >= 2")
    grid, w = cheb_lobatto_lagrange(N - 1)
    sigma = np.array([0.0, 1.0])
    xs = 0.5 * (sigma[:, None] + grid[None, :])  # (2, N)
    first = np.asarray(f(a + (b - a) * xs))[None]  # (1, 2, N)
    mid = _lagrange_eval_matrix(grid, w, xs.reshape(-1)).reshape(N, 2, N)
    last = _lagrange_eval_matrix(grid, w, 0.5 * sigma).reshape(N, 2, 1)
    cores = [first] + [mid] * (num_cores - 2) + [last]
    return TTVector([torch.as_tensor(c, device=device) for c in cores])


def lagrange_rank_revealing(f: Callable, num_cores: int, N: int,
                            a: float = 0.0, b: float = 1.0,
                            rel_tol: float = 1e-12,
                            max_bond: int | None = None, *,
                            device) -> TTVector:
    """:func:`interpolating_qtt` at full rank N, then ``tt_round`` to the
    numerical ranks of ``f`` under ``rel_tol`` (and ``max_bond``)."""
    tt = interpolating_qtt(f, num_cores, N, a=a, b=b, device=device)
    return tt_round(tt, max_bond=max_bond, rel_tol=rel_tol)
