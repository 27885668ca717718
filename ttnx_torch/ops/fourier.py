"""Quantics discrete Fourier transform as a low-rank MPO (arXiv:2404.03182).

Core entries are ``l_alpha(0.5 (sigma + c_beta)) exp(i pi sign (sigma +
c_beta) tau)``, with barycentric Lagrange interpolation on the
Chebyshev–Lobatto grid, assembled as one numpy expression on the host and
placed on ``device``.

Bit order: the MPO equals ``W P_bitrev`` with ``W = (1/sqrt(N)) exp(-2 i pi
k n / N)``; its INPUT bits are read least significant first. Feed it a
little-endian state (:func:`ttnx_torch.ops.qtt.function_to_qtt_uniform`)
and the big-endian read-out of the result is the plain spectrum.
"""

from __future__ import annotations

import numpy as np
import torch

from ttnx_torch.core.tt import TTOperator, TTVector

__all__ = ["fourier_qtto", "reverse_qtt_bits", "cheb_lobatto_lagrange"]


def cheb_lobatto_lagrange(K: int):
    """The K + 1 Chebyshev–Lobatto nodes on [0, 1] and their barycentric
    weights (numpy)."""
    j = np.arange(K + 1)
    grid = 0.5 * (1 - np.cos(np.pi * j / K))
    w = np.where((j == 0) | (j == K), 0.5, 1.0) * ((-1.0) ** j)
    return grid, w


def _lagrange_eval_matrix(grid: np.ndarray, w: np.ndarray, xs: np.ndarray):
    """``L[alpha, m] = l_alpha(xs[m])`` by the barycentric formula, exact
    (a Kronecker delta) where ``xs[m]`` hits a node."""
    diff = xs[None, :] - grid[:, None]  # (K+1, m)
    hit = np.isclose(diff, 0.0, atol=1e-14, rtol=0.0)
    terms = np.where(hit, 0.0, w[:, None] / np.where(hit, 1.0, diff))
    denom = terms.sum(axis=0)
    L = terms / np.where(denom == 0, 1.0, denom)
    return np.where(hit.any(axis=0)[None, :], hit.astype(float), L)


def fourier_qtto(d: int, sign: float = -1.0, K: int = 25,
                 normalize: bool = True, *, device) -> TTOperator:
    """Rank-(K+1) complex128 MPO of the quantics DFT; the boundary cores
    sum or slice the bulk core; ``1/sqrt(2^d)`` normalization."""
    if d < 1:
        raise ValueError("d must be >= 1")
    grid, w = cheb_lobatto_lagrange(K)
    r = K + 1
    sigma = np.array([0, 1])
    tau = np.array([0, 1])
    xs = 0.5 * (sigma[:, None] + grid[None, :])  # (2, r)
    L = _lagrange_eval_matrix(grid, w, xs.reshape(-1)).reshape(r, 2, r)
    phase = np.exp(1j * np.pi * sign
                   * (sigma[:, None, None] + grid[None, :, None])
                   * tau[None, None, :])  # (2, r, 2)
    # bulk core A[alpha, sigma, tau, beta], layout (r_left, n_out, n_in,
    # r_right)
    A = np.einsum("asb,sbt->astb", L, phase)
    AL = A.sum(axis=0, keepdims=True)
    if d == 1:
        cores = [AL[:, :, :, 0:1]]
    else:
        cores = [AL] + [A] * (d - 2) + [A[:, :, :, 0:1]]
    if normalize:
        cores[0] = cores[0] / np.sqrt(2.0 ** d)
    return TTOperator([torch.as_tensor(c, dtype=torch.complex128,
                                       device=device) for c in cores])


def reverse_qtt_bits(x: TTVector) -> TTVector:
    """Reverse the site order (the bit-reversal companion of the quantics
    DFT): reversed cores with their bond axes swapped."""
    return TTVector([c.transpose(0, 2) for c in reversed(x.cores)],
                    tuple(reversed(x.ot)))
