"""Distributed tall-skinny QR (TSQR) and SVD over one mesh axis.

The panel factorization behind distributed TT orthogonalization and
rounding: the unfolded TT core ``(r*n, r')`` is row-sharded over the axis;
each rank QRs its block, the small ``R`` factors are all-gathered and
reduced by one more QR, and the thin Q factors multiply back locally — the
only communication is the ``p * r'^2`` gather of the R factors.

SPMD form of ``ttnx.parallel.tsqr``: every rank of the axis calls with its
own row block ``a_loc (m/p, k)`` (:func:`shard_rows` cuts it from the whole
matrix); ``q`` comes back as this rank's block, ``r``, ``s`` and ``vt``
whole on every rank. Every rank holds the same number of rows.

Sign convention: R's diagonal is made non-negative and the first column of
Vt non-negative, so the factors do not depend on the number of ranks.
"""

from __future__ import annotations

import torch

from ttnx_torch.core.linalg import thin_svd
from ttnx_torch.parallel.comm import (all_gather, axis_index, axis_size,
                                      local_block, psum)

__all__ = ["tsqr", "tsvd", "cholesky_qr2", "distributed_orthogonalize_core",
           "distributed_truncate_bond", "shard_rows"]


def _signfix(q, r):
    s = torch.sign(torch.diagonal(r))
    s = torch.where(s == 0, torch.ones_like(s), s)
    return q * s[None, :], r * s[:, None]


def shard_rows(a, mesh, axis: str = "dp"):
    """This rank's row block of ``a (m, k)`` over ``mesh[axis]`` (the twin
    of ``device_put`` with ``P(axis, None)``); ``m`` must divide."""
    return local_block(a, mesh, axis, 0)


def tsqr(a_loc, mesh, axis: str = "dp"):
    """QR of a row-sharded tall matrix: ``a_loc (m/p, k)`` is this rank's
    block of ``a (m, k)``. Returns ``(q_loc, r)``: this rank's block of
    ``q`` and the whole ``r`` (on every rank). Every block must be tall."""
    m_loc, k = a_loc.shape
    p = axis_size(mesh, axis)
    if m_loc < k:
        raise ValueError(
            f"TSQR needs each local block tall: m={m_loc * p} over {p} "
            f"ranks gives {m_loc} rows per block < k={k}")
    q1, r1 = _signfix(*torch.linalg.qr(a_loc))      # local block QR
    r_all = all_gather(r1, mesh, axis)              # (p*k, k)
    q2, r2 = _signfix(*torch.linalg.qr(r_all))      # replicated reduce
    idx = axis_index(mesh, axis)
    return q1 @ q2[idx * k:(idx + 1) * k], r2


def cholesky_qr2(a_loc, mesh, axis: str = "dp"):
    """QR of a row-sharded matrix by two rounds of CholeskyQR: each round
    is one local Gram product, one ``psum``, one small replicated Cholesky
    and one local triangular solve. Unlike :func:`tsqr` it needs no tall
    blocks (``m >= k`` over all ranks suffices, e.g. a ``(r*n, r)``
    unfolding with ``n = 2`` over 8 ranks). The second round repairs the
    first's ``kappa(a)^2 eps`` loss of orthogonality; for panels with
    ``kappa >~ 1e7`` in f64 use :func:`tsqr`. Returns ``(q_loc, r)``, ``r``
    with a non-negative diagonal."""
    m_loc, k = a_loc.shape
    m = m_loc * axis_size(mesh, axis)

    def cqr(x_loc):
        g = psum(x_loc.conj().T @ x_loc, mesh, axis)
        # a tiny shift keeps the Cholesky on the safe side of roundoff
        # without perturbing R beyond eps * ||a||^2
        eps = torch.finfo(x_loc.real.dtype).eps
        shift = 11 * (m * k + k * (k + 1)) * eps * torch.trace(g).real / k
        r = torch.linalg.cholesky(
            g + shift * torch.eye(k, dtype=g.dtype, device=g.device),
            upper=True)
        q_loc = torch.linalg.solve_triangular(r, x_loc, upper=True,
                                              left=False)
        return q_loc, r

    q1, r1 = cqr(a_loc)
    q2, r2 = cqr(q1)
    r = r2 @ r1
    s = torch.sign(torch.diagonal(r).real)
    s = torch.where(s == 0, torch.ones_like(s), s).to(r.dtype)
    return q2 * s[None, :], r * s[:, None]


def tsvd(a_loc, mesh, axis: str = "dp"):
    """Thin SVD of a row-sharded tall matrix via TSQR: the only collective
    is the R-factor gather of :func:`tsqr`; the ``k x k`` SVD runs
    replicated and ``U = Q U_R`` is a local product. Returns ``(u_loc, s,
    vt)``. The panel is TSQR when every block is tall (``m/p >= k``),
    CholeskyQR2 otherwise."""
    m_loc, k = a_loc.shape
    if m_loc >= k:
        q, r = tsqr(a_loc, mesh, axis)
    else:
        q, r = cholesky_qr2(a_loc, mesh, axis)
    u_r, s, vt = thin_svd(r)
    # first column of vt non-negative: factors independent of the number
    # of ranks (the SVD of the replicated R is the same on every rank)
    sgn = torch.sign(vt[:, 0])
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    return q @ (u_r * sgn[None, :]), s, vt * sgn[:, None]


def distributed_truncate_bond(theta_loc, mesh, rel_tol: float = 0.0,
                              max_bond: int | None = None, axis: str = "dp"):
    """Truncated factorization of a row-sharded bond matrix ``theta (m,
    k)`` -> ``(left_loc, right, keep)``: ``left = U S`` masked (this rank's
    rows), ``right = Vt`` masked and ``keep`` the 0/1 mask over the ``k``
    singular directions. Shapes are static: truncation is the mask.

    Keep rule: drop the largest tail with ``sum(tail^2) <= rel_tol^2
    ||s||^2``, capped at ``max_bond``; the first direction always stays."""
    k = theta_loc.shape[1]
    u, s, vt = tsvd(theta_loc, mesh, axis)
    tail = torch.cumsum(torch.flip(s * s, (0,)), 0)
    tol2 = (rel_tol * rel_tol) * torch.sum(s * s)
    keep = torch.flip(tail > tol2, (0,)).to(s.dtype)
    if max_bond is not None and max_bond < k:
        keep = keep * (torch.arange(k, device=s.device) < max_bond).to(
            s.dtype)
    keep[0] = 1.0
    left = u * (s * keep).to(u.dtype)[None, :]
    right = vt * keep.to(vt.dtype)[:, None]
    return left, right, keep


def distributed_orthogonalize_core(core_loc, mesh, axis: str = "dp"):
    """Left-orthogonalize one padded TT core ``(R, n, R')`` whose ``(R*n,
    R')`` unfolding is row-sharded: ``core_loc`` holds this rank's rows of
    the unfolding as ``(rows / n, n, R')``. Returns ``(q_core_loc,
    transfer)``: this rank's rows of the orthogonal core, and the
    triangular transfer to absorb into the next core (on every rank)."""
    Rl, n, Rr = core_loc.shape
    q, r = tsqr(core_loc.reshape(Rl * n, Rr), mesh, axis)
    return q.reshape(Rl, n, Rr), r
