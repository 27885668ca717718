"""MALS (modified ALS): two-site sweeps with bond-adaptive rank truncation —
the eager tier.

Twin of ``ttnx.solvers.mals``. Reuses the three-leg environments of
:mod:`ttnx_torch.solvers.als`; each two-site local problem is a dense
``torch.linalg`` solve or ``eigh`` (LOBPCG above the threshold) and each
split one :func:`ttnx_torch.core.linalg.thin_svd`. The singular values
come to the host for the relative discarded-weight rule, as in the
reference.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ttnx_torch.core.canonical import orthogonalize
from ttnx_torch.core.linalg import thin_svd
from ttnx_torch.core.tt import TTOperator, TTVector
from ttnx_torch.solvers.als import (_cast, _hermitian, _ones_env, _ones_env2,
                                    _promote, _rel_residual, init_right_envs,
                                    init_right_envs_b, lobpcg_eigmin,
                                    update_left_env, update_left_env_b,
                                    update_right_env, update_right_env_b)

__all__ = ["mals_linsolve", "mals_eigsolve", "sv_trunc_count"]


def sv_trunc_count(s: np.ndarray, tol: float) -> int:
    """Number of singular values kept by the relative discarded-weight rule:
    drop the largest trailing block whose squared weight stays strictly below
    ``tol * ||s||^2``."""
    if tol == 0.0:
        return s.size
    norm2 = float((s ** 2).sum())
    tails = np.cumsum(s[::-1] ** 2)  # tails[k-1] = sum of smallest k squares
    discard = int(np.searchsorted(tails, tol * norm2, side="left"))
    return max(s.size - discard, 1)


def _local2_matrix(L, Ai, Aj, R):
    """Dense two-site operator ``K[(a,i,j,c),(b,I,J,d)]``."""
    t = torch.einsum("aWb,WiIw->abiIw", L, Ai)
    t = torch.einsum("abiIw,wjJv->abiIjJv", t, Aj)
    k = torch.einsum("abiIjJv,cvd->aijcbIJd", t, R)
    m = k.shape[0] * k.shape[1] * k.shape[2] * k.shape[3]
    return k.reshape(m, m)


def _local2_rhs(Lb, bi, bj, Rb):
    t = torch.einsum("au,uiv->aiv", Lb, bi)
    t = torch.einsum("aiv,vjw->aijw", t, bj)
    return torch.einsum("aijw,cw->aijc", t, Rb)


def _keep(s, tol, rmax):
    return min(sv_trunc_count(s.detach().cpu().numpy(), tol), rmax)


def _split_right(V, tol, rmax):
    """SVD split of the two-site solution moving right: site i
    left-orthogonal, ``S Vt`` absorbed right."""
    rl, n1, n2, rr = V.shape
    u, s, vt = thin_svd(V.reshape(rl * n1, n2 * rr))
    keep = _keep(s, tol, rmax)
    ci = u[:, :keep].reshape(rl, n1, keep)
    cj = (s[:keep, None].to(vt.dtype) * vt[:keep, :]).reshape(keep, n2, rr)
    return ci, cj


def _split_left(V, tol, rmax):
    """SVD split moving left: ``U S`` absorbed left, site j
    right-orthogonal."""
    rl, n1, n2, rr = V.shape
    u, s, vt = thin_svd(V.reshape(rl * n1, n2 * rr))
    keep = _keep(s, tol, rmax)
    ci = (u[:, :keep] * s[None, :keep].to(u.dtype)).reshape(rl, n1, keep)
    cj = vt[:keep, :].reshape(keep, n2, rr)
    return ci, cj


def _default_rmax(dims) -> int:
    return int(round(math.sqrt(float(np.prod(dims)))))


def _two_site_solve(L, Ai, Aj, R, Lb, bi, bj, Rb):
    K = _local2_matrix(L, Ai, Aj, R)
    pb = _local2_rhs(Lb, bi, bj, Rb)
    return torch.linalg.solve(K, pb.reshape(-1)).reshape(pb.shape)


def mals_linsolve(A: TTOperator, b: TTVector, x0: TTVector, tol: float = 1e-12,
                  rmax: int | None = None, return_info: bool = False,
                  config=None, telemetry=None):
    """Solve ``A x = b`` with one forward + one backward two-site sweep, bond
    ranks adapting to ``tol`` under the ``rmax`` cap. ``config``
    (:class:`ttnx_torch.config.MALSConfig`) overrides the option defaults;
    ``telemetry`` collects residual and rank history and wall time."""
    if config is not None:
        tol = config.tol
        rmax = config.rmax
        return_info = config.return_info
    t_start = time.perf_counter()
    d = A.N
    if rmax is None:
        rmax = _default_rmax(x0.dims)
    x = orthogonalize(x0, 0)
    dt = _promote(A, b, x)
    x, A, b = _cast(x, dt), _cast(A, dt), _cast(b, dt)
    dev = x.device
    cores = list(x.cores)

    R = init_right_envs(x, A)
    Rb = init_right_envs_b(x, b)
    L = [None] * (d + 1)
    L[0] = _ones_env(dt, dev)
    Lb = [None] * (d + 1)
    Lb[0] = _ones_env2(dt, dev)

    def record():
        if telemetry is not None:
            telemetry.local_solves += 1
            telemetry.record_sweep(max_rank=max(TTVector(cores).ranks))

    for i in range(d - 1):  # forward half sweep
        V = _two_site_solve(L[i], A.cores[i], A.cores[i + 1], R[i + 2],
                            Lb[i], b.cores[i], b.cores[i + 1], Rb[i + 2])
        cores[i], cores[i + 1] = _split_right(V, tol, rmax)
        L[i + 1] = update_left_env(L[i], cores[i], A.cores[i])
        Lb[i + 1] = update_left_env_b(Lb[i], cores[i], b.cores[i])
        record()

    for i in range(d - 2, -1, -1):  # backward half sweep
        V = _two_site_solve(L[i], A.cores[i], A.cores[i + 1], R[i + 2],
                            Lb[i], b.cores[i], b.cores[i + 1], Rb[i + 2])
        cores[i], cores[i + 1] = _split_left(V, tol, rmax)
        R[i + 1] = update_right_env(R[i + 2], cores[i + 1], A.cores[i + 1])
        Rb[i + 1] = update_right_env_b(Rb[i + 2], cores[i + 1], b.cores[i + 1])
        record()

    out = TTVector(cores)
    if telemetry is not None:
        telemetry.record_sweep(residual=_rel_residual(A, out, b))
        telemetry.wall_seconds += time.perf_counter() - t_start
    if return_info:
        return out, {"residual": _rel_residual(A, out, b)}
    return out


def _local2_eigmin(L, Ai, Aj, R, v0, it_solver=False, itslv_thresh=256,
                   maxiter=200, tol=1e-8):
    """Two-site smallest eigenpair: LOBPCG when asked or above the
    threshold (and ``M > 4``), dense ``eigh`` otherwise."""
    shape = v0.shape
    m = v0.numel()
    K = _hermitian(_local2_matrix(L, Ai, Aj, R))
    if (it_solver or m > itslv_thresh) and m > 4:
        return lobpcg_eigmin(K, v0, maxiter, tol)
    w, U = torch.linalg.eigh(K)
    return w[0], U[:, 0].reshape(shape)


def mals_eigsolve(A: TTOperator, x0: TTVector, tol: float = 1e-12,
                  sweep_schedule=None, rmax_schedule=None,
                  it_solver: bool = False, linsolv_maxiter: int = 200,
                  linsolv_tol: float | None = None, itslv_thresh: int = 256,
                  telemetry=None):
    """Smallest eigenpair by two-site MALS with bond-adaptive ranks; returns
    ``(E, x, r_hist)`` (host numpy histories)."""
    if sweep_schedule is None:
        sweep_schedule = [2]
    if rmax_schedule is None:
        rmax_schedule = [_default_rmax(x0.dims)]
    if len(rmax_schedule) != len(sweep_schedule):
        raise ValueError("Sweep schedule error")
    if linsolv_tol is None:
        linsolv_tol = max(math.sqrt(tol), 1e-8)

    t_start = time.perf_counter()
    d = A.N
    x = orthogonalize(x0, 0)
    dt = _promote(A, x)
    x, A = _cast(x, dt), _cast(A, dt)
    cores = list(x.cores)
    E: list[float] = []
    r_hist: list[int] = []

    R = init_right_envs(x, A)
    L = [None] * (d + 1)
    L[0] = _ones_env(dt, x.device)

    def solve(i):
        guess = torch.einsum("anb,bmc->anmc", cores[i], cores[i + 1])
        lam, V = _local2_eigmin(L[i], A.cores[i], A.cores[i + 1], R[i + 2],
                                guess, it_solver=it_solver,
                                itslv_thresh=itslv_thresh,
                                maxiter=linsolv_maxiter, tol=linsolv_tol)
        E.append(float(lam.real))
        return V

    def record():
        r_hist.append(max(TTVector(cores).ranks))
        if telemetry is not None:
            telemetry.local_solves += 1
            telemetry.record_sweep(energy=E[-1], max_rank=r_hist[-1])

    nsweeps = 0
    i_schedule = 0
    while i_schedule < len(sweep_schedule):
        nsweeps += 1
        if nsweeps == sweep_schedule[i_schedule]:
            i_schedule += 1
            if i_schedule >= len(sweep_schedule):
                break
        rmax = rmax_schedule[i_schedule]

        for i in range(d - 1):  # forward
            V = solve(i)
            cores[i], cores[i + 1] = _split_right(V, tol, rmax)
            record()
            L[i + 1] = update_left_env(L[i], cores[i], A.cores[i])

        for i in range(d - 2, -1, -1):  # backward
            V = solve(i)
            cores[i], cores[i + 1] = _split_left(V, tol, rmax)
            record()
            R[i + 1] = update_right_env(R[i + 2], cores[i + 1], A.cores[i + 1])

    if telemetry is not None:
        telemetry.wall_seconds += time.perf_counter() - t_start
    return np.asarray(E), TTVector(cores), np.asarray(r_hist)
