"""DMRG-style N-site sweep solvers (N = 1 single-site, N = 2 two-site
default) — the eager tier.

Twin of ``ttnx.solvers.dmrg``. The N-site window operator is contracted
once per window and the local problem is the ALS local problem of
:mod:`ttnx_torch.solvers.als` with a merged physical index. Local solves
are dense ``torch.linalg`` calls below ``itslv_thresh`` and iterative
above it: conjugate gradients on the symmetrized matrix-free operator for
linear systems, LOBPCG for eigenproblems (both from
:mod:`ttnx_torch.core.linalg`, with JAX's stopping rules). The splits are
:func:`ttnx_torch.core.linalg.thin_svd`; the singular values come to the
host for the cut-off, as in the reference.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ttnx_torch.core.canonical import orthogonalize
from ttnx_torch.core.linalg import cg, thin_svd
from ttnx_torch.core.tt import TTOperator, TTVector, increase_ranks
from ttnx_torch.solvers.als import (_cast, _hermitian, _ones_env, _ones_env2,
                                    _promote, _rel_residual, init_right_envs,
                                    init_right_envs_b, lobpcg_eigmin,
                                    local_matrix, local_matvec, local_rhs,
                                    update_left_env, update_left_env_b,
                                    update_right_env, update_right_env_b)

__all__ = ["dmrg_linsolve", "dmrg_eigsolve", "cut_off_index"]


def cut_off_index(s: np.ndarray, tol: float, degen_tol: float = 1e-10) -> int:
    """Relative SVD cutoff that refuses to split near-degenerate singular
    values."""
    k = int(np.sum(s > np.linalg.norm(s) * tol))
    k = max(k, 1)
    while k < s.size and np.isclose(s[k - 1], s[k], rtol=degen_tol,
                                    atol=degen_tol):
        k += 1
    return k


def _amid(A: TTOperator, i: int, n_sites: int):
    """Operator cores ``i .. i+n_sites-1`` contracted into ``(r_A, n^N,
    n^N, r_A')`` with big-endian merged indices."""
    out = A.cores[i]
    for k in range(i + 1, i + n_sites):
        a, bcore = out, A.cores[k]
        r, ni, mi, _ = a.shape
        _, nk, mk, rn = bcore.shape
        out = torch.einsum("aijb,bklc->aikjlc", a, bcore).reshape(
            r, ni * nk, mi * mk, rn)
    return out


def _merge(out, nxt):
    """``(r, m, s) x (s, k, t) -> (r, m k, t)``."""
    r, m, _ = out.shape
    _, nk, rn = nxt.shape
    return torch.einsum("aib,bjc->aijc", out, nxt).reshape(r, m * nk, rn)


def _bmid(b: TTVector, i: int, n_sites: int):
    out = b.cores[i]
    for k in range(i + 1, i + n_sites):
        out = _merge(out, b.cores[k])
    return out


def _local_solve(L, Am, R, Lb, bm, Rb, v0, it_solver, itslv_thresh, maxiter,
                 tol):
    """N-site local linear solve: dense below the threshold, CG on the
    Hermitian part ``(K + K^H) / 2`` of the matrix-free local operator
    above it. ``K^H`` swaps each environment's outer legs and the window
    operator's physical legs; ttnx also reverses the operator's bond legs
    there, which applies another operator (ROADMAP C)."""
    pb = local_rhs(Lb, bm, Rb)
    if it_solver and pb.numel() > itslv_thresh:
        L_adj = L.permute(2, 1, 0).conj()
        A_adj = Am.permute(0, 2, 1, 3).conj()
        R_adj = R.permute(2, 1, 0).conj()

        def op(v):
            return 0.5 * (local_matvec(L, Am, R, v)
                          + local_matvec(L_adj, A_adj, R_adj, v))

        v, _ = cg(op, pb, x0=v0, tol=tol, maxiter=maxiter)
        return v
    K = local_matrix(L, Am, R)
    return torch.linalg.solve(K, pb.reshape(-1)).reshape(pb.shape)


def _local_eigmin(L, Am, R, v0, it_solver, itslv_thresh, maxiter, tol):
    """N-site smallest eigenpair: LOBPCG for real problems above the
    threshold (and ``M > 4``), dense ``eigh`` otherwise."""
    shape = v0.shape
    m = v0.numel()
    K = _hermitian(local_matrix(L, Am, R))
    if it_solver and m > itslv_thresh and not v0.is_complex() and m > 4:
        return lobpcg_eigmin(K, v0, maxiter, tol)
    w, U = torch.linalg.eigh(K)
    return w[0], U[:, 0].reshape(shape)


def _split_window_right(V, dims_window, tol, rmax, verbose=False):
    """Split the first site off the window solution ``V`` of shape ``(r_l,
    prod(dims_window), r_r)`` moving right: a left-orthonormal core and
    the transported remainder."""
    rl, _, rr = V.shape
    n0 = dims_window[0]
    rest = int(np.prod(dims_window[1:])) if len(dims_window) > 1 else 1
    u, s, vt = thin_svd(V.reshape(rl * n0, rest * rr))
    s_host = s.detach().cpu().numpy()
    keep = min(cut_off_index(s_host, tol), rmax)
    if verbose:
        _log_keep(s_host, keep, rmax)
    core = u[:, :keep].reshape(rl, n0, keep)
    v_move = (s[:keep, None].to(vt.dtype) * vt[:keep, :]).reshape(
        keep, rest, rr)
    return core, v_move, keep


def _split_window_left(V, dims_window, tol, rmax, verbose=False):
    """Split the last site off moving left."""
    rl, _, rr = V.shape
    nl = dims_window[-1]
    rest = int(np.prod(dims_window[:-1])) if len(dims_window) > 1 else 1
    u, s, vt = thin_svd(V.reshape(rl * rest, nl * rr))
    s_host = s.detach().cpu().numpy()
    keep = min(cut_off_index(s_host, tol), rmax)
    if verbose:
        _log_keep(s_host, keep, rmax)
    core = vt[:keep, :].reshape(keep, nl, rr)
    v_move = (u[:, :keep] * s[None, :keep].to(u.dtype)).reshape(rl, rest,
                                                                 keep)
    return core, v_move, keep


def _log_keep(s_host, keep, rmax):
    total = np.linalg.norm(s_host)
    print(f"  rank={keep} rmax={rmax} discarded_weight="
          f"{(total - np.linalg.norm(s_host[:keep])) / total:.3e}")


def _finalize_window(cores, V, dims_window, tol, rmax):
    """Write the final window solution at sites ``0..N-1`` back as cores,
    right-orthogonalizing all inner bonds."""
    n_sites = len(dims_window)
    if n_sites == 1:
        cores[0] = V
        return
    cur = V  # (1, prod(dims), r)
    for j in range(n_sites - 1, 0, -1):
        core, cur, _ = _split_window_left(cur, dims_window[: j + 1], tol, rmax)
        cores[j] = core
    cores[0] = cur.reshape(1, dims_window[0], -1)


def _default_rmax(dims) -> int:
    return int(math.isqrt(int(np.prod(dims))))


def _run_dmrg(A, x0, n_sites, tol, sweep_schedule, rmax_schedule, it_solver,
              maxiter, lin_tol, itslv_thresh, verbose, b=None,
              collect_energy=False):
    """Shared DMRG sweep driver for linsolve (``b`` given) and eigsolve."""
    d = A.N
    rmax = max(rmax_schedule)
    if n_sites == 1 and rmax > max(x0.ranks):
        x0 = increase_ranks(x0, rmax)
    x = orthogonalize(x0, 0)
    dt = _promote(A, x, *([b] if b is not None else []))
    x, A = _cast(x, dt), _cast(A, dt)
    if b is not None:
        b = _cast(b, dt)
    dev = x.device
    dims = x.dims
    cores = list(x.cores)
    rks = list(x.ranks)

    n_windows = d + 1 - n_sites
    amids = [_amid(A, i, n_sites) for i in range(n_windows)]
    bmids = ([_bmid(b, i, n_sites) for i in range(n_windows)]
             if b is not None else None)

    R = init_right_envs(x, A)
    L = [None] * (d + 1)
    L[0] = _ones_env(dt, dev)
    if b is not None:
        Rb = init_right_envs_b(x, b)
        Lb = [None] * (d + 1)
        Lb[0] = _ones_env2(dt, dev)

    E: list[float] = []
    r_hist: list[int] = []
    warm = None  # transported warm start for the next window

    def window_guess(i):
        if warm is not None:
            return warm
        out = cores[i]
        for k in range(i + 1, i + n_sites):
            out = _merge(out, cores[k])
        return out

    def solve_window(i):
        v0 = window_guess(i)
        if b is not None:
            return _local_solve(L[i], amids[i], R[i + n_sites], Lb[i],
                                bmids[i], Rb[i + n_sites], v0, it_solver,
                                itslv_thresh, maxiter, lin_tol)
        lam, V = _local_eigmin(L[i], amids[i], R[i + n_sites], v0, it_solver,
                               itslv_thresh, maxiter, lin_tol)
        E.append(float(lam.real))
        return V

    nsweeps = 0
    i_schedule = 0
    while i_schedule < len(sweep_schedule):
        nsweeps += 1
        if nsweeps == sweep_schedule[i_schedule]:
            i_schedule += 1
            if i_schedule >= len(sweep_schedule):
                # final completion solve at window 0
                V = solve_window(0)
                if collect_energy:
                    r_hist.append(max(rks))
                _finalize_window(cores, V, dims[:n_sites], tol,
                                 rmax_schedule[-1])
                out = TTVector(cores, [0] + [-1] * (d - 1))
                return out, E, r_hist
        stage_rmax = rmax_schedule[i_schedule]

        for i in range(n_windows - 1):  # forward half sweep
            V = solve_window(i)
            core, v_move, keep = _split_window_right(
                V, dims[i: i + n_sites], tol, stage_rmax, verbose)
            cores[i] = core
            rks[i + 1] = keep
            # transported warm start: remainder x next core to the right
            warm = _merge(v_move, cores[i + n_sites])
            L[i + 1] = update_left_env(L[i], cores[i], A.cores[i])
            if b is not None:
                Lb[i + 1] = update_left_env_b(Lb[i], cores[i], b.cores[i])
            r_hist.append(max(rks))

        # the forward pass's last `warm` is the guess of the first backward
        # window: cores right of the forward frontier are stale
        for i in range(n_windows - 1, 0, -1):  # backward half sweep
            V = solve_window(i)
            core, v_move, keep = _split_window_left(
                V, dims[i: i + n_sites], tol, stage_rmax, verbose)
            j = i + n_sites - 1
            cores[j] = core
            rks[j] = keep
            # transported warm start: previous core x remainder
            warm = _merge(cores[i - 1], v_move)
            R[j] = update_right_env(R[j + 1], cores[j], A.cores[j])
            if b is not None:
                Rb[j] = update_right_env_b(Rb[j + 1], cores[j], b.cores[j])
            r_hist.append(max(rks))
        # after the backward pass `warm` targets window 0: the next forward
        # (or final completion) solve

    return TTVector(cores), E, r_hist


def _schedules(x0, config, n_sites, tol, sweep_schedule, rmax_schedule,
               it_solver, linsolv_maxiter, itslv_thresh, linsolv_tol):
    """The options after ``config`` (a
    :class:`ttnx_torch.config.DMRGConfig`) and the defaults."""
    if config is not None:
        n_sites, tol = config.n_sites, config.tol
        sweep_schedule = list(config.sweep_schedule)
        rmax_schedule = (list(config.rmax_schedule)
                         if config.rmax_schedule is not None else None)
        it_solver = config.it_solver
        linsolv_maxiter = config.linsolv_maxiter
        itslv_thresh = config.itslv_thresh
    if sweep_schedule is None:
        sweep_schedule = [2]
    if rmax_schedule is None:
        rmax_schedule = [_default_rmax(x0.dims)]
    if len(rmax_schedule) != len(sweep_schedule):
        raise ValueError("Sweep schedule error")
    if linsolv_tol is None:
        linsolv_tol = max(math.sqrt(tol), 1e-8)
    return (n_sites, tol, sweep_schedule, rmax_schedule, it_solver,
            linsolv_maxiter, linsolv_tol, itslv_thresh)


def dmrg_linsolve(A: TTOperator, b: TTVector, x0: TTVector, n_sites: int = 2,
                  tol: float = 1e-12, sweep_schedule=None, rmax_schedule=None,
                  it_solver: bool = True, linsolv_maxiter: int = 200,
                  linsolv_tol: float | None = None, itslv_thresh: int = 256,
                  return_info: bool = False, verbose: bool = False,
                  config=None, telemetry=None):
    """Solve ``A x = b`` with N-site DMRG sweeps. ``config``
    (:class:`ttnx_torch.config.DMRGConfig`) overrides the option defaults;
    ``telemetry`` collects rank history, solve counts and wall time."""
    t_start = time.perf_counter()
    opts = _schedules(x0, config, n_sites, tol, sweep_schedule,
                      rmax_schedule, it_solver, linsolv_maxiter,
                      itslv_thresh, linsolv_tol)
    (n_sites, tol, sweep_schedule, rmax_schedule, it_solver,
     linsolv_maxiter, linsolv_tol, itslv_thresh) = opts
    out, _, r_hist = _run_dmrg(A, x0, n_sites, tol, sweep_schedule,
                               rmax_schedule, it_solver, linsolv_maxiter,
                               linsolv_tol, itslv_thresh, verbose, b=b)
    if telemetry is not None or return_info:
        res = _rel_residual(_cast(A, out.dtype), out, _cast(b, out.dtype))
    if telemetry is not None:
        telemetry.local_solves += len(r_hist)
        telemetry.max_ranks.extend(int(r) for r in r_hist)
        telemetry.record_sweep(residual=res)
        telemetry.wall_seconds += time.perf_counter() - t_start
    if return_info:
        return out, {"residual": res}
    return out


def dmrg_eigsolve(A: TTOperator, x0: TTVector, n_sites: int = 2,
                  tol: float = 1e-12, sweep_schedule=None, rmax_schedule=None,
                  it_solver: bool = False, linsolv_maxiter: int = 200,
                  linsolv_tol: float | None = None, itslv_thresh: int = 256,
                  verbose: bool = False, config=None, telemetry=None):
    """Lowest eigenpair by N-site DMRG; returns ``(E, x, r_hist)`` (host
    numpy histories). ``config`` (:class:`ttnx_torch.config.DMRGConfig`)
    overrides the option defaults; ``telemetry`` collects energy and rank
    histories and wall time."""
    t_start = time.perf_counter()
    opts = _schedules(x0, config, n_sites, tol, sweep_schedule,
                      rmax_schedule, it_solver, linsolv_maxiter,
                      itslv_thresh, linsolv_tol)
    (n_sites, tol, sweep_schedule, rmax_schedule, it_solver,
     linsolv_maxiter, linsolv_tol, itslv_thresh) = opts
    out, E, r_hist = _run_dmrg(A, x0, n_sites, tol, sweep_schedule,
                               rmax_schedule, it_solver, linsolv_maxiter,
                               linsolv_tol, itslv_thresh, verbose,
                               collect_energy=True)
    if telemetry is not None:
        telemetry.local_solves += len(r_hist)
        telemetry.energies.extend(float(e) for e in E)
        telemetry.max_ranks.extend(int(r) for r in r_hist)
        telemetry.wall_seconds += time.perf_counter() - t_start
    return np.asarray(E), out, np.asarray(r_hist)
