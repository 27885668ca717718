"""ALS (alternating linear scheme) solvers: linear systems, eigenproblems,
generalized eigenproblems — the eager tier.

Twin of ``ttnx.solvers.als`` (Holtz–Rohwedder–Schneider one-site ALS with
fixed ranks). The environments are the symmetric three-leg ``L_i / R_i``
of shape ``(r_x, r_A, r_x)``; every contraction is written as pairwise
einsums. Local solves are dense ``torch.linalg`` calls on the device of the
inputs; the eigensolve takes LOBPCG (:func:`ttnx_torch.core.linalg.
lobpcg_standard`, a port of JAX's) above ``itslv_thresh`` when asked, and
the generalized pencil is reduced by a Cholesky factor of the metric on
the device. Energies are read to the host once a local solve, as the
reference does. No kernel serves this tier.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ttnx_torch.core.algebra import matvec, norm, sub
from ttnx_torch.core.canonical import orthogonalize
from ttnx_torch.core.linalg import lobpcg_standard
from ttnx_torch.core.tt import TTOperator, TTVector, increase_ranks

__all__ = ["als_linsolve", "als_eigsolve", "als_gen_eigsolv"]


# ---------------------------------------------------------------------------
# Environments
# ---------------------------------------------------------------------------


def _ones_env(dtype, device):
    return torch.ones((1, 1, 1), dtype=dtype, device=device)


def _ones_env2(dtype, device):
    return torch.ones((1, 1), dtype=dtype, device=device)


def _promote(*tts):
    """Common dtype of TT objects (``jnp.result_type`` under x64: float32
    inputs stay float32)."""
    dt = tts[0].dtype
    for t in tts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _cast(tt, dtype):
    return tt.astype(dtype) if tt.dtype != dtype else tt


def update_left_env(L, xc, Ac):
    """``L_{i+1}[c,w,d] = conj(x)[a,i,c] L[a,W,b] A[W,i,j,w] x[b,j,d]``."""
    t = torch.einsum("aic,aWb->icWb", xc.conj(), L)
    t = torch.einsum("icWb,Wijw->cbjw", t, Ac)
    return torch.einsum("cbjw,bjd->cwd", t, xc)


def update_right_env(R, xc, Ac):
    """``R_i[a,W,b] = conj(x)[a,i,p] A[W,i,j,w] x[b,j,q] R[p,w,q]``."""
    t = torch.einsum("bjq,pwq->bjpw", xc, R)
    t = torch.einsum("Wijw,bjpw->Wibp", Ac, t)
    return torch.einsum("aip,Wibp->aWb", xc.conj(), t)


def update_left_env_b(Lb, xc, bc):
    """``Lb_{i+1}[p,v] = conj(x)[a,i,p] Lb[a,u] b[u,i,v]``."""
    t = torch.einsum("au,uiv->aiv", Lb, bc)
    return torch.einsum("aip,aiv->pv", xc.conj(), t)


def update_right_env_b(Rb, xc, bc):
    """``Rb_i[a,u] = conj(x)[a,i,p] b[u,i,v] Rb[p,v]``."""
    t = torch.einsum("uiv,pv->uip", bc, Rb)
    return torch.einsum("aip,uip->au", xc.conj(), t)


def init_right_envs(x: TTVector, A: TTOperator):
    """All right environments ``R_i`` (sites ``i..d-1`` contracted)."""
    d = x.N
    R = [None] * (d + 1)
    R[d] = _ones_env(x.dtype, x.device)
    for i in range(d - 1, 0, -1):
        R[i] = update_right_env(R[i + 1], x.cores[i], A.cores[i])
    return R


def init_right_envs_b(x: TTVector, b: TTVector):
    d = x.N
    Rb = [None] * (d + 1)
    Rb[d] = _ones_env2(x.dtype, x.device)
    for i in range(d - 1, 0, -1):
        Rb[i] = update_right_env_b(Rb[i + 1], x.cores[i], b.cores[i])
    return Rb


# ---------------------------------------------------------------------------
# Local problems
# ---------------------------------------------------------------------------


def local_matrix(L, Ac, R):
    """Dense local operator ``K[(a,i,c), (b,j,d)]``."""
    t = torch.einsum("aWb,WiJw->abiJw", L, Ac)
    k = torch.einsum("abiJw,cwd->aicbJd", t, R)
    m = k.shape[0] * k.shape[1] * k.shape[2]
    return k.reshape(m, m)


def local_rhs(Lb, bc, Rb):
    t = torch.einsum("au,uiv->aiv", Lb, bc)
    return torch.einsum("aiv,cv->aic", t, Rb)


def local_matvec(L, Ac, R, V):
    """Matrix-free local operator application."""
    t = torch.einsum("bJd,cwd->bJcw", V, R)
    t = torch.einsum("WiJw,bJcw->Wibc", Ac, t)
    return torch.einsum("aWb,Wibc->aic", L, t)


def _local_solve(L, Ac, R, Lb, bc, Rb):
    pb = local_rhs(Lb, bc, Rb)
    K = local_matrix(L, Ac, R)
    return torch.linalg.solve(K, pb.reshape(-1)).reshape(pb.shape)


def _hermitian(K):
    return 0.5 * (K + K.conj().T)


def lobpcg_eigmin(K, v0, maxiter, tol):
    """Smallest eigenpair of the Hermitian ``K`` by LOBPCG on ``sigma I -
    K`` (``sigma = ||K||_1`` bounds the spectrum), starting from ``v0``.
    Complex ``K = A + iB`` is embedded as the real symmetric ``[[A, -B],
    [B, A]]``, whose spectrum doubles K's; the eigenvector halves
    recombine as ``x_re + i x_im``."""
    shape = v0.shape
    m = v0.numel()
    if v0.is_complex():
        Kr = torch.cat([torch.cat([K.real, -K.imag], 1),
                        torch.cat([K.imag, K.real], 1)], 0)
        w0 = torch.cat([v0.reshape(m).real, v0.reshape(m).imag])
        sigma = torch.linalg.matrix_norm(Kr, ord=1)
        shifted = sigma * torch.eye(2 * m, dtype=Kr.dtype,
                                    device=Kr.device) - Kr
        theta, U, _ = lobpcg_standard(shifted, w0[:, None], m=maxiter,
                                      tol=tol)
        x = torch.complex(U[:m, 0], U[m:, 0])
        x = x / torch.linalg.vector_norm(x)
        return sigma - theta[0], x.to(v0.dtype).reshape(shape)
    sigma = torch.linalg.matrix_norm(K, ord=1)
    shifted = sigma * torch.eye(m, dtype=K.dtype, device=K.device) - K
    theta, U, _ = lobpcg_standard(shifted, v0.reshape(m, 1), m=maxiter,
                                  tol=tol)
    return sigma - theta[0], U[:, 0].reshape(shape)


def _local_eigmin(L, Ac, R, v0, it_solver=False, itslv_thresh=1024,
                  maxiter=200, tol=1e-8):
    """Smallest eigenpair of the local operator: dense ``eigh`` below the
    threshold, LOBPCG above it (complex Hermitian through the real
    embedding)."""
    shape = v0.shape
    K = _hermitian(local_matrix(L, Ac, R))
    if it_solver and v0.numel() > itslv_thresh:
        return lobpcg_eigmin(K, v0, maxiter, tol)
    w, U = torch.linalg.eigh(K)
    return w[0], U[:, 0].reshape(shape)


def _local_gen_eigmin(L, Ac, R, Ls, Sc, Rs, v0):
    """Smallest eigenpair of the pencil ``(K, S)``, on the device: with
    ``S = C C^H`` (Cholesky), ``eigh(C^{-1} K C^{-H})`` and ``x = C^{-H}
    v``, which has ``x^H S x = 1`` as ``scipy.linalg.eigh(K, S)`` gives
    it."""
    shape = v0.shape
    K = _hermitian(local_matrix(L, Ac, R))
    S = _hermitian(local_matrix(Ls, Sc, Rs))
    C = torch.linalg.cholesky(S)
    Y = torch.linalg.solve_triangular(C, K, upper=False)
    red = torch.linalg.solve_triangular(C, Y.conj().T, upper=False).conj().T
    w, V = torch.linalg.eigh(_hermitian(red))
    x = torch.linalg.solve_triangular(C.conj().T, V[:, :1], upper=True)
    return float(w[0]), x.reshape(shape)


# ---------------------------------------------------------------------------
# Core moves (QR-based, rank-preserving)
# ---------------------------------------------------------------------------


def _move_right(cores, i, V):
    """Site i becomes the left-orthogonal factor of V; R goes into site
    i+1."""
    rl, n, rr = V.shape
    q, r = torch.linalg.qr(V.reshape(rl * n, rr))
    cores[i] = q.reshape(rl, n, -1)
    cores[i + 1] = torch.einsum("ab,bnc->anc", r, cores[i + 1])


def _move_left(cores, i, V):
    """Site i becomes the right-orthogonal factor of V; L goes into site
    i-1."""
    rl, n, rr = V.shape
    qt, rt = torch.linalg.qr(V.reshape(rl, n * rr).T)
    cores[i] = qt.T.reshape(-1, n, rr)
    cores[i - 1] = torch.einsum("anb,bc->anc", cores[i - 1], rt.T)


def _rel_residual(A, x, b):
    eps = torch.finfo(b.cores[0].real.dtype).eps
    return float(norm(sub(matvec(A, x), b)) / max(float(norm(b)), eps))


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def als_linsolve(A: TTOperator, b: TTVector, x0: TTVector, sweep_count: int = 2,
                 it_solver: bool = False, r_itsolver: int = 5000,
                 return_info: bool = False, config=None, telemetry=None):
    """Solve ``A x = b`` with fixed ranks taken from ``x0``.

    ``sweep_count`` counts half-sweeps: 2 = one forward + one backward;
    odd values end after a forward pass. ``config``
    (:class:`ttnx_torch.config.ALSConfig`) overrides the option defaults;
    ``telemetry`` (:class:`ttnx_torch.utils.profiling.SolverTelemetry`)
    collects per-half-sweep residuals, ranks, local-solve counts and wall
    time (one extra MPO·MPS and norm a half sweep).
    """
    del it_solver, r_itsolver  # dense local solves
    if config is not None:
        sweep_count = config.sweep_count
        return_info = config.return_info
    t_start = time.perf_counter()
    d = A.N
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

    def _telemetry_sweep():
        if telemetry is None:
            return
        cur = TTVector(cores)
        telemetry.record_sweep(residual=_rel_residual(A, cur, b),
                               max_rank=max(cur.ranks))

    nsweeps = 0
    while nsweeps < sweep_count:
        nsweeps += 1
        for i in range(d - 1):  # forward half sweep
            V = _local_solve(L[i], A.cores[i], R[i + 1], Lb[i], b.cores[i],
                             Rb[i + 1])
            _move_right(cores, i, V)
            L[i + 1] = update_left_env(L[i], cores[i], A.cores[i])
            Lb[i + 1] = update_left_env_b(Lb[i], cores[i], b.cores[i])
            if telemetry is not None:
                telemetry.local_solves += 1
        _telemetry_sweep()
        if nsweeps >= sweep_count:
            break
        nsweeps += 1
        for i in range(d - 1, 0, -1):  # backward half sweep
            V = _local_solve(L[i], A.cores[i], R[i + 1], Lb[i], b.cores[i],
                             Rb[i + 1])
            _move_left(cores, i, V)
            R[i] = update_right_env(R[i + 1], cores[i], A.cores[i])
            Rb[i] = update_right_env_b(Rb[i + 1], cores[i], b.cores[i])
            if telemetry is not None:
                telemetry.local_solves += 1
        _telemetry_sweep()

    out = TTVector(cores)
    if telemetry is not None:
        telemetry.wall_seconds += time.perf_counter() - t_start
    if return_info:
        return out, {"residual": _rel_residual(A, out, b)}
    return out


def _regrow(cores, rmax, noise, generator):
    """Zero-pad (and optionally perturb) the state to ``rmax`` and put it
    back in site-0 canonical form."""
    x = increase_ranks(TTVector(cores), rmax, noise=noise,
                       generator=generator)
    return orthogonalize(x, 0)


def als_eigsolve(A: TTOperator, x0: TTVector, sweep_schedule=None,
                 rmax_schedule=None, noise_schedule=None,
                 it_solver: bool = False, itslv_thresh: int = 1024,
                 maxiter: int = 200, linsolv_tol: float = 1e-8,
                 generator: torch.Generator | None = None, telemetry=None):
    """Smallest eigenpair of ``A`` by Rayleigh-quotient ALS with a staged
    rank-growth schedule; returns ``(E, x)`` with ``E`` the per-microstep
    eigenvalue history (host numpy). ``generator`` (a ``torch.Generator``,
    in place of ttnx's PRNG key) draws the noise of a rank-growth stage.
    """
    t_start = time.perf_counter()
    if sweep_schedule is None:
        sweep_schedule = [2]
    if rmax_schedule is None:
        rmax_schedule = [max(x0.ranks)]
    if noise_schedule is None:
        noise_schedule = [0.0] * len(rmax_schedule)
    if not (len(rmax_schedule) == len(sweep_schedule) == len(noise_schedule)):
        raise ValueError("Sweep schedule error")

    d = A.N
    x = orthogonalize(x0, 0)
    dt = _promote(A, x)
    x, A = _cast(x, dt), _cast(A, dt)
    dev = x.device
    cores = list(x.cores)
    E: list[float] = []

    R = init_right_envs(x, A)
    L = [None] * (d + 1)
    L[0] = _ones_env(dt, dev)

    def eig_site(i):
        lam, V = _local_eigmin(L[i], A.cores[i], R[i + 1], cores[i],
                               it_solver=it_solver, itslv_thresh=itslv_thresh,
                               maxiter=maxiter, tol=linsolv_tol)
        E.append(float(lam.real))
        if telemetry is not None:
            telemetry.local_solves += 1
            telemetry.record_sweep(energy=E[-1],
                                   max_rank=max(TTVector(cores).ranks))
        return V

    nsweeps = 0
    i_schedule = 0
    while i_schedule < len(sweep_schedule):
        nsweeps += 1
        if nsweeps == sweep_schedule[i_schedule]:
            i_schedule += 1
            if i_schedule >= len(sweep_schedule):
                break
            x = _regrow(cores, rmax_schedule[i_schedule],
                        noise_schedule[i_schedule], generator)
            cores = list(x.cores)
            R = init_right_envs(x, A)
            L = [None] * (d + 1)
            L[0] = _ones_env(dt, dev)
        for i in range(d - 1):  # forward
            V = eig_site(i)
            _move_right(cores, i, V)
            L[i + 1] = update_left_env(L[i], cores[i], A.cores[i])
        for i in range(d - 1, 0, -1):  # backward
            V = eig_site(i)
            _move_left(cores, i, V)
            R[i] = update_right_env(R[i + 1], cores[i], A.cores[i])
    if telemetry is not None:
        telemetry.wall_seconds += time.perf_counter() - t_start
    return np.asarray(E), TTVector(cores)


def als_gen_eigsolv(A: TTOperator, S: TTOperator, x0: TTVector,
                    sweep_schedule=None, rmax_schedule=None, tol: float = 1e-10,
                    it_solver: bool = False, itslv_thresh: int = 2500,
                    generator: torch.Generator | None = None):
    """Generalized eigenproblem ``A x = lambda S x`` by ALS; returns ``(E,
    x)``."""
    del tol, it_solver, itslv_thresh  # dense generalized local solves
    if sweep_schedule is None:
        sweep_schedule = [2]
    if rmax_schedule is None:
        rmax_schedule = [max(x0.ranks)]

    d = A.N
    x = orthogonalize(x0, 0)
    dt = _promote(A, S, x)
    x, A, S = _cast(x, dt), _cast(A, dt), _cast(S, dt)
    dev = x.device
    cores = list(x.cores)
    E: list[float] = []

    def fresh_envs(x):
        L = [None] * (d + 1)
        Ls = [None] * (d + 1)
        L[0] = _ones_env(dt, dev)
        Ls[0] = _ones_env(dt, dev)
        return init_right_envs(x, A), init_right_envs(x, S), L, Ls

    R, Rs, L, Ls = fresh_envs(x)
    nsweeps = 0
    i_schedule = 0
    while i_schedule < len(sweep_schedule):
        nsweeps += 1
        if nsweeps == sweep_schedule[i_schedule]:
            i_schedule += 1
            if i_schedule >= len(sweep_schedule):
                break
            x = _regrow(cores, rmax_schedule[i_schedule], 0.0, generator)
            cores = list(x.cores)
            R, Rs, L, Ls = fresh_envs(x)
        for i in range(d - 1):
            lam, V = _local_gen_eigmin(L[i], A.cores[i], R[i + 1],
                                       Ls[i], S.cores[i], Rs[i + 1], cores[i])
            E.append(lam)
            _move_right(cores, i, V)
            L[i + 1] = update_left_env(L[i], cores[i], A.cores[i])
            Ls[i + 1] = update_left_env(Ls[i], cores[i], S.cores[i])
        for i in range(d - 1, 0, -1):
            lam, V = _local_gen_eigmin(L[i], A.cores[i], R[i + 1],
                                       Ls[i], S.cores[i], Rs[i + 1], cores[i])
            E.append(lam)
            _move_left(cores, i, V)
            R[i] = update_right_env(R[i + 1], cores[i], A.cores[i])
            Rs[i] = update_right_env(Rs[i + 1], cores[i], S.cores[i])
    return np.asarray(E), TTVector(cores)
