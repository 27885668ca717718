"""Krylov primitives: the Arnoldi exponential and TT-valued Krylov linear
solvers with explicit rank rounding — the eager tier.

Twin of ``ttnx.solvers.krylov``:

* :func:`expm_multiply` — Arnoldi ``exp(t H) v`` on dense local tensors
  (TDVP's inner step). The basis vectors stay on the device of ``v``; the
  small Hessenberg matrix is built and exponentiated on the host in
  complex128, as in the reference.
* :func:`expintegrator_tt`, :func:`gmres_tt`, :func:`bicgstab_tt`,
  :func:`cg_tt` — TT-valued Krylov methods where every rank-growing
  ``A x`` / ``x + y`` is followed by an explicit rounding
  (``max_bond``; an exact orthogonalization when 0).
* :func:`krylov_linsolve` — CG for positive-definite symmetric problems,
  else BiCGStab when rounding, else GMRES.

Like the reference, this tier reads scalars to the host inside every
iteration (each Gram–Schmidt coefficient, each norm): one device
synchronization each. The scan tier (``tdvp_scan``, ``round_scan``) runs
whole steps without them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import scipy.linalg
import torch

from ttnx_torch.core.algebra import add, dot, matvec, norm, scale, sub
from ttnx_torch.core.canonical import orthogonalize, tt_round
from ttnx_torch.core.tt import TTOperator, TTVector

__all__ = ["expm_multiply", "expintegrator_tt", "krylov_linsolve",
           "gmres_tt", "bicgstab_tt", "cg_tt"]


def _scalar(z, real: bool):
    """A host coefficient as a Python number (real when ``real``)."""
    return float(np.real(z)) if real else complex(z)


# ---------------------------------------------------------------------------
# exp(t*H) v by Arnoldi (dense vectors — TDVP local steps)
# ---------------------------------------------------------------------------


def expm_multiply(f: Callable, t, v: torch.Tensor, tol: float = 1e-12,
                  krylov_dim: int = 30, ishermitian: bool = True):
    """``exp(t * H) v`` where ``H`` acts through ``f`` on tensors of
    ``v``'s shape. Arnoldi with full (twice-is-enough) reorthogonalization;
    the dimension adapts with the ``h_{m+1,m} |y_m|`` error estimate."""
    del ishermitian  # full-GS Arnoldi covers both cases
    shape = v.shape
    v0 = v.reshape(-1)
    m_dim = v0.shape[0]
    beta = float(torch.linalg.vector_norm(v0))
    if beta == 0.0:
        return v
    m_max = min(krylov_dim, m_dim)
    # a complex t promotes, a float one does not
    dtype = torch.result_type(v0, t)
    real = not dtype.is_complex
    V = [v0.to(dtype) / beta]
    H = np.zeros((m_max + 1, m_max), dtype=np.complex128)
    y = None
    m_used = 0
    for j in range(m_max):
        w = f(V[j].reshape(shape)).reshape(-1).to(dtype)
        for _ in range(2):  # twice-is-enough Gram-Schmidt
            for i in range(j + 1):
                c = torch.vdot(V[i], w)
                H[i, j] += complex(c)
                w = w - c * V[i]
        h_next = float(torch.linalg.vector_norm(w))
        H[j + 1, j] = h_next
        m_used = j + 1
        # small exponential of the (j+1)x(j+1) Hessenberg block
        y = beta * scipy.linalg.expm(t * H[: j + 1, : j + 1])[:, 0]
        err = h_next * abs(y[j]) * abs(t) if j + 1 < m_dim else 0.0
        if h_next < 1e-14 or err < tol * max(np.linalg.norm(y), 1e-300):
            break
        V.append(w / h_next)
    out = torch.zeros_like(V[0])
    for i in range(m_used):
        out = out + _scalar(y[i], real) * V[i]
    return out.reshape(shape)


def expintegrator_tt(A: TTOperator, t, v: TTVector, krylov_dim: int = 30,
                     tol: float = 1e-12, max_bond: int = 0):
    """``exp(t * A) v`` with Arnoldi in TT arithmetic; every basis update
    is rank-rounded explicitly (``max_bond``; exact orthogonalize when 0).

    Returns ``(result, info)`` with the Krylov dimension used and the
    ``h_{m+1,m} |y_m|`` error estimate."""
    if krylov_dim < 1:
        raise ValueError(f"krylov_dim must be >= 1, got {krylov_dim}")
    rnd = _rounder(max_bond)
    beta = float(norm(v))
    if beta == 0.0:
        return v, {"krylov_dim": 0, "error_estimate": 0.0}
    V = [scale(1.0 / beta, v)]
    H = np.zeros((krylov_dim + 1, krylov_dim), dtype=np.complex128)
    m_used = 0
    err_est = np.inf
    for j in range(krylov_dim):
        w = rnd(matvec(A, V[j]))
        for i in range(j + 1):
            # the device scalar in the update keeps real input real
            c = dot(V[i], w)
            H[i, j] = complex(c)
            w = sub(w, scale(c, V[i]))
        w = rnd(w)
        hn = float(norm(w))
        H[j + 1, j] = hn
        m_used = j + 1
        y = scipy.linalg.expm(t * H[:m_used, :m_used])[:, 0]
        err_est = abs(t) * hn * abs(y[-1]) * beta
        if hn < 1e-14 or err_est < tol * beta:
            break
        V.append(scale(1.0 / hn, w))
    coeffs = beta * y[:m_used]
    real = not v.is_complex and np.allclose(np.imag(coeffs), 0)
    acc = scale(_scalar(coeffs[0], real), V[0])
    for i in range(1, m_used):
        acc = add(acc, scale(_scalar(coeffs[i], real), V[i]))
    return rnd(acc), {"krylov_dim": m_used, "error_estimate": err_est}


# ---------------------------------------------------------------------------
# TT-valued Krylov linear solvers with explicit rank rounding
# ---------------------------------------------------------------------------


def _rounder(max_bond: int):
    """Per-iteration rank control: :func:`tt_round` at ``max_bond``, or an
    exact orthogonalization when 0."""
    if max_bond > 0:
        return lambda x: tt_round(x, max_bond=max_bond)
    return lambda x: orthogonalize(x, 0)


def gmres_tt(op: Callable, b: TTVector, x0: TTVector, krylovdim: int = 8,
             maxiter: int = 20, tol: float = 1e-8, max_bond: int = 0):
    """Restarted GMRES over TT vectors; every vector update is rounded."""
    rnd = _rounder(max_bond)
    x = rnd(x0)
    for _ in range(maxiter):
        r = rnd(sub(b, op(x)))
        beta = float(norm(r))
        if beta <= tol:
            return x
        V = [scale(1.0 / beta, r)]
        H = np.zeros((krylovdim + 1, krylovdim), dtype=np.complex128)
        m_used = 0
        for j in range(krylovdim):
            w = op(V[j])
            for i in range(j + 1):
                c = dot(V[i], w)
                H[i, j] = complex(c)
                w = sub(w, scale(c, V[i]))
            w = rnd(w)
            hn = float(norm(w))
            H[j + 1, j] = hn
            m_used = j + 1
            if hn < 1e-14:
                break
            V.append(scale(1.0 / hn, w))
        e1 = np.zeros(m_used + 1, dtype=np.complex128)
        e1[0] = beta
        y, *_ = np.linalg.lstsq(H[: m_used + 1, :m_used], e1, rcond=None)
        real = not b.is_complex and np.allclose(np.imag(y), 0)
        for i in range(m_used):
            x = add(x, scale(_scalar(y[i], real), V[i]))
        x = rnd(x)
        if float(norm(sub(b, op(x)))) <= tol:
            return x
    return x


def bicgstab_tt(op: Callable, b: TTVector, x0: TTVector, maxiter: int = 20,
                tol: float = 1e-8, max_bond: int = 0):
    """BiCGStab over TT vectors with per-update rounding. Rounding perturbs
    the recurrences, so a breakdown (``<r0, r> -> 0``) restarts from the
    true residual instead of aborting."""
    rnd = _rounder(max_bond)
    x = rnd(x0)
    r = rnd(sub(b, op(x)))
    r0 = r
    rho = alpha = omega = 1.0
    p = v = None
    rnorm0 = max(float(norm(r)), 1e-300)
    it = 0
    while it < maxiter:
        it += 1
        rho_new = dot(r0, r)
        breakdown = bool(abs(rho_new) < 1e-14 * rnorm0 ** 2)
        if not breakdown:
            if p is None:
                p = r
            else:
                beta = (rho_new / rho) * (alpha / omega)
                p = rnd(add(r, scale(beta, sub(p, scale(omega, v)))))
            v = op(p)
            denom = dot(r0, v)
            breakdown = bool(abs(denom) < 1e-300)
        if breakdown:
            r = rnd(sub(b, op(x)))
            if float(norm(r)) <= tol:
                return x
            r0 = r
            rho = alpha = omega = 1.0
            p = v = None
            continue
        alpha = rho_new / denom
        s = rnd(sub(r, scale(alpha, v)))
        if float(norm(s)) <= tol:
            return rnd(add(x, scale(alpha, p)))
        t_vec = op(s)
        tt_norm2 = dot(t_vec, t_vec)
        if bool(abs(tt_norm2) < 1e-300):
            x = rnd(add(x, scale(alpha, p)))
            r = rnd(sub(b, op(x)))
            r0 = r
            rho = alpha = omega = 1.0
            p = v = None
            continue
        omega = dot(t_vec, s) / tt_norm2
        x = rnd(add(add(x, scale(alpha, p)), scale(omega, s)))
        r = rnd(sub(s, scale(omega, t_vec)))
        rho = rho_new
        if float(norm(r)) <= tol:
            return x
    return x


def cg_tt(op: Callable, b: TTVector, x0: TTVector, maxiter: int = 100,
          tol: float = 1e-8, max_bond: int = 0):
    """Conjugate gradients over TT vectors with per-update rounding (SPD)."""
    rnd = _rounder(max_bond)
    x = rnd(x0)
    r = rnd(sub(b, op(x)))
    p = r
    rs = dot(r, r)
    for _ in range(maxiter):
        if float(abs(rs)) ** 0.5 <= tol:
            return x
        Ap = op(p)
        alpha = rs / dot(p, Ap)
        x = rnd(add(x, scale(alpha, p)))
        r = rnd(sub(r, scale(alpha, Ap)))
        rs_new = dot(r, r)
        p = rnd(add(r, scale(rs_new / rs, p)))
        rs = rs_new
    return x


def krylov_linsolve(A: TTOperator, b: TTVector, guess: TTVector,
                    max_bond: int = 0, krylov_solver: str = "auto",
                    krylovdim: int = 8, maxiter: int = 20, rtol: float = 1e-8,
                    atol: float = 1e-12, tol: float | None = None,
                    issymmetric: bool = False, ishermitian: bool | None = None,
                    isposdef: bool = False, config=None):
    """TT Krylov linear solve with a rank-capped matvec: ``'auto'`` picks
    CG for positive-definite symmetric/Hermitian problems, else BiCGStab
    when rounding (``max_bond > 0``), else GMRES. ``config``
    (:class:`ttnx_torch.config.KrylovConfig`) overrides option defaults."""
    if config is not None:
        max_bond, krylov_solver = config.max_bond, config.krylov_solver
        krylovdim, maxiter = config.krylovdim, config.maxiter
        rtol, atol = config.rtol, config.atol
    if ishermitian is None:
        ishermitian = issymmetric
    if max_bond > 0:
        op = lambda x: tt_round(matvec(A, x), max_bond=max_bond)
    else:
        op = lambda x: matvec(A, x)
    solver = krylov_solver
    if solver == "auto":
        if isposdef and (issymmetric or ishermitian):
            solver = "cg"
        else:
            solver = "bicgstab" if max_bond > 0 else "gmres"
    tol_value = tol if tol is not None else max(atol, rtol * float(norm(b)))
    if solver == "gmres":
        return gmres_tt(op, b, guess, krylovdim=krylovdim, maxiter=maxiter,
                        tol=tol_value, max_bond=max_bond)
    if solver == "bicgstab":
        return bicgstab_tt(op, b, guess, maxiter=max(maxiter, krylovdim),
                           tol=tol_value, max_bond=max_bond)
    if solver == "cg":
        return cg_tt(op, b, guess, maxiter=krylovdim * maxiter, tol=tol_value,
                     max_bond=max_bond)
    raise ValueError(
        f"Unknown Krylov solver: {krylov_solver}. "
        "Use 'auto', 'bicgstab', 'cg', or 'gmres'.")
