"""Time steppers: explicit and implicit Euler, Crank–Nicolson, RK4 — the
eager tier.

Twin of ``ttnx.solvers.steppers``. The inner linear solve dispatches over
{mals, als, dmrg, krylov}; rank control is explicit (``max_bond``). The
identity operator lives on the device of ``A``. Step sizes are Python
scalars, which do not promote: float32 problems stay float32 (ttnx's
numpy-scalar steps promote them to float64, ROADMAP C).

RK4 rounds every stage with :func:`tt_round` (orthogonalize, then truncate
in the canonical gauge) where ttnx calls the gauge-free two-site
``tt_compress``: the stage sums carry ranks far above their exact rank, and
truncating their local SVDs outside a canonical gauge dropped weight that
does not cancel (rel 5.7e-6 in ttnx against 1.8e-12 here on the 50-step
three-mode problem of ``entry.sine_mode_problem``, ROADMAP C).
"""

from __future__ import annotations

import numpy as np

from ttnx_torch.core.algebra import (add, add_op, dot, matvec, norm, scale,
                                     scale_op, sub)
from ttnx_torch.core.canonical import orthogonalize, tt_compress, tt_round
from ttnx_torch.core.tt import TTOperator, TTVector, id_tto
from ttnx_torch.solvers.als import als_linsolve
from ttnx_torch.solvers.dmrg import dmrg_linsolve
from ttnx_torch.solvers.krylov import krylov_linsolve
from ttnx_torch.solvers.mals import mals_linsolve

__all__ = ["euler_method", "implicit_euler_method", "crank_nicholson_method",
           "rk4_method"]


def _solve(tt_solver, M, rhs, guess, max_bond, **kwargs):
    if tt_solver == "mals":
        return mals_linsolve(M, rhs, guess, **kwargs)
    if tt_solver == "als":
        return als_linsolve(M, rhs, guess, **kwargs)
    if tt_solver == "dmrg":
        return dmrg_linsolve(M, rhs, guess, **kwargs)
    if tt_solver == "krylov":
        return krylov_linsolve(M, rhs, guess, max_bond=max_bond, **kwargs)
    raise ValueError(f"Unknown TT solver: {tt_solver}")


def _eye(A: TTOperator) -> TTOperator:
    return id_tto(A.N, dtype=A.dtype, device=A.device)


def _steps(steps):
    return [float(h) for h in np.atleast_1d(steps)]


def _unit(u: TTVector) -> TTVector:
    return scale(1.0 / float(np.sqrt(float(dot(u, u).real))), u)


def euler_method(A: TTOperator, u0: TTVector, steps, normalize: bool = True,
                 return_error: bool = False):
    """Explicit Euler ``u <- u + h A u``."""
    u = u0
    for h in _steps(steps):
        u = orthogonalize(add(u, scale(h, matvec(A, u))), 0)
        if normalize:
            u = _unit(u)
    if return_error:
        h = _steps(steps)[-1]
        M = add_op(_eye(A), scale_op(h, A))
        residual = sub(u, matvec(M, u))
        return u, float(norm(residual) / norm(u))
    return u


def implicit_euler_method(A: TTOperator, u0: TTVector, guess: TTVector, steps,
                          normalize: bool = True, return_error: bool = False,
                          tt_solver: str = "mals", max_bond: int = 0,
                          **kwargs):
    """Implicit Euler: solve ``(I - h A) u_next = u`` each step."""
    u = u0
    u_prev = u0
    eye = _eye(A)
    for h in _steps(steps):
        M = add_op(eye, scale_op(-h, A))
        nxt = _solve(tt_solver, M, u, guess, max_bond, **kwargs)
        if normalize:
            nxt = scale(1.0 / float(norm(nxt)), nxt)
        u_prev = u
        u = tt_compress(nxt, max_bond) if max_bond > 0 else orthogonalize(nxt, 0)
        guess = u
    if return_error:
        h = _steps(steps)[-1]
        M = add_op(eye, scale_op(-h, A))
        residual = sub(matvec(M, u), u_prev)
        return u, float(norm(residual) / norm(u))
    return u


def crank_nicholson_method(A: TTOperator, u0: TTVector, guess: TTVector, steps,
                           normalize: bool = True, return_error: bool = False,
                           tt_solver: str = "mals", max_bond: int = 0,
                           **kwargs):
    """Crank–Nicolson: ``(I - h/2 A) u_next = (I + h/2 A) u``."""
    u = u0
    u_prev = u0
    eye = _eye(A)
    for h in _steps(steps):
        lhs = add_op(eye, scale_op(-h / 2, A))
        rhs = matvec(add_op(eye, scale_op(h / 2, A)), u)
        nxt = _solve(tt_solver, lhs, rhs, guess, max_bond, **kwargs)
        if normalize:
            nxt = scale(1.0 / float(norm(nxt)), nxt)
        u_prev = u
        u = tt_compress(nxt, max_bond) if max_bond > 0 else orthogonalize(nxt, 0)
        guess = u
    if return_error:
        h = _steps(steps)[-1]
        lhs = add_op(eye, scale_op(-h / 2, A))
        rhs = matvec(add_op(eye, scale_op(h / 2, A)), u_prev)
        residual = sub(matvec(lhs, u), rhs)
        return u, float(norm(residual) / norm(u))
    return u


def rk4_method(A: TTOperator, u0: TTVector, steps, max_bond: int,
               normalize: bool = True, return_error: bool = False):
    """Classic RK4 with every stage rounded to ``max_bond``."""
    u = u0

    def rnd(x):
        return tt_round(x, max_bond=max_bond)

    def increment(u, h):
        k1 = matvec(A, u)
        k2 = matvec(A, rnd(add(u, scale(h / 2, k1))))
        k3 = matvec(A, rnd(add(u, scale(h / 2, k2))))
        k4 = matvec(A, rnd(add(u, scale(h, k3))))
        ksum = add(add(k1, scale(2.0, k2)), add(scale(2.0, k3), k4))
        return scale(h / 6, rnd(ksum))

    for h in _steps(steps):
        u = rnd(add(u, increment(u, h)))
        if normalize:
            u = _unit(u)
    if return_error:
        h = _steps(steps)[-1]
        incr = increment(u, h)
        residual = rnd(sub(sub(u, sub(u, incr)), incr))
        return u, float(norm(residual) / max(float(norm(u)), 1e-300))
    return u
