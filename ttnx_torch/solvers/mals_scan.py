"""Rank-adaptive MALS on padded stacks: two-site sweeps whose ranks live in
0/1 masks, so truncation never changes a buffer shape.

Twin of ``ttnx.solvers.mals_scan``. Cores are stacked ``(d, R, n, R)`` and
padded to ``rmax``; the realized ranks are the masks ``(d+1, R)``, runtime
data that come back from the mask sums. The keep rule is a cumulative sum
over the fixed-width singular-value vector (:func:`_keep_mask`).

Every local problem is a dense ``M = R n n R`` system or eigenproblem
solved by ``torch.linalg`` (22 of them a sweep at d = 12; ``M = 16384`` at
R = 64, where K alone is 2 GB in f64 and is masked in place). The
environment stacks are the plain pairwise contractions: no kernel serves
them, as none does in the JAX package. The sweeps run with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from ttnx_torch.config import matmul_precision
from ttnx_torch.core.linalg import thin_svd
from ttnx_torch.core.tt import TTOperator, TTVector
from ttnx_torch.kernels.env_chain import (boundary_envs, env_chain_A_plain,
                                          left_env_b_update, left_env_update,
                                          right_env_b_update,
                                          right_env_update)
from ttnx_torch.solvers.als_scan import (_left_env_stack, _right_env_stack,
                                         unpack_tt)
from ttnx_torch.solvers.dmrg_scan import (_assemble_K2, _default_rmax,
                                          _first_mask, _packed, _window_mask)

__all__ = ["mals_sweep", "mals_linsolve_scan", "mals_eig_sweep",
           "mals_eigsolve_scan"]


def _keep_mask(s, tol):
    """Discarded-weight mask over the singular values ``s`` (descending):
    drop the largest trailing block whose squared weight stays below ``tol
    |s|^2`` (zero padding values are always dropped); keep at least one."""
    s2 = s * s
    tails = torch.flip(torch.cumsum(torch.flip(s2, (0,)), 0), (0,))
    keep = tails >= tol * torch.sum(s2)
    keep[0] = True
    return keep.to(s.dtype)


def _local2_solve(L, Ai, Aj, Renv, Lb, bi, bj, Rb, m_l, m_r):
    """Masked two-site linear solve: the identity on the padded diagonal,
    ``1e-100`` on the active one (0 in f32, as in the JAX package)."""
    R, n = L.shape[0], Ai.shape[1]
    M = R * n * n * R
    maskv = _window_mask(m_l, m_r, n).reshape(M)
    K = _assemble_K2(L, Ai, Aj, Renv, maskv)
    diag = K.diagonal()
    diag.add_(1.0 - maskv)
    diag.add_(1e-100 * maskv)
    t = torch.einsum("au,uiv->aiv", Lb, bi)
    t = torch.einsum("aiv,vjw->aijw", t, bj)
    rhs = torch.einsum("aijw,cw->aijc", t, Rb).reshape(M) * maskv
    return torch.linalg.solve(K, rhs).reshape(R, n, n, R)


def _local2_eigmin(L, Ai, Aj, Renv, m_l, m_r):
    """Smallest eigenpair of the masked two-site operator; padded
    directions sit just above the spectral range (``norm(Km) + 1``, as in
    ``als_scan._local_eig_padded``)."""
    R, n = L.shape[0], Ai.shape[1]
    M = R * n * n * R
    maskv = _window_mask(m_l, m_r, n).reshape(M)
    Km = _assemble_K2(L, Ai, Aj, Renv, maskv)
    pad = torch.linalg.norm(Km) + 1.0
    K = Km + torch.diag(pad * (1.0 - maskv))
    K = 0.5 * (K + K.conj().T)
    w, U = torch.linalg.eigh(K)
    return w[0], U[:, 0].reshape(R, n, n, R)


def _split_right(V, tol, R, n):
    """Left-orthonormal core, the pending ``s vt`` and the keep mask of a
    two-site block moving right."""
    u, s, vt = thin_svd(V.reshape(R * n, n * R))
    keep = _keep_mask(s, tol)[:R]
    core = (u[:, :R] * keep[None, :]).reshape(R, n, R)
    last = ((s[:R, None] * vt[:R, :]) * keep[:, None]).reshape(R, n, R)
    return core, last, keep


def _split_left(V, tol, R, n):
    """Right-orthonormal core, the pending ``u s`` and the keep mask of a
    two-site block moving left."""
    u, s, vt = thin_svd(V.reshape(R * n, n * R))
    keep = _keep_mask(s, tol)[:R]
    core = (vt[:R, :] * keep[:, None]).reshape(R, n, R)
    first = ((u[:, :R] * s[None, :R]) * keep[None, :]).reshape(R, n, R)
    return core, first, keep


def mals_sweep(A_stack, b_stack, x_stack, mask_stack, tol):
    """One full MALS sweep (forward + backward) with rank masks; returns
    ``(x_stack, mask_stack)``, the masks carrying the adapted ranks."""
    d, R, n, _ = x_stack.shape
    RA, Rb = A_stack.shape[1], b_stack.shape[1]
    dt, dev = x_stack.dtype, x_stack.device
    with matmul_precision("highest"):
        Renvs, Rb_envs = _right_env_stack(x_stack, A_stack, b_stack,
                                          mask_stack[1:])
        L, Lb = boundary_envs(R, RA, Rb, dt, dev)
        m_l, last = _first_mask(mask_stack), x_stack[d - 1]
        cores, masks = [], []
        for k in range(d - 1):
            Ai, bi = A_stack[k], b_stack[k]
            V = _local2_solve(L, Ai, A_stack[k + 1], Renvs[k + 2], Lb, bi,
                              b_stack[k + 1], Rb_envs[k + 2], m_l,
                              mask_stack[k + 2])
            core, last, m_l = _split_right(V, tol, R, n)
            L = left_env_update(core, L, Ai)
            Lb = left_env_b_update(core, Lb, bi)
            cores.append(core)
            masks.append(m_l)
        x_mid = torch.stack(cores + [last])
        masks_mid = torch.stack([mask_stack[0]] + masks + [mask_stack[d]])

        Lenvs, Lb_envs = _left_env_stack(x_mid, A_stack, b_stack,
                                         masks_mid[1:])
        Renv, Rb_env = boundary_envs(R, RA, Rb, dt, dev)
        m_r, first = _first_mask(mask_stack), x_mid[0]
        cores, masks = [None] * (d - 1), [None] * (d - 1)
        for k in range(d - 2, -1, -1):
            Aj, bj = A_stack[k + 1], b_stack[k + 1]
            V = _local2_solve(Lenvs[k], A_stack[k], Aj, Renv, Lb_envs[k],
                              b_stack[k], bj, Rb_env, masks_mid[k], m_r)
            core, first, m_r = _split_left(V, tol, R, n)
            Renv = right_env_update(core, Aj, Renv)
            Rb_env = right_env_b_update(core, bj, Rb_env)
            cores[k], masks[k] = core, m_r
        return (torch.stack([first] + cores),
                torch.stack([mask_stack[0]] + masks + [mask_stack[d]]))


def mals_eig_sweep(A_stack, x_stack, mask_stack, tol):
    """One full rank-adaptive MALS eigensweep; returns ``(x_stack,
    mask_stack, energies)`` with the ``2 (d - 1)`` local eigenvalues in the
    order computed."""
    d, R, n, _ = x_stack.shape
    RA = A_stack.shape[1]
    dt, dev = x_stack.dtype, x_stack.device
    lams = []
    with matmul_precision("highest"):
        Renvs = env_chain_A_plain(
            x_stack * mask_stack[1:][:, None, None, :], A_stack)
        L, _ = boundary_envs(R, RA, 1, dt, dev)
        m_l, last = _first_mask(mask_stack), x_stack[d - 1]
        cores, masks = [], []
        for k in range(d - 1):
            Ai = A_stack[k]
            lam, V = _local2_eigmin(L, Ai, A_stack[k + 1], Renvs[k + 2], m_l,
                                    mask_stack[k + 2])
            core, last, m_l = _split_right(V, tol, R, n)
            L = left_env_update(core, L, Ai)
            cores.append(core)
            masks.append(m_l)
            lams.append(lam)
        x_mid = torch.stack(cores + [last])
        masks_mid = torch.stack([mask_stack[0]] + masks + [mask_stack[d]])

        Lenvs = env_chain_A_plain(x_mid * masks_mid[1:][:, None, None, :],
                                  A_stack, left=True)
        Renv, _ = boundary_envs(R, RA, 1, dt, dev)
        m_r, first = _first_mask(mask_stack), x_mid[0]
        cores, masks = [None] * (d - 1), [None] * (d - 1)
        for k in range(d - 2, -1, -1):
            Aj = A_stack[k + 1]
            lam, V = _local2_eigmin(Lenvs[k], A_stack[k], Aj, Renv,
                                    masks_mid[k], m_r)
            core, first, m_r = _split_left(V, tol, R, n)
            Renv = right_env_update(core, Aj, Renv)
            cores[k], masks[k] = core, m_r
            lams.append(lam)
        return (torch.stack([first] + cores),
                torch.stack([mask_stack[0]] + masks + [mask_stack[d]]),
                torch.stack(lams))


def _ranks(masks):
    return [int(v) for v in masks.sum(dim=1).tolist()]


def mals_eigsolve_scan(A: TTOperator, x0: TTVector, tol: float = 1e-12,
                       rmax: int | None = None, n_sweeps: int = 2):
    """Rank-adaptive smallest-eigenpair solver: ``n_sweeps`` calls of
    :func:`mals_eig_sweep`. Returns ``(E, x)``: every local eigenvalue
    (host numpy, real) and the state at its realized ranks. ``rmax``
    defaults to ``min(round(sqrt(prod dims)), 64)``."""
    if rmax is None:
        rmax = _default_rmax(x0)
    (A_stack, x_stack), masks = _packed(A, x0, rmax)
    energies = []
    for _ in range(n_sweeps):
        x_stack, masks, lams = mals_eig_sweep(A_stack, x_stack, masks, tol)
        energies.append(lams.real.cpu().numpy())
    return np.concatenate(energies), unpack_tt(x_stack, _ranks(masks))


def mals_linsolve_scan(A: TTOperator, b: TTVector, x0: TTVector,
                       tol: float = 1e-12, rmax: int | None = None,
                       n_sweeps: int = 1):
    """Rank-adaptive MALS linear solve. ``rmax`` is the buffer cap
    (default ``min(round(sqrt(prod dims)), 64)``); the realized ranks adapt
    to ``tol`` and are those of the returned TT."""
    if rmax is None:
        rmax = _default_rmax(x0)
    (A_stack, b_stack, x_stack), masks = _packed(A, x0, rmax, b)
    for _ in range(n_sweeps):
        x_stack, masks = mals_sweep(A_stack, b_stack, x_stack, masks, tol)
    return unpack_tt(x_stack, _ranks(masks))
