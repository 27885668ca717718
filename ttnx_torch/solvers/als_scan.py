"""Padded-rank ALS: the linear solve and the eigensolve of the scan tier.

Cores are stacked dense tensors ``x (d, R, n, R)`` padded to a uniform
``rmax``; TT ranks enter only through 0/1 masks ``(d+1, R)``. Every padded
region of every tensor is exactly zero; the local operator gets the
identity on the padded diagonal so the local solve stays well posed and
returns zeros there. The site loops are Python loops over the site axis.

The environment stacks go through kernel B2
(:mod:`ttnx_torch.kernels.env_chain`), the rank <= 16 local CG through B3
and BiCGStab through B10 (:mod:`ttnx_torch.kernels.local_cg`) and larger
local CG through B4 (:mod:`ttnx_torch.kernels.local_cg_mf`) for real
dtypes; the eigensweeps' operator-only env stacks go through B8
(:func:`ttnx_torch.kernels.env_chain.env_chain_A_fused`) for real dtypes,
and their local ``eigh`` and QR stay ``torch.linalg``. Each wrapper runs its
Hopper kernel on CUDA tensors and its plain version on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ttnx_torch.config import matmul_precision
from ttnx_torch.core.canonical import orthogonalize
from ttnx_torch.core.tt import TTOperator, TTVector
from ttnx_torch.kernels.dispatch import can_fuse_local_cg
from ttnx_torch.kernels.env_chain import (boundary_envs, env_chain_A_fused,
                                          env_chain_A_plain,
                                          left_env_b_update,
                                          left_env_chain_fused,
                                          left_env_chain_plain,
                                          left_env_update,
                                          right_env_b_update,
                                          right_env_chain_fused,
                                          right_env_chain_plain,
                                          right_env_update)
from ttnx_torch.kernels.local_cg import (_safe_div, bicgstab_solve_fused,
                                         cg_solve_fused)
from ttnx_torch.kernels.local_cg_mf import (_vdot, apply_local_op,
                                            cg_matfree_fused,
                                            cg_matfree_plain)
from ttnx_torch.utils.profiling import span

__all__ = [
    "pack_tt",
    "pack_op",
    "unpack_tt",
    "rank_masks",
    "polar_orth",
    "als_sweeps",
    "als_linsolve_scan",
    "als_eigsolve_sweeps",
    "als_eigsolve_scan",
]

SOLVERS = ("lu", "cg", "bicgstab", "cg_fused", "bicgstab_fused")


# ---------------------------------------------------------------------------
# Packing between list-of-cores and stacked padded tensors
# ---------------------------------------------------------------------------


def rank_masks(rks, R: int, dtype=torch.float64, *, device):
    """0/1 masks ``(d+1, R)`` for a static rank vector."""
    rks = list(rks)
    m = np.zeros((len(rks), R))
    for i, r in enumerate(rks):
        m[i, :r] = 1.0
    return torch.as_tensor(m, dtype=dtype, device=device)


def pack_tt(x: TTVector, R: int):
    """Stack TT cores into ``(d, R, n, R)`` (zero padding), on the cores'
    device."""
    n = x.dims[0]
    assert all(m == n for m in x.dims), "padded packing needs uniform dims"
    out = torch.zeros((x.N, R, n, R), dtype=x.dtype, device=x.device)
    for i, c in enumerate(x.cores):
        rl, _, rr = c.shape
        out[i, :rl, :, :rr] = c
    return out


def pack_op(A: TTOperator, RA: int):
    """Stack MPO cores into ``(d, RA, n, n, RA)`` (zero padding)."""
    n = A.dims[0]
    out = torch.zeros((A.N, RA, n, n, RA), dtype=A.dtype, device=A.device)
    for i, c in enumerate(A.cores):
        rl, _, _, rr = c.shape
        out[i, :rl, :, :, :rr] = c
    return out


def unpack_tt(stack, rks) -> TTVector:
    """Slice the active blocks back out into a list-of-cores TT."""
    return TTVector([stack[i, : rks[i], :, : rks[i + 1]]
                     for i in range(stack.shape[0])])


# ---------------------------------------------------------------------------
# Environment stacks (the plain scans; real dtypes take kernel B2's wrappers)
# ---------------------------------------------------------------------------


def _right_env_stack(x, A, b, mask_r):
    """All right environments: ``Renv[i]`` = env of sites i..d-1, stacked
    ``(d+1, R, RA, R)``, and the b-env ``(d+1, R, Rb)``."""
    return right_env_chain_plain(x * mask_r[:, None, None, :], A, b)


def _left_env_stack(x, A, b, mask_r):
    """All left environments; ``Lenv[i]`` covers sites 0..i-1."""
    return left_env_chain_plain(x * mask_r[:, None, None, :], A, b)


# ---------------------------------------------------------------------------
# Local solve
# ---------------------------------------------------------------------------


def _local_solve_padded(L, Ac, Renv, Lb, bc, Rb_env, m_l, m_r, v0=None,
                        solver: str = "lu", cg_iters: int = 48):
    """Masked local solve. ``'lu'`` assembles the dense operator and solves
    it; ``'cg'`` runs fixed-iteration CG with a matrix-free masked apply;
    ``'bicgstab'`` is its non-symmetric analog. ``'cg_fused'`` runs the
    whole CG in one kernel: dense K through B3 at ``M <= 1024``, matrix-free
    through B4 above. ``'bicgstab_fused'`` runs the whole BiCGStab (cold
    start) on the dense K through B10 at ``M <= 1024``. Complex dtypes take
    ``'cg'``, and ``'bicgstab_fused'`` above ``M = 1024`` or for complex
    dtypes the matrix-free ``'bicgstab'`` — never ``'lu'``."""
    R = L.shape[0]
    n = Ac.shape[1]
    M = R * n * R
    maskv3 = (m_l[:, None, None] * m_r[None, None, :]).expand(R, n, R)
    t = torch.einsum("au,uiv->aiv", Lb, bc)
    rhs = torch.einsum("aiv,cv->aic", t, Rb_env) * maskv3
    if solver == "bicgstab_fused":
        if can_fuse_local_cg(L.dtype, M):
            K = _assemble_K_padded(L, Ac, Renv, maskv3)
            V = bicgstab_solve_fused(K, rhs.reshape(M), iters=cg_iters)
            return V.reshape(R, n, R)
        solver = "bicgstab"
    if solver == "cg_fused":
        if can_fuse_local_cg(L.dtype, M):
            K = _assemble_K_padded(L, Ac, Renv, maskv3)
            x0f = None if v0 is None else (v0 * maskv3).reshape(M)
            V = cg_solve_fused(K, rhs.reshape(M), x0=x0f, iters=cg_iters)
            return V.reshape(R, n, R)
        if not L.dtype.is_complex:
            return cg_matfree_fused(L, Ac, Renv, rhs,
                                    maskv3.to(rhs.dtype).contiguous(),
                                    x0=v0, iters=cg_iters)
        solver = "cg"
    if solver == "cg":
        # B4's plain version is exactly the matrix-free masked CG
        return cg_matfree_plain(L, Ac, Renv, rhs, maskv3, x0=v0,
                                iters=cg_iters)
    if solver == "bicgstab":
        # matrix-free BiCGStab (non-symmetric local operators)
        def apply_k(v):
            out = apply_local_op(L, Ac, Renv, v * maskv3)
            return out * maskv3 + (1.0 - maskv3) * v

        x = torch.zeros_like(rhs)
        r = rhs
        rhat = rhs
        rho = _vdot(rhat, r)
        p = r
        for _ in range(cg_iters):
            v = apply_k(p)
            alpha = _safe_div(rho, _vdot(rhat, v))
            s = r - alpha * v
            t = apply_k(s)
            omega = _safe_div(_vdot(t, s), _vdot(t, t))
            x = x + alpha * p + omega * s
            r = s - omega * t
            rho_new = _vdot(rhat, r)
            beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
            p = r + beta * (p - omega * v)
            rho = rho_new
        return x
    K = _assemble_K_padded(L, Ac, Renv, maskv3)
    V = torch.linalg.solve(K, rhs.reshape(M))
    return V.reshape(R, n, R)


def _assemble_K_padded(L, Ac, Renv, maskv3):
    """Dense masked local operator: identity on the padded diagonal and a
    tiny ridge on the active diagonal (zero environment directions of a
    rank-deficient state give zero rows with zero rhs, hence zero
    output)."""
    R, n, _ = maskv3.shape
    M = R * n * R
    t = torch.einsum("aWb,WiJw->aibJw", L, Ac)
    K = torch.einsum("aibJw,cwd->aicbJd", t, Renv).reshape(M, M)
    maskv = maskv3.reshape(M).to(K.dtype)
    return (K * maskv[:, None] * maskv[None, :] + torch.diag(1.0 - maskv)
            + 1e-100 * torch.diag(maskv))


def polar_orth(m, iters: int = 14):
    """Matmul-only orthonormalization by quintic Newton–Schulz iteration for
    the polar factor: ``(q, r)`` with orthonormal ``q`` spanning range(m) and
    ``m = q @ r`` (``r = q^H m``, not triangular). Loose in directions with
    singular values below ~1e-6 of the norm."""
    k = m.shape[1]
    scale = torch.sqrt(torch.sum(m.abs() ** 2)) + 1e-30
    y = m / scale
    eye = torch.eye(k, dtype=m.dtype, device=m.device)
    for _ in range(iters):
        z = y.conj().T @ y
        y = y @ (3.4445 * eye - 4.7750 * z + 2.0315 * (z @ z))
    for _ in range(8):
        z = y.conj().T @ y
        y = 0.5 * y @ (3.0 * eye - z)
    return y, y.conj().T @ m


def _e00(R, dtype, device):
    T = torch.zeros((R, R), dtype=dtype, device=device)
    T[0, 0] = 1.0
    return T


def _forward_half_sweep(x, A, b, Renvs, Rb_envs, masks, solver="lu",
                        orth="qr", cg_iters=48):
    """Solve sites 0..d-2 moving right; the last site absorbs the pending
    factor."""
    d, R, n, _ = x.shape
    L, Lb = boundary_envs(R, A.shape[1], b.shape[1], x.dtype, x.device)
    T = _e00(R, x.dtype, x.device)
    cores = []
    for k in range(d - 1):
        m_l, m_r = masks[k], masks[k + 1]
        with span("ttnx.als.solve"):
            # warm start: the CURRENT iterate's core = T @ x_old[k]
            warm = torch.einsum("ab,bnc->anc", T, x[k])
            V = _local_solve_padded(L, A[k], Renvs[k + 1], Lb, b[k],
                                    Rb_envs[k + 1], m_l, m_r, v0=warm,
                                    solver=solver, cg_iters=cg_iters)
        with span("ttnx.als.orth"):
            if orth == "polar":
                q, r = polar_orth(V.reshape(R * n, R))
            else:
                q, r = torch.linalg.qr(V.reshape(R * n, R))
            core = (q * m_r[None, :]).reshape(R, n, R)
            T = r * m_r[:, None]
        with span("ttnx.als.env"):
            L = left_env_update(core, L, A[k])
            Lb = left_env_b_update(core, Lb, b[k])
        cores.append(core)
    cores.append(torch.einsum("ab,bnc->anc", T, x[d - 1]))
    return torch.stack(cores)


def _backward_half_sweep(x, A, b, Lenvs, Lb_envs, masks, solver="lu",
                         orth="qr", cg_iters=48):
    """Solve sites d-1..1 moving left; site 0 absorbs the final factor."""
    d, R, n, _ = x.shape
    Renv, Rb_env = boundary_envs(R, A.shape[1], b.shape[1], x.dtype,
                                 x.device)
    T = _e00(R, x.dtype, x.device)
    cores = [None] * d
    for k in range(d - 1, 0, -1):
        m_l, m_r = masks[k], masks[k + 1]
        with span("ttnx.als.solve"):
            # warm start: the CURRENT iterate's core = x_mid[k] @ T
            warm = torch.einsum("anb,bc->anc", x[k], T)
            V = _local_solve_padded(Lenvs[k], A[k], Renv, Lb_envs[k], b[k],
                                    Rb_env, m_l, m_r, v0=warm, solver=solver,
                                    cg_iters=cg_iters)
        with span("ttnx.als.orth"):
            if orth == "polar":
                qt, rt = polar_orth(V.reshape(R, n * R).T)
            else:
                qt, rt = torch.linalg.qr(V.reshape(R, n * R).T)
            core = qt.T.reshape(R, n, R) * m_l[:, None, None]
            T = rt.T * m_l[None, :]
        with span("ttnx.als.env"):
            Renv = right_env_update(core, A[k], Renv)
            Rb_env = right_env_b_update(core, b[k], Rb_env)
        cores[k] = core
    cores[0] = torch.einsum("anb,bc->anc", x[0], T)
    return torch.stack(cores)


def als_sweeps(A_stack, b_stack, x_stack, masks, sweep_count: int = 2,
               solver: str = "lu", orth: str = "qr", cg_iters: int = 48):
    """Run ``sweep_count`` ALS half-sweeps (2 = forward + backward). For real
    dtypes the environment stacks come from kernel B2's wrappers."""
    if solver not in SOLVERS:
        raise ValueError(
            "solver must be 'lu', 'cg', 'bicgstab', 'cg_fused' or "
            f"'bicgstab_fused', got {solver!r}")
    if orth not in ("qr", "polar"):
        raise ValueError(f"orth must be 'qr' or 'polar', got {orth!r}")
    fuse_envs = not x_stack.dtype.is_complex

    def masked(x):
        return (x * masks[1:][:, None, None, :]).contiguous()

    def right_envs(x):
        with span("ttnx.als.env"):
            if fuse_envs:
                return right_env_chain_fused(masked(x), A_stack, b_stack)
            return _right_env_stack(x, A_stack, b_stack, masks[1:])

    def left_envs(x):
        with span("ttnx.als.env"):
            if fuse_envs:
                return left_env_chain_fused(masked(x), A_stack, b_stack)
            return _left_env_stack(x, A_stack, b_stack, masks[1:])

    x = x_stack
    half = 0
    while half < sweep_count:
        Renvs, Rb_envs = right_envs(x)
        x = _forward_half_sweep(x, A_stack, b_stack, Renvs, Rb_envs, masks,
                                solver=solver, orth=orth, cg_iters=cg_iters)
        half += 1
        if half >= sweep_count:
            break
        Lenvs, Lb_envs = left_envs(x)
        x = _backward_half_sweep(x, A_stack, b_stack, Lenvs, Lb_envs, masks,
                                 solver=solver, orth=orth, cg_iters=cg_iters)
        half += 1
    return x


def als_linsolve_scan(A: TTOperator, b: TTVector, x0: TTVector,
                      sweep_count: int = 2, rmax: int | None = None):
    """Scan-tier ALS linear solve: pack, sweep, unpack. Ranks are those of
    ``x0`` (feasibility-clamped). All three inputs lie on one device."""
    x = orthogonalize(x0, 0)
    rks = x.ranks
    if rmax is None:
        rmax = max(max(rks), 2)
    dt = torch.promote_types(torch.promote_types(A.dtype, b.dtype), x.dtype)
    A_stack = pack_op(A.astype(dt), max(A.ranks))
    b_stack = pack_tt(b.astype(dt), max(b.ranks))
    x_stack = pack_tt(x.astype(dt), rmax)
    real_dt = torch.empty((), dtype=dt).real.dtype
    masks = rank_masks(rks, rmax, dtype=real_dt, device=x_stack.device)
    out = als_sweeps(A_stack, b_stack, x_stack, masks, sweep_count)
    return unpack_tt(out, rks)


# ---------------------------------------------------------------------------
# Eigensolve
# ---------------------------------------------------------------------------


def _local_eig_padded(L, Ac, Renv, m_l, m_r):
    """Smallest eigenpair of the masked local operator. Padded directions
    get a diagonal just above the spectral range (``norm(Km) + 1``): a huge
    constant would cost ``|pad| eps`` of eigh accuracy and break the
    variational bound."""
    R, n = L.shape[0], Ac.shape[1]
    M = R * n * R
    t = torch.einsum("aWb,WiJw->aibJw", L, Ac)
    K = torch.einsum("aibJw,cwd->aicbJd", t, Renv).reshape(M, M)
    maskv = (m_l[:, None, None] * m_r[None, None, :]).expand(R, n,
                                                             R).reshape(M)
    Km = K * maskv[:, None] * maskv[None, :]
    pad = torch.linalg.norm(Km) + 1.0  # > lambda_max of the active block
    K = Km + torch.diag(pad * (1.0 - maskv))
    K = 0.5 * (K + K.conj().T)
    w, U = torch.linalg.eigh(K)
    return w[0], U[:, 0].reshape(R, n, R)


def _forward_eig_half_sweep(x, A, Renvs, masks):
    """Local eigensolves at sites 0..d-2 moving right; the last site
    absorbs the pending factor. Returns the stack and the d-1 local
    eigenvalues in the order computed."""
    d, R, n, _ = x.shape
    L, _ = boundary_envs(R, A.shape[1], 1, x.dtype, x.device)
    T = _e00(R, x.dtype, x.device)
    cores, lams = [], []
    for k in range(d - 1):
        m_r = masks[k + 1]
        lam, V = _local_eig_padded(L, A[k], Renvs[k + 1], masks[k], m_r)
        q, r = torch.linalg.qr(V.reshape(R * n, R))
        core = (q * m_r[None, :]).reshape(R, n, R)
        T = r * m_r[:, None]
        L = left_env_update(core, L, A[k])
        cores.append(core)
        lams.append(lam)
    cores.append(torch.einsum("ab,bnc->anc", T, x[d - 1]))
    return torch.stack(cores), lams


def _backward_eig_half_sweep(x, A, Lenvs, masks):
    """Local eigensolves at sites d-1..1 moving left; site 0 absorbs the
    final factor."""
    d, R, n, _ = x.shape
    Renv, _ = boundary_envs(R, A.shape[1], 1, x.dtype, x.device)
    T = _e00(R, x.dtype, x.device)
    cores, lams = [None] * d, []
    for k in range(d - 1, 0, -1):
        m_l = masks[k]
        lam, V = _local_eig_padded(Lenvs[k], A[k], Renv, m_l, masks[k + 1])
        qt, rt = torch.linalg.qr(V.reshape(R, n * R).T)
        core = qt.T.reshape(R, n, R) * m_l[:, None, None]
        T = rt.T * m_l[None, :]
        Renv = right_env_update(core, A[k], Renv)
        cores[k] = core
        lams.append(lam)
    cores[0] = torch.einsum("anb,bc->anc", x[0], T)
    return torch.stack(cores), lams


def _env_stack_A(x, A, mask_r, left):
    """Operator-only env stack of the masked state: kernel B8 for real
    dtypes (it takes no complex), its plain version for complex ones."""
    xm = (x * mask_r[:, None, None, :]).contiguous()
    if x.dtype.is_complex:
        return env_chain_A_plain(xm, A, left=left)
    return env_chain_A_fused(xm, A, left=left)


def _right_env_stack_A(x, A, mask_r):
    """``Renv[i]`` = env of sites i..d-1, stacked ``(d+1, R, RA, R)``."""
    return _env_stack_A(x, A, mask_r, left=False)


def _left_env_stack_A(x, A, mask_r):
    """``Lenv[i]`` covers sites 0..i-1."""
    return _env_stack_A(x, A, mask_r, left=True)


def als_eigsolve_sweeps(A_stack, x_stack, masks, n_sweeps: int = 2):
    """Fixed-rank ALS eigensolver: ``n_sweeps`` full (forward + backward)
    sweeps, TF32 off; returns ``(x_stack, energies)``, the ``2 (d - 1)``
    local eigenvalues of each sweep in the order computed. Two B8 launches
    a sweep for real dtypes."""
    x = x_stack
    lams = []
    with matmul_precision("highest"):
        for _ in range(n_sweeps):
            Renvs = _right_env_stack_A(x, A_stack, masks[1:])
            x, lams_f = _forward_eig_half_sweep(x, A_stack, Renvs, masks)
            Lenvs = _left_env_stack_A(x, A_stack, masks[1:])
            x, lams_b = _backward_eig_half_sweep(x, A_stack, Lenvs, masks)
            lams += lams_f + lams_b
    return x, torch.stack(lams)


def als_eigsolve_scan(A: TTOperator, x0: TTVector, n_sweeps: int = 2,
                      rmax: int | None = None):
    """Scan-tier fixed-rank ALS eigensolve at the ranks of ``x0``; returns
    ``(E, x)``: every local eigenvalue (host numpy, real) and the state.
    Both inputs lie on one device."""
    x = orthogonalize(x0, 0)
    rks = x.ranks
    if rmax is None:
        rmax = max(max(rks), 2)
    dt = torch.promote_types(A.dtype, x.dtype)
    A_stack = pack_op(A.astype(dt), max(A.ranks))
    x_stack = pack_tt(x.astype(dt), rmax)
    real_dt = torch.empty((), dtype=dt).real.dtype
    masks = rank_masks(rks, rmax, dtype=real_dt, device=x_stack.device)
    out, lams = als_eigsolve_sweeps(A_stack, x_stack, masks, n_sweeps)
    return lams.real.cpu().numpy(), unpack_tt(out, rks)
