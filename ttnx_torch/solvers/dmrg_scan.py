"""Rank-adaptive two-site DMRG on padded stacks: the eigensweep with
matrix-free (or dense-K) Lanczos local solves and the linear-solve sweep
with matrix-free CG local solves.

Twin of ``ttnx.solvers.dmrg_scan``. Cores are stacked ``(d, R, n, R)`` and
padded to ``rmax``; the realized ranks are 0/1 masks ``(d+1, R)``, so
truncation never changes a buffer shape. The keep rule is the reference's
relative threshold extended so a near-degenerate multiplet is never split
(:func:`cut_off_mask`). Krylov vectors live in the masked subspace; dead
Krylov directions (subspace smaller than the iteration budget) are found
by exact-zero basis rows and pushed above the spectral range in the small
tridiagonal eigenproblem.

Kernels: on real dtypes both environment stacks of :func:`dmrg_eig_sweep`
come from B8 (:func:`ttnx_torch.kernels.env_chain.env_chain_A_fused`), and
``eig_solver='lanczos_fused'`` runs each local Lanczos through B9
(:func:`ttnx_torch.kernels.lanczos.lanczos_fused`) where
:func:`~ttnx_torch.kernels.lanczos.can_fuse_lanczos` holds. Each wrapper
launches its Hopper kernel on CUDA tensors and runs its plain version on
CPU tensors. The sweeps run with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from ttnx_torch.config import matmul_precision
from ttnx_torch.core.canonical import orthogonalize
from ttnx_torch.core.linalg import thin_svd
from ttnx_torch.core.tt import TTOperator, TTVector
from ttnx_torch.kernels.env_chain import (boundary_envs, env_chain_A_fused,
                                          env_chain_A_plain,
                                          left_env_b_update, left_env_update,
                                          right_env_b_update,
                                          right_env_update)
from ttnx_torch.kernels.lanczos import can_fuse_lanczos, lanczos_fused
from ttnx_torch.kernels.local_cg import _safe_div
from ttnx_torch.solvers.als_scan import (_left_env_stack, _right_env_stack,
                                         pack_op, pack_tt, rank_masks,
                                         unpack_tt)

__all__ = ["dmrg_sweep", "dmrg_linsolve_scan", "dmrg_eig_sweep",
           "dmrg_eigsolve_scan", "cut_off_mask"]

EIG_SOLVERS = ("lanczos", "lanczos_fused")
SPLITS = ("svd", "gram")


def cut_off_mask(s, tol, degen_tol=1e-10):
    """0/1 keep mask over the singular values ``s`` (descending): keep
    ``s > tol * |s|`` and ``s[0]``, then extend the cut while neighbouring
    values are within ``degen_tol`` of each other (a near-degenerate
    multiplet is never split).

    The reference's recurrence ``keep[i] = base[i] or (keep[i-1] and
    close[i-1])`` holds exactly when every ``close`` between the last
    ``base`` index at or before ``i`` and ``i`` is true; that form needs no
    loop over the entries."""
    R = s.shape[0]
    base = s > tol * torch.linalg.norm(s)
    base[0] = True
    a, b = s[:-1].abs(), s[1:].abs()
    close = (s[:-1] - s[1:]).abs() <= degen_tol + degen_tol * torch.maximum(
        a, b)
    idx = torch.arange(R, device=s.device)
    last_base = torch.cummax(torch.where(base, idx, 0), dim=0).values
    breaks = torch.cat([torch.zeros(1, dtype=torch.long, device=s.device),
                        torch.cumsum((~close).long(), dim=0)])
    keep = breaks == breaks[last_base]
    return keep.to(s.dtype)


# ---------------------------------------------------------------------------
# Two-site local operator
# ---------------------------------------------------------------------------


def _window_mask(m_l, m_r, n):
    return (m_l[:, None, None, None] * m_r[None, None, None, :]).expand(
        -1, n, n, -1)


def _apply2(L, Ai, Aj, Renv, v):
    """Two-site effective operator on ``v[b, I, J, d]``, bra order
    ``[a, i, j, c]``: ``sum L[a,W,b] Ai[W,i,I,w] Aj[w,j,J,v] Renv[c,v,d]
    v[b,I,J,d]`` as pairwise contractions."""
    t = torch.einsum("bIJd,cvd->bIJcv", v, Renv)
    t = torch.einsum("bIJcv,wjJv->bIcwj", t, Aj)
    t = torch.einsum("bIcwj,WiIw->bcjWi", t, Ai)
    return torch.einsum("aWb,bcjWi->aijc", L, t)


def _assemble_K2(L, Ai, Aj, Renv, maskf):
    """Dense masked two-site operator ``K (M, M)``, ``M = R n n R``."""
    R, n = L.shape[0], Ai.shape[1]
    M = R * n * n * R
    t = torch.einsum("aWb,WiIw->abiIw", L, Ai)
    t = torch.einsum("abiIw,wjJv->abiIjJv", t, Aj)
    K = torch.einsum("abiIjJv,cvd->aijcbIJd", t, Renv).reshape(M, M)
    # masked in place: at M = 16384 (R = 64) K alone is 2 GB in f64
    return K.mul_(maskf[:, None]).mul_(maskf[None, :])


def _start_vector(v0, maskf):
    """Masked, normalized warm start; the normalized mask when it is
    (numerically) zero."""
    M = maskf.shape[0]
    v0f = v0.reshape(M) * maskf
    nrm0 = torch.linalg.norm(v0f)
    fallback = maskf / torch.clamp(torch.linalg.norm(maskf), min=1e-30)
    return torch.where(nrm0 > 1e-12, v0f / torch.clamp(nrm0, min=1e-30),
                       fallback.to(v0f.dtype))


def _ritz_from_lanczos(basis, alphas, betas, mask4, shape):
    """Smallest Ritz pair from a Lanczos run: dead directions (exact-zero
    basis rows) padded above the spectral range, tridiagonal eigh,
    recombination."""
    alive = torch.sum(basis.abs() ** 2, dim=1) > 0.0
    pad = alphas.abs().max() + 2.0 * betas.abs().max() + 1.0
    alphas = torch.where(alive, alphas, pad)
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    theta, Y = torch.linalg.eigh(T)
    ritz = (basis.T @ Y[:, 0].to(basis.dtype)).reshape(shape)
    ritz = ritz / torch.clamp(torch.linalg.norm(ritz), min=1e-30)
    return theta[0], ritz * mask4


def _lanczos_eigmin(L, Ai, Aj, Renv, v0, mask4, iters: int):
    """Smallest Ritz pair of the masked two-site operator by matrix-free
    fixed-iteration Lanczos with full reorthogonalization, warm-started at
    ``v0``."""
    R, n = v0.shape[0], v0.shape[1]
    M = R * n * n * R
    maskf = mask4.reshape(M).to(v0.dtype)
    rdt = v0.real.dtype

    def apply_flat(vf):
        out = _apply2(L, Ai, Aj, Renv, (vf * maskf).reshape(R, n, n, R))
        return out.reshape(M) * maskf

    basis = torch.zeros((iters, M), dtype=v0.dtype, device=v0.device)
    basis[0] = _start_vector(v0, mask4.reshape(M))
    alphas = torch.zeros(iters, dtype=rdt, device=v0.device)
    betas = torch.zeros(iters, dtype=rdt, device=v0.device)
    dead = torch.zeros((), dtype=torch.bool, device=v0.device)
    for j in range(iters):
        vj = basis[j]
        w = apply_flat(vj)
        alphas[j] = torch.vdot(vj, w).real
        for _ in range(2):  # full reorthogonalization against every row
            w = w - basis.T @ (basis.conj() @ w)
        b = torch.linalg.norm(w)
        dead = dead | (b < 1e-12)
        betas[j] = torch.where(dead, 0.0, b)
        if j + 1 < iters:
            basis[j + 1] = torch.where(dead, 0.0, w / torch.clamp(b,
                                                                  min=1e-30))
    return _ritz_from_lanczos(basis, alphas, betas, mask4, (R, n, n, R))


def _lanczos_eigmin_fused(L, Ai, Aj, Renv, v0, mask4, iters: int):
    """:func:`_lanczos_eigmin` through kernel B9: assemble the dense masked
    two-site operator (4 MB in f32 at M = 1024) and run every Lanczos step
    in one launch. Complex dtypes and ``M > 1024`` take the matrix-free
    form."""
    R, n = v0.shape[0], v0.shape[1]
    M = R * n * n * R
    if not can_fuse_lanczos(v0.dtype, M):
        return _lanczos_eigmin(L, Ai, Aj, Renv, v0, mask4, iters)
    maskf = mask4.reshape(M).to(v0.dtype)
    K = _assemble_K2(L, Ai, Aj, Renv, maskf)
    basis, alphas, betas = lanczos_fused(K, _start_vector(v0, maskf),
                                         iters=iters)
    return _ritz_from_lanczos(basis, alphas, betas, mask4, (R, n, n, R))


def _cg_solve2(L, Ai, Aj, Renv, Lb, bi, bj, Rb_env, v0, mask4, iters: int):
    """Fixed-iteration CG on the masked two-site system (SPD local
    operators), warm-started at ``v0``."""
    t = torch.einsum("au,uiv->aiv", Lb, bi)
    t = torch.einsum("aiv,vjw->aijw", t, bj)
    rhs = torch.einsum("aijw,cw->aijc", t, Rb_env) * mask4

    def apply_k(v):
        return _apply2(L, Ai, Aj, Renv, v * mask4) * mask4

    def vdot(a, b):
        return torch.vdot(a.reshape(-1), b.reshape(-1))

    x = v0 * mask4
    r = rhs - apply_k(x)
    p = r
    rs = vdot(r, r)
    for _ in range(iters):
        ap = apply_k(p)
        alpha = _safe_div(rs, vdot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = vdot(r, r)
        p = r + _safe_div(rs_new, rs) * p
        rs = rs_new
    return x


# ---------------------------------------------------------------------------
# Splits of the two-site block
# ---------------------------------------------------------------------------


def _gram_eigh(B):
    """``eigh`` of the symmetrized Gram ``B`` (ascending). On the CPU,
    MKL's single-precision solver has returned NaN eigenvectors for a
    nearly-all-zero Gram (a rank-4 block padded to 32 x 32, torch 2.13);
    such a result is recomputed in double precision and cast back. CUDA
    tensors are not checked: the check would synchronize."""
    B = 0.5 * (B + B.conj().T)
    w, U = torch.linalg.eigh(B)
    if (B.device.type == "cpu" and B.dtype in (torch.float32,
                                                torch.complex64)
            and not bool(torch.isfinite(U).all())):
        wide = torch.complex128 if B.dtype.is_complex else torch.float64
        w, U = torch.linalg.eigh(B.to(wide))
        w, U = w.to(B.real.dtype), U.to(B.dtype)
    return w, U


def _split_right(V, tol, degen_tol, R, n, method="svd"):
    """``V ≈ core · rest`` with a left-orthonormal ``core``; returns
    ``(core, rest, keep)``. ``'gram'`` takes the eigh of the (Rn, Rn)
    Gram in place of the SVD (squared-condition accuracy)."""
    Vm = V.reshape(R * n, n * R)
    if method == "gram":
        w, U = _gram_eigh(Vm @ Vm.conj().T)
        s = torch.sqrt(torch.clamp(w.flip(0), min=0.0))
        u = U.flip(1)
        svt = u.conj().T @ Vm
    else:
        u, s, vt = thin_svd(Vm)
        svt = s[:, None] * vt
    keep = cut_off_mask(s, tol, degen_tol)[:R]
    core = (u[:, :R] * keep[None, :]).reshape(R, n, R)
    rest = (svt[:R, :] * keep[:, None]).reshape(R, n, R)
    return core, rest, keep


def _split_left(V, tol, degen_tol, R, n, method="svd"):
    """``V ≈ rest · core`` with a right-orthonormal ``core``."""
    Vm = V.reshape(R * n, n * R)
    if method == "gram":
        w, W = _gram_eigh(Vm.conj().T @ Vm)
        s = torch.sqrt(torch.clamp(w.flip(0), min=0.0))
        v2 = W.flip(1)                       # right singular vectors
        vt = v2.conj().T
        us = Vm @ v2                         # columns u_i * s_i
    else:
        u, s, vt = thin_svd(Vm)
        us = u * s[None, :]
    keep = cut_off_mask(s, tol, degen_tol)[:R]
    core = (vt[:R, :] * keep[:, None]).reshape(R, n, R)
    rest = (us[:, :R] * keep[None, :]).reshape(R, n, R)
    return core, rest, keep


def _check_options(split, eig_solver=None):
    if split not in SPLITS:
        raise ValueError(f"split must be 'svd' or 'gram', got {split!r}")
    if eig_solver is not None and eig_solver not in EIG_SOLVERS:
        raise ValueError(f"unknown eig_solver {eig_solver!r}")


def _real_scalar(v, like):
    return torch.as_tensor(v, dtype=like.real.dtype, device=like.device)


def _first_mask(mask_stack):
    m0 = torch.zeros_like(mask_stack[0])
    m0[0] = 1.0
    return m0


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------


def dmrg_eig_sweep(A_stack, x_stack, mask_stack, tol, degen_tol,
                   lanczos_iters: int = 24, eig_solver: str = "lanczos",
                   split: str = "svd"):
    """One full (forward + backward) two-site DMRG eigensweep with Lanczos
    local solves and warm starts; returns ``(x_stack, mask_stack,
    energies)`` with the ``2 (d - 1)`` local Ritz values in the order they
    were computed.

    ``eig_solver='lanczos'`` is the matrix-free form; ``'lanczos_fused'``
    assembles the dense masked two-site operator and runs the iteration in
    kernel B9 where ``M <= 1024``. On real dtypes both env stacks come
    from kernel B8."""
    _check_options(split, eig_solver)
    eigmin = (_lanczos_eigmin_fused if eig_solver == "lanczos_fused"
              else _lanczos_eigmin)
    d, R, n, _ = x_stack.shape
    dt = x_stack.dtype
    RA = A_stack.shape[1]
    tol = _real_scalar(tol, x_stack)
    degen_tol = _real_scalar(degen_tol, x_stack)

    def envs(x, masks, left):
        xm = (x * masks[1:][:, None, None, :]).contiguous()
        if dt.is_complex:
            return env_chain_A_plain(xm, A_stack, left=left)
        return env_chain_A_fused(xm, A_stack, left=left)

    with matmul_precision("highest"):
        Renvs = envs(x_stack, mask_stack, left=False)
        L, _ = boundary_envs(R, RA, 1, dt, x_stack.device)
        m_l, last = _first_mask(mask_stack), x_stack[0]
        fwd_cores, fwd_masks, lams = [], [], []
        for k in range(d - 1):
            Ai, Aj, m_r = A_stack[k], A_stack[k + 1], mask_stack[k + 2]
            mask4 = _window_mask(m_l, m_r, n)
            v0 = torch.einsum("anb,bmc->anmc", last,
                              x_stack[k + 1] * m_r[None, None, :])
            lam, V = eigmin(L, Ai, Aj, Renvs[k + 2], v0, mask4,
                            lanczos_iters)
            core, last, m_l = _split_right(V, tol, degen_tol, R, n, split)
            L = left_env_update(core, L, Ai)
            fwd_cores.append(core)
            fwd_masks.append(m_l)
            lams.append(lam)
        x_mid = torch.stack(fwd_cores + [last])
        masks_mid = torch.stack([mask_stack[0]] + fwd_masks
                                + [mask_stack[d]])

        Lenvs = envs(x_mid, masks_mid, left=True)
        Renv, _ = boundary_envs(R, RA, 1, dt, x_stack.device)
        m_r, first = _first_mask(mask_stack), x_mid[d - 1]
        bwd_cores, bwd_masks = [None] * (d - 1), [None] * (d - 1)
        for k in range(d - 2, -1, -1):
            Ai, Aj, m_l = A_stack[k], A_stack[k + 1], masks_mid[k]
            mask4 = _window_mask(m_l, m_r, n)
            v0 = torch.einsum("anb,bmc->anmc",
                              x_mid[k] * m_l[:, None, None], first)
            lam, V = eigmin(Lenvs[k], Ai, Aj, Renv, v0, mask4,
                            lanczos_iters)
            core, first, m_r = _split_left(V, tol, degen_tol, R, n, split)
            Renv = right_env_update(core, Aj, Renv)
            bwd_cores[k], bwd_masks[k] = core, m_r
            lams.append(lam)
        x_out = torch.stack([first] + bwd_cores)
        masks_out = torch.stack([mask_stack[0]] + bwd_masks
                                + [mask_stack[d]])
        return x_out, masks_out, torch.stack(lams)


def dmrg_sweep(A_stack, b_stack, x_stack, mask_stack, tol, degen_tol,
               cg_iters: int = 48, split: str = "svd"):
    """One full two-site DMRG linear-solve sweep (warm-started CG local
    solves on SPD ``A``); returns ``(x_stack, mask_stack)``. Plain torch:
    the JAX package runs no kernel here either."""
    _check_options(split)
    d, R, n, _ = x_stack.shape
    dt = x_stack.dtype
    RA, Rb = A_stack.shape[1], b_stack.shape[1]
    tol = _real_scalar(tol, x_stack)
    degen_tol = _real_scalar(degen_tol, x_stack)

    with matmul_precision("highest"):
        Renvs, Rb_envs = _right_env_stack(x_stack, A_stack, b_stack,
                                          mask_stack[1:])
        L, Lb = boundary_envs(R, RA, Rb, dt, x_stack.device)
        m_l, last = _first_mask(mask_stack), x_stack[0]
        fwd_cores, fwd_masks = [], []
        for k in range(d - 1):
            Ai, Aj, m_r = A_stack[k], A_stack[k + 1], mask_stack[k + 2]
            bi, bj = b_stack[k], b_stack[k + 1]
            mask4 = _window_mask(m_l, m_r, n)
            v0 = torch.einsum("anb,bmc->anmc", last,
                              x_stack[k + 1] * m_r[None, None, :])
            V = _cg_solve2(L, Ai, Aj, Renvs[k + 2], Lb, bi, bj,
                           Rb_envs[k + 2], v0, mask4, cg_iters)
            core, last, m_l = _split_right(V, tol, degen_tol, R, n, split)
            L = left_env_update(core, L, Ai)
            Lb = left_env_b_update(core, Lb, bi)
            fwd_cores.append(core)
            fwd_masks.append(m_l)
        x_mid = torch.stack(fwd_cores + [last])
        masks_mid = torch.stack([mask_stack[0]] + fwd_masks
                                + [mask_stack[d]])

        Lenvs, Lb_envs = _left_env_stack(x_mid, A_stack, b_stack,
                                         masks_mid[1:])
        Renv, Rb_env = boundary_envs(R, RA, Rb, dt, x_stack.device)
        m_r, first = _first_mask(mask_stack), x_mid[d - 1]
        bwd_cores, bwd_masks = [None] * (d - 1), [None] * (d - 1)
        for k in range(d - 2, -1, -1):
            Ai, Aj, m_l = A_stack[k], A_stack[k + 1], masks_mid[k]
            bi, bj = b_stack[k], b_stack[k + 1]
            mask4 = _window_mask(m_l, m_r, n)
            v0 = torch.einsum("anb,bmc->anmc",
                              x_mid[k] * m_l[:, None, None], first)
            V = _cg_solve2(Lenvs[k], Ai, Aj, Renv, Lb_envs[k], bi, bj,
                           Rb_env, v0, mask4, cg_iters)
            core, first, m_r = _split_left(V, tol, degen_tol, R, n, split)
            Renv = right_env_update(core, Aj, Renv)
            Rb_env = right_env_b_update(core, bj, Rb_env)
            bwd_cores[k], bwd_masks[k] = core, m_r
        x_out = torch.stack([first] + bwd_cores)
        masks_out = torch.stack([mask_stack[0]] + bwd_masks
                                + [mask_stack[d]])
        return x_out, masks_out


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def _init_masks(x: TTVector, rmax: int, real_dt):
    return rank_masks(x.ranks, rmax, dtype=real_dt, device=x.device)


def _default_rmax(x0: TTVector) -> int:
    return min(int(round(np.sqrt(float(np.prod(x0.dims))))), 64)


def _packed(A: TTOperator, x0: TTVector, rmax, *extra: TTVector):
    x = orthogonalize(x0, 0)
    dt = A.dtype
    for t in (x, *extra):
        dt = torch.promote_types(dt, t.dtype)
    real_dt = torch.empty((), dtype=dt).real.dtype
    stacks = [pack_op(A.astype(dt), max(A.ranks))]
    stacks += [pack_tt(t.astype(dt), max(t.ranks)) for t in extra]
    stacks.append(pack_tt(x.astype(dt), rmax))
    return stacks, _init_masks(x, rmax, real_dt)


def dmrg_eigsolve_scan(A: TTOperator, x0: TTVector, tol: float = 1e-12,
                       degen_tol: float = 1e-10, rmax: int | None = None,
                       n_sweeps: int = 2, lanczos_iters: int = 24,
                       eig_solver: str = "lanczos", split: str = "svd"):
    """Rank-adaptive two-site DMRG ground-state solver: ``n_sweeps`` calls
    of :func:`dmrg_eig_sweep`. Returns ``(E, x)``: every local Ritz value
    of every sweep (host numpy, real) and the state with its realized
    ranks."""
    if rmax is None:
        rmax = _default_rmax(x0)
    (A_stack, x_stack), masks = _packed(A, x0, rmax)
    energies = []
    for _ in range(n_sweeps):
        x_stack, masks, lams = dmrg_eig_sweep(
            A_stack, x_stack, masks, tol, degen_tol,
            lanczos_iters=lanczos_iters, eig_solver=eig_solver, split=split)
        energies.append(lams.real.cpu().numpy())
    rks = [int(v) for v in masks.sum(dim=1).tolist()]
    return np.concatenate(energies), unpack_tt(x_stack, rks)


def dmrg_linsolve_scan(A: TTOperator, b: TTVector, x0: TTVector,
                       tol: float = 1e-12, degen_tol: float = 1e-10,
                       rmax: int | None = None, n_sweeps: int = 1,
                       cg_iters: int = 48):
    """Rank-adaptive two-site DMRG linear solve (SPD ``A``) with
    matrix-free CG local solves; returns the solution TT with its realized
    ranks."""
    if rmax is None:
        rmax = _default_rmax(x0)
    (A_stack, b_stack, x_stack), masks = _packed(A, x0, rmax, b)
    for _ in range(n_sweeps):
        x_stack, masks = dmrg_sweep(A_stack, b_stack, x_stack, masks, tol,
                                    degen_tol, cg_iters=cg_iters)
    rks = [int(v) for v in masks.sum(dim=1).tolist()]
    return unpack_tt(x_stack, rks)
