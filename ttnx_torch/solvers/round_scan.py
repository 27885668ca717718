"""Padded-rank MPO application, TT rounding, and the Crank–Nicolson step
built from them.

All shapes are fixed per problem: the MPO application blows the padded
rank up to ``RA * R`` in one batched einsum, the rounding truncates back to
a fixed target ``R_out``, and :func:`ttnx_torch.solvers.als_scan.als_sweeps`
solves the implicit system. The Gram-chain rounding's backward sweep is
kernel B1 (:mod:`ttnx_torch.kernels.gram`) for real dtypes.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from ttnx_torch.core.linalg import thin_svd
from ttnx_torch.core.tt import r_and_d_to_rks
from ttnx_torch.kernels.gram import gram_chain_fused, gram_chain_plain
from ttnx_torch.solvers.als_scan import (SOLVERS, als_sweeps, pack_op,
                                         pack_tt, rank_masks, unpack_tt)
from ttnx_torch.utils.profiling import span

__all__ = ["matvec_padded", "tt_round_scan", "tt_round_gram", "round_masks",
           "cn_step", "make_cn_step", "make_cn_evolve", "matmul_precision"]


def matvec_padded(A_stack, x_stack):
    """Padded MPO·MPS: ``y (d, RA*R, n, RA*R)`` from ``A (d, RA, n, n, RA)``
    and ``x (d, R, n, R)`` — one batched einsum over the site axis."""
    d, RA, n, _, _ = A_stack.shape
    R = x_stack.shape[1]
    y = torch.einsum("kaijb,kcjd->kacibd", A_stack, x_stack)
    return y.reshape(d, RA * R, n, RA * R)


def _gram_lq(cm, R):
    """``cm (R, nR) = T @ q``: q has orthonormal rows on the row space of
    cm and zero rows in its null space; ``T = (cm cm^H)^{1/2}``."""
    return _gram_sqrt(cm @ cm.conj().T, cm, R)


def _gram_sqrt(G, cm, R):
    """:func:`_gram_lq` from the Gram matrix ``G = cm cm^H`` (``cm`` may be
    a column block of the matrix whose Gram ``G`` is)."""
    w, V = torch.linalg.eigh(G)
    s = torch.sqrt(torch.clamp(w.real, min=0.0))
    cutoff = torch.finfo(s.dtype).eps * R * torch.max(s)
    keep = s > cutoff
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    s_kept = torch.where(keep, s, torch.zeros_like(s))
    q = (V * s_inv[None, :].to(V.dtype)) @ (V.conj().T @ cm)
    T = (V * s_kept[None, :].to(V.dtype)) @ V.conj().T
    return q, T


def _right_orth_scan(y, masks_r, method: str = "qr"):
    """Right-orthogonalize the padded chain (masked LQ sweep); site 0 holds
    the center. ``'qr'`` uses Householder QR of the transposed site;
    ``'gram'`` factors each site through one eigh of its Gram matrix. Both
    are exact for scattered (Kronecker-pattern) masks."""
    d, R, n, _ = y.shape
    T = torch.zeros((R, R), dtype=y.dtype, device=y.device)
    T[0, 0] = 1.0
    cores = [None] * d
    for k in range(d - 1, 0, -1):
        m_l = masks_r[k]
        c = torch.einsum("anb,bc->anc", y[k], T)
        if method == "gram":
            q2, t2 = _gram_lq(c.reshape(R, n * R), R)
            cores[k] = q2.reshape(R, n, R) * m_l[:, None, None]
            T = t2 * m_l[None, :]
        else:
            # Masking a Householder LQ is exact only when the active rows of
            # c come first; an applied chain's masks are scattered
            # (Kronecker pattern). Factor with the active rows moved to the
            # front (stable) and undo the move in T; the new bond is then a
            # prefix of the same size.
            perm = torch.argsort(m_l, descending=True, stable=True)
            prefix = m_l[perm]
            qt, rt = torch.linalg.qr(c[perm].reshape(R, n * R).T)
            cores[k] = qt.T.reshape(R, n, R) * prefix[:, None, None]
            T = rt.T[torch.argsort(perm)] * prefix[None, :]
    cores[0] = torch.einsum("anb,bc->anc", y[0], T)
    return torch.stack(cores)


def _truncate_last(T, y_last, R_out):
    """Last site absorbs the transfer; boundary rank 1, padded to R_out."""
    last = torch.einsum("ab,bnc->anc", T, y_last)[:, :, :1]
    return torch.nn.functional.pad(last, (0, R_out - 1))


def tt_round_scan(y, masks_y, R_out: int, masks_out, method: str = "svd"):
    """Truncate a padded chain to buffer rank ``R_out``: right-orthogonalize,
    then a left-to-right masked truncation keeping the top ``R_out``
    singular directions per bond. ``'svd'`` truncates via the site SVD,
    ``'gram'`` via an eigh of each site's small Gram matrix."""
    with span("ttnx.round"):
        d, R, n, _ = y.shape
        y = _right_orth_scan(y, masks_y, method=method)
        k = min(R_out, R)
        T = torch.zeros((R_out, R), dtype=y.dtype, device=y.device)
        T[0, 0] = 1.0
        cores = []
        for site in range(d - 1):
            m_r_out = masks_out[site + 1]
            c = torch.einsum("ab,bnc->anc", T, y[site])
            cm = c.reshape(R_out * n, R)
            if method == "gram":
                w, V = torch.linalg.eigh(cm @ cm.conj().T)
                u_k = torch.flip(V, dims=[1])[:, :k]
                t_k = u_k.conj().T @ cm
            else:
                u, s, vt = thin_svd(cm)
                u_k = u[:, :k]
                t_k = s[:k, None].to(vt.dtype) * vt[:k, :]
            u_k = u_k * m_r_out[None, :k]
            pad = torch.zeros((R_out * n, R_out - k), dtype=cm.dtype,
                              device=cm.device)
            cores.append(torch.cat([u_k, pad], dim=1).reshape(R_out, n, R_out))
            t_k = t_k * m_r_out[:k, None]
            T = torch.cat([t_k, torch.zeros((R_out - k, R), dtype=cm.dtype,
                                            device=cm.device)], dim=0)
        cores.append(_truncate_last(T, y[d - 1], R_out))
        return torch.stack(cores)


def tt_round_gram(y, R_out: int, masks_out):
    """Gram-chain rounding: a backward pure-matmul sweep (kernel B1 for real
    dtypes) gives the right Gram matrices ``G_k`` of the unorthogonalized
    chain, then one left-to-right sweep truncates each bond with one small
    eigh of ``B = c G_{k+1} c^H``, the exact Gram of the remaining
    matricization. Squares the condition number for directions below
    ``sqrt(eps) * sigma_max`` — the f32 device trade."""
    d, R, n, _ = y.shape
    if R_out > R:
        raise ValueError(f"R_out={R_out} must be <= padded rank {R}")
    with span("ttnx.round"):
        Gs = gram_chain_plain(y) if y.dtype.is_complex else gram_chain_fused(y)
        T = torch.zeros((R_out, R), dtype=y.dtype, device=y.device)
        T[0, 0] = 1.0
        cores = []
        for k in range(d - 1):
            m_r_out = masks_out[k + 1]
            cm = torch.einsum("ab,bnc->anc", T, y[k]).reshape(R_out * n, R)
            B = (cm @ Gs[k]) @ cm.conj().T
            B = 0.5 * (B + B.conj().T)
            w, V = torch.linalg.eigh(B)
            u_k = torch.flip(V, dims=[1])[:, :R_out] * m_r_out[None, :]
            T = (u_k.conj().T @ cm) * m_r_out[:, None]
            cores.append(u_k.reshape(R_out, n, R_out))
        cores.append(_truncate_last(T, y[d - 1], R_out))
        return torch.stack(cores)


def round_masks(in_rks, R_out: int, dims):
    """Output rank vector for rounding to cap ``R_out`` (host side)."""
    return r_and_d_to_rks([min(r, R_out) for r in in_rks], dims, rmax=R_out)


@contextmanager
def matmul_precision(precision: str | None):
    """``'highest'`` turns TF32 off for matmuls and cuDNN inside the block
    and restores the previous flags afterwards; ``None`` or ``'float32'``
    leave the flags as they are."""
    if precision != "highest":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def cn_step(lhs_stack, rhs_stack, u_stack, guess_noise, masks_u,
            masks_rhs_big, masks_u_out, sweep_count: int = 4,
            solver: str = "lu", orth: str = "qr", round_rhs: bool = True,
            round_method: str = "svd", precision: str | None = None,
            cg_iters: int = 48):
    """One Crank–Nicolson step: ``u <- ALS-solve(lhs, round(rhs_op @ u))``.

    ``guess_noise`` (masked, ~1e-3 of the state scale) goes into the ALS
    guess only: a rank-deficient state makes the ALS environments singular;
    the converged solution does not depend on the guess, so the noise never
    reaches the output while the rhs stays exact. ``precision='highest'``
    keeps every matmul of the step in full f32 (no TF32)."""
    with matmul_precision(precision):
        R_out = u_stack.shape[1]
        big = matvec_padded(rhs_stack, u_stack)
        if not round_rhs:
            b = big
        elif round_method == "gram_chain":
            b = tt_round_gram(big, R_out, masks_u_out)
        else:
            b = tt_round_scan(big, masks_rhs_big, R_out, masks_u_out,
                              method=round_method)
        return als_sweeps(lhs_stack, b, u_stack + guess_noise, masks_u,
                          sweep_count, solver=solver, orth=orth,
                          cg_iters=cg_iters)


def _cn_parts(A, h: float, rmax: int, dims, u_rks, dtype):
    """The operands of a CN step on ``A``'s device: ``I -/+ h/2 A``
    packed, the state's feasible ranks and masks, the masks of the applied
    chain and of its rounding, and the masked guess noise."""
    from ttnx_torch.core.algebra import add_op, scale_op
    from ttnx_torch.core.tt import id_tto

    d = len(dims)
    device = A.device
    A = A.astype(dtype)
    eye = id_tto(d, dtype=dtype, device=device)
    lhs = add_op(eye, scale_op(-h / 2, A))
    rhs = add_op(eye, scale_op(h / 2, A))
    RA = max(rhs.ranks)
    u_rks = r_and_d_to_rks(u_rks, dims, rmax=rmax)
    real_dt = torch.empty((), dtype=dtype).real.dtype
    masks_u = rank_masks(u_rks, rmax, dtype=real_dt, device=device)
    # the applied chain's active positions are the Kronecker pattern
    # {a*R + c : a < rA, c < rx}, a scattered set: outer products of masks
    masks_A = np.zeros((d + 1, RA))
    for i, r in enumerate(rhs.ranks):
        masks_A[i, :r] = 1.0
    masks_u_np = masks_u.cpu().numpy()
    masks_big = torch.as_tensor(np.stack(
        [np.outer(masks_A[i], masks_u_np[i]).reshape(-1)
         for i in range(d + 1)]), dtype=real_dt, device=device)
    big_rks = [min(a * b, RA * rmax) for a, b in zip(rhs.ranks, u_rks)]
    masks_out = rank_masks(round_masks(big_rks, rmax, dims), rmax,
                           dtype=real_dt, device=device)

    # masked guess noise: the same numpy stream as the JAX package
    rng = np.random.default_rng(0)
    noise_np = np.zeros((d, rmax, 2, rmax))
    for i in range(d):
        noise_np[i, : u_rks[i], :, : u_rks[i + 1]] = 1e-3 * rng.standard_normal(
            (u_rks[i], 2, u_rks[i + 1]))
    return dict(lhs_stack=pack_op(lhs, max(lhs.ranks)),
                rhs_stack=pack_op(rhs, RA), RA=RA, u_rks=u_rks,
                masks_u=masks_u, masks_big=masks_big, masks_out=masks_out,
                guess_noise=torch.as_tensor(noise_np, dtype=dtype,
                                            device=device))


def _cn_pack(u, rmax: int, dtype, device):
    """A TTVector as the packed state of a CN step (rounded to ``rmax``
    first where it is wider)."""
    from ttnx_torch.core.canonical import tt_round

    if max(u.ranks) > rmax:
        u = tt_round(u, max_bond=rmax)
    return pack_tt(u.astype(dtype).to(device), rmax)


def make_cn_step(A, h: float, rmax: int, dims, u_rks, dtype=torch.float64,
                 sweep_count: int = 4, solver: str = "lu", orth: str = "qr",
                 round_rhs: bool = True, round_method: str = "svd",
                 precision: str | None = None, cg_iters: int = 48):
    """Setup for :func:`cn_step` on ``du/dt = A u``: packs ``I -/+ h/2 A``
    and builds all masks on ``A``'s device. Returns
    ``(step_fn, pack, unpack)``; ``pack`` copies a TTVector to that
    device."""
    if round_method not in ("svd", "gram", "gram_chain"):
        raise ValueError("round_method must be 'svd', 'gram' or "
                         f"'gram_chain', got {round_method!r}")
    if solver not in SOLVERS:
        raise ValueError(
            "solver must be 'lu', 'cg', 'bicgstab', 'cg_fused' or "
            f"'bicgstab_fused', got {solver!r}")
    if orth not in ("qr", "polar"):
        raise ValueError(f"orth must be 'qr' or 'polar', got {orth!r}")
    c = _cn_parts(A, h, rmax, dims, u_rks, dtype)

    def step_fn(u_stack):
        return cn_step(c["lhs_stack"], c["rhs_stack"], u_stack,
                       c["guess_noise"], c["masks_u"], c["masks_big"],
                       c["masks_out"], sweep_count, solver, orth, round_rhs,
                       round_method, precision, cg_iters)

    def pack(u):
        return _cn_pack(u, rmax, dtype, A.device)

    def unpack(s):
        return unpack_tt(s, c["u_rks"])

    return step_fn, pack, unpack


def make_cn_evolve(A, h: float, rmax: int, dims, u_rks, n_steps: int,
                   **kwargs):
    """Whole trajectory: ``n_steps`` of :func:`cn_step` in a loop. Returns
    ``(evolve_fn, pack, unpack)``."""
    step_fn, pack, unpack = make_cn_step(A, h, rmax, dims, u_rks, **kwargs)

    def evolve_fn(u_stack):
        for _ in range(n_steps):
            u_stack = step_fn(u_stack)
        return u_stack

    return evolve_fn, pack, unpack
