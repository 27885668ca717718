"""1-site and 2-site TDVP sweeps on padded stacks.

Twin of ``ttnx.solvers.tdvp_scan``. 1-site TDVP keeps the ranks, so its
masks are static; 2-site TDVP adapts them per bond (absolute singular-value
threshold capped at ``max_keep``). Local exponentials are matrix-free
Lanczos (``expm='lanczos'``, Hermitian generators) or dense ``matrix_exp``
of the masked local operator (``expm='dense'``, any generator, small ranks
only). The padded diagonal of every masked operator is zero, so padding
evolves by the identity and zero-padded states never populate it.

``imag_real=True`` is the real imaginary-time form: ``dt`` is the real step
``h``, sites evolve by ``exp(+h K)`` and bonds by ``exp(-h K)``; a carried
log-scale renormalization keeps the stiff bond back-evolutions finite in
float32 and is folded back into the final centre core. Otherwise ``dt``
is complex and the evolution is ``i dpsi/dt = H psi``.

TDVP runs no kernel: the env stacks and every local operator are plain
torch, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ttnx_torch.core.algebra import dot, matvec, norm, scale
from ttnx_torch.core.canonical import orthogonalize
from ttnx_torch.core.linalg import thin_svd
from ttnx_torch.core.tt import TTOperator, TTVector, rand_tt
from ttnx_torch.kernels.env_chain import (boundary_envs, env_chain_A_plain,
                                          left_env_update, right_env_update)
from ttnx_torch.kernels.local_cg_mf import apply_local_op
from ttnx_torch.solvers.als_scan import pack_op, pack_tt, rank_masks, unpack_tt
from ttnx_torch.solvers.dmrg_scan import _apply2, _assemble_K2, _gram_eigh

__all__ = ["tdvp1_step", "tdvp1_scan", "tdvp2_step", "tdvp2_scan"]

EXPMS = ("lanczos", "dense")


# ---------------------------------------------------------------------------
# Masked local operators: dense (for expm='dense') and matrix-free
# ---------------------------------------------------------------------------


def _mask3(m_l, m_r, n):
    return (m_l[:, None, None] * m_r[None, None, :]).expand(-1, n, -1)


def _k1_masked(L, Ac, Renv, m_l, m_r):
    R, n = L.shape[0], Ac.shape[1]
    M = R * n * R
    t = torch.einsum("aWb,WiJw->aibJw", L, Ac)
    K = torch.einsum("aibJw,cwd->aicbJd", t, Renv).reshape(M, M)
    maskv = _mask3(m_l, m_r, n).reshape(M).to(K.dtype)
    return K * maskv[:, None] * maskv[None, :]


def _k0_masked(L, Renv, m):
    R = L.shape[0]
    K = torch.einsum("aWb,cWd->acbd", L, Renv).reshape(R * R, R * R)
    maskv = (m[:, None] * m[None, :]).reshape(R * R).to(K.dtype)
    return K * maskv[:, None] * maskv[None, :]


def _k2_masked(L, Ai, Aj, Renv, m_l, m_r):
    R, n = L.shape[0], Ai.shape[1]
    maskv = (m_l[:, None, None, None] * m_r[None, None, None, :]).expand(
        -1, n, n, -1).reshape(R * n * n * R).to(L.dtype)
    return _assemble_K2(L, Ai, Aj, Renv, maskv)


def _expmv(K, t, v):
    return (torch.linalg.matrix_exp(t * K) @ v.reshape(-1)).reshape(v.shape)


def _k1_apply(L, Ac, Renv, m_l, m_r):
    """Matrix-free masked 1-site effective Hamiltonian."""
    maskv3 = _mask3(m_l, m_r, Ac.shape[1])

    def apply(v):
        return apply_local_op(L, Ac, Renv, v * maskv3) * maskv3

    return apply


def _k0_apply(L, Renv, m):
    mask2 = m[:, None] * m[None, :]

    def apply(C):
        t = torch.einsum("aWb,bd->aWd", L, C * mask2)
        return torch.einsum("aWd,cWd->ac", t, Renv) * mask2

    return apply


def _k2_apply(L, Ai, Aj, Renv, m_l, m_r):
    n = Ai.shape[1]
    maskv4 = (m_l[:, None, None, None] * m_r[None, None, None, :]).expand(
        -1, n, n, -1)

    def apply(v):
        return _apply2(L, Ai, Aj, Renv, v * maskv4) * maskv4

    return apply


def _lanczos_expmv(apply_fn, t, v, krylov_dim: int = 20):
    """``exp(t K) v`` for a Hermitian masked operator given only its apply:
    fixed-iteration Lanczos with two-pass full reorthogonalization. A
    breakdown (Krylov space exhausted) zeroes its beta, which ends the
    recurrence exactly."""
    shape = v.shape
    v0 = v.reshape(-1)
    nrm = torch.linalg.norm(v0)
    nrm_safe = torch.where(nrm > 0, nrm, 1.0)
    eps = torch.finfo(nrm.dtype).eps
    Q = torch.zeros((krylov_dim, v0.shape[0]), dtype=v0.dtype,
                    device=v0.device)
    Q[0] = v0 / nrm_safe
    alphas, betas = [], []
    scale_ = torch.zeros((), dtype=nrm.dtype, device=v0.device)
    for j in range(krylov_dim):
        w = apply_fn(Q[j].reshape(shape)).reshape(-1)
        alpha = torch.vdot(Q[j], w).real
        alphas.append(alpha)
        scale_ = torch.maximum(scale_, alpha.abs())
        if j == krylov_dim - 1:
            break
        for _ in range(2):  # rows > j are zero: no-op contributions
            w = w - Q.T @ (Q.conj() @ w)
        beta = torch.linalg.norm(w)
        scale_ = torch.maximum(scale_, beta)
        ok = beta > 64.0 * eps * scale_
        betas.append(torch.where(ok, beta, 0.0))
        Q[j + 1] = ok.to(w.dtype) * w / torch.where(ok, beta, 1.0)
    T = torch.diag(torch.stack(alphas))
    if krylov_dim > 1:
        b = torch.stack(betas)
        T = T + torch.diag(b, 1) + torch.diag(b, -1)
    lam, V = torch.linalg.eigh(T)
    phase = torch.exp(t * lam.to(v0.dtype))
    Vc = V.to(v0.dtype)
    y = Vc @ (phase * Vc[0])
    return (nrm * (y @ Q)).reshape(shape)


def _right_env_stack_A(x, A, mask_r):
    return env_chain_A_plain(x * mask_r[:, None, None, :], A, left=False)


def _left_env_stack_from(cores_left, A):
    """Left envs from the left-orthogonal cores 0..d-2; ``Lenvs[i]`` covers
    sites 0..i-1 (length d)."""
    return env_chain_A_plain(cores_left, A[:-1], left=True)


def _steps(dt, imag_real, real_factor):
    """``(t_site, t_bond)`` of a sweep: real ``(+f dt, -f dt)`` for the
    real imaginary-time form, ``(-i f dt, +i f dt)`` otherwise."""
    if imag_real:
        return real_factor * dt, -real_factor * dt
    return -1j * real_factor * dt, 1j * real_factor * dt


def _renorm(imag_real):
    """Imaginary-time transient control: carry the norm of each evolved
    block in log space (exact; the total goes back into the final centre
    core)."""
    def renorm(v, lg):
        if not imag_real:
            return v, lg
        nv = torch.linalg.norm(v)
        nv = torch.where(nv > 0, nv, 1.0)
        return v / nv, lg + torch.log(nv)

    return renorm


def _exp_fns(expm, krylov_dim):
    if expm not in EXPMS:
        raise ValueError(f"expm must be 'lanczos' or 'dense', got {expm!r}")

    def exp2(L, Ai, Aj, Renv, m_l, m_r, t, v):
        if expm == "dense":
            return _expmv(_k2_masked(L, Ai, Aj, Renv, m_l, m_r), t, v)
        return _lanczos_expmv(_k2_apply(L, Ai, Aj, Renv, m_l, m_r), t, v,
                              krylov_dim)

    def exp1(L, Ac, Renv, m_l, m_r, t, v):
        if expm == "dense":
            return _expmv(_k1_masked(L, Ac, Renv, m_l, m_r), t, v)
        return _lanczos_expmv(_k1_apply(L, Ac, Renv, m_l, m_r), t, v,
                              krylov_dim)

    def exp0(L, Renv, m, t, v):
        if expm == "dense":
            return _expmv(_k0_masked(L, Renv, m), t, v)
        return _lanczos_expmv(_k0_apply(L, Renv, m), t, v, krylov_dim)

    return exp2, exp1, exp0


def _as_step(dt, x_stack):
    return torch.as_tensor(dt, dtype=x_stack.dtype, device=x_stack.device)


# ---------------------------------------------------------------------------
# 1-site TDVP
# ---------------------------------------------------------------------------


def tdvp1_step(A_stack, x_stack, masks, dt, expm: str = "lanczos",
               krylov_dim: int = 20, imag_real: bool = False):
    """One symmetric 1-site TDVP sweep (left to right, then right to left)
    of step ``dt`` on ``i dpsi/dt = H psi`` (``dt = -1j * h`` for imaginary
    time); with ``imag_real=True`` a real stack and the real step ``h``.
    The state must be packed in site-0 canonical form. Returns the
    updated stack."""
    _, exp1, exp0 = _exp_fns(expm, krylov_dim)
    renorm = _renorm(imag_real)
    d, R, n, _ = x_stack.shape
    dtc = x_stack.dtype
    RA = A_stack.shape[1]
    t1, t0 = _steps(_as_step(dt, x_stack), imag_real, 1.0)
    Renvs = _right_env_stack_A(x_stack, A_stack, masks[1:])
    L, _ = boundary_envs(R, RA, 1, dtc, x_stack.device)
    C = torch.zeros((R, R), dtype=dtc, device=x_stack.device)
    C[0, 0] = 1.0
    lg = torch.zeros((), dtype=x_stack.real.dtype, device=x_stack.device)

    fwd_cores = []
    for k in range(d - 1):
        Ac, Renv, m_l, m_r = A_stack[k], Renvs[k + 1], masks[k], masks[k + 1]
        AC = torch.einsum("ab,bnc->anc", C, x_stack[k])
        AC, lg = renorm(exp1(L, Ac, Renv, m_l, m_r, t1, AC), lg)
        q, r = torch.linalg.qr(AC.reshape(R * n, R))
        core = (q * m_r[None, :]).reshape(R, n, R)
        L = left_env_update(core, L, Ac)
        C, lg = renorm(exp0(L, Renv, m_r, t0, r * m_r[:, None]), lg)
        fwd_cores.append(core)

    # full step at the last site
    AC = torch.einsum("ab,bnc->anc", C, x_stack[d - 1])
    AC, lg = renorm(exp1(L, A_stack[d - 1], Renvs[d], masks[d - 1],
                         masks[d], t1, AC), lg)

    # backward: sites d-1..1 give right-orthogonal cores, each bond's
    # back-evolution feeds the previous site, ending with the centre at 0
    fwd = torch.stack(fwd_cores)
    Lenvs = _left_env_stack_from(fwd, A_stack)
    Renv, _ = boundary_envs(R, RA, 1, dtc, x_stack.device)
    bwd_cores = [None] * (d - 1)
    for k in range(d - 2, -1, -1):
        m_l, m_ll = masks[k + 1], masks[k]
        qt, rt = torch.linalg.qr(AC.reshape(R, n * R).T)
        core = qt.T.reshape(R, n, R) * m_l[:, None, None]
        Renv = right_env_update(core, A_stack[k + 1], Renv)
        C, lg = renorm(exp0(Lenvs[k + 1], Renv, m_l, t0,
                            rt.T * m_l[None, :]), lg)
        AC = torch.einsum("anb,bc->anc", fwd[k], C)
        AC, lg = renorm(exp1(Lenvs[k], A_stack[k], Renv, m_ll, m_l, t1, AC),
                        lg)
        bwd_cores[k] = core
    if imag_real:
        AC = AC * torch.exp(lg).to(dtc)
    return torch.stack([AC] + bwd_cores)


# ---------------------------------------------------------------------------
# 2-site TDVP
# ---------------------------------------------------------------------------


def _keep_mask_tdvp(s, truncerr, max_keep, R):
    """Absolute-threshold keep mask capped at ``max_keep``; numerically-zero
    padded singular values are always dropped."""
    idx = torch.arange(R, device=s.device)
    floor = torch.clamp(s[0] * 1e-15, min=truncerr)
    keep = (s[:R] >= floor) & (idx < max_keep)
    keep[0] = True
    return keep.to(s.dtype)


def _svd2_masked(Vm, method):
    """``(u, s, vt)`` of the merged two-site matrix; ``'gram'`` takes the
    eigh of the Gram (rows of vt whose singular value is below rounding are
    zeroed by the pseudo-inverse scaling)."""
    if method == "gram":
        w, U = _gram_eigh(Vm @ Vm.conj().T)
        s = torch.sqrt(torch.clamp(w.flip(0), min=0.0))
        u = U.flip(1)
        svt = u.conj().T @ Vm
        tiny = torch.finfo(s.dtype).eps * Vm.shape[0] * torch.max(s)
        s_inv = torch.where(s > tiny,
                            1.0 / torch.clamp(s, min=torch.finfo(s.dtype).tiny),
                            0.0)
        return u, s, s_inv[:, None].to(svt.dtype) * svt
    if method != "svd":
        raise ValueError(f"split must be 'svd' or 'gram', got {method!r}")
    return thin_svd(Vm)


def tdvp2_step(A_stack, x_stack, mask_stack, dt, truncerr, max_keep,
               expm: str = "lanczos", krylov_dim: int = 20,
               imag_real: bool = False, split: str = "svd"):
    """One 2-site TDVP sweep (left to right, then right to left) with half
    time steps and rank-adaptive masks. ``expm`` and ``imag_real`` as in
    :func:`tdvp1_step`; ``split='gram'`` is the SVD-free split. Returns
    ``(x_stack, mask_stack)``."""
    exp2, exp1, _ = _exp_fns(expm, krylov_dim)
    renorm = _renorm(imag_real)
    d, R, n, _ = x_stack.shape
    dtc = x_stack.dtype
    RA = A_stack.shape[1]
    t2, t1 = _steps(_as_step(dt, x_stack), imag_real, 0.5)
    Renvs = _right_env_stack_A(x_stack, A_stack, mask_stack[1:])
    L, _ = boundary_envs(R, RA, 1, dtc, x_stack.device)
    AC, m_l = x_stack[0], mask_stack[0]
    lg = torch.zeros((), dtype=x_stack.real.dtype, device=x_stack.device)

    fwd_cores, fwd_masks = [], []
    for k in range(d - 1):
        Ai, Aj, Renv, m_r = (A_stack[k], A_stack[k + 1], Renvs[k + 2],
                             mask_stack[k + 2])
        AAC = torch.einsum("asg,gtb->astb", AC, x_stack[k + 1])
        AAC, lg = renorm(exp2(L, Ai, Aj, Renv, m_l, m_r, t2, AAC), lg)
        u, s, vt = _svd2_masked(AAC.reshape(R * n, n * R), split)
        keep = _keep_mask_tdvp(s[:R].abs(), truncerr, max_keep, R)
        core = (u[:, :R] * keep[None, :]).reshape(R, n, R)
        AC = ((s[:R, None] * vt[:R, :]) * keep[:, None]).reshape(R, n, R)
        L = left_env_update(core, L, Ai)
        # no 1-site back-evolution on the last forward bond (t = 0)
        last = 1.0 if k == d - 2 else 0.0
        AC, lg = renorm(exp1(L, Aj, Renv, keep, m_r, t1 * (1.0 - last), AC),
                        lg)
        m_l = keep
        fwd_cores.append(core)
        fwd_masks.append(keep)
    x_mid = torch.stack(fwd_cores + [AC])
    masks_mid = torch.stack([mask_stack[0]] + fwd_masks + [mask_stack[d]])

    Lenvs = _left_env_stack_from(x_mid[:-1], A_stack)
    Renv, _ = boundary_envs(R, RA, 1, dtc, x_stack.device)
    m_r = mask_stack[d]
    bwd_cores, bwd_masks = [None] * (d - 1), [None] * (d - 1)
    for k in range(d - 2, -1, -1):
        Ai, Aj, Lenv, m_l = A_stack[k], A_stack[k + 1], Lenvs[k], masks_mid[k]
        AAC = torch.einsum("asg,gtb->astb", x_mid[k], AC)
        AAC, lg = renorm(exp2(Lenv, Ai, Aj, Renv, m_l, m_r, t2, AAC), lg)
        u, s, vt = _svd2_masked(AAC.reshape(R * n, n * R), split)
        keep = _keep_mask_tdvp(s[:R].abs(), truncerr, max_keep, R)
        core = (vt[:R, :] * keep[:, None]).reshape(R, n, R)
        AC = ((u[:, :R] * s[None, :R]) * keep[None, :]).reshape(R, n, R)
        Renv = right_env_update(core, Aj, Renv)
        first = 1.0 if k == 0 else 0.0
        AC, lg = renorm(exp1(Lenv, Ai, Renv, m_l, keep, t1 * (1.0 - first),
                             AC), lg)
        m_r = keep
        bwd_cores[k], bwd_masks[k] = core, keep
    if imag_real:
        AC = AC * torch.exp(lg).to(dtc)
    x_out = torch.stack([AC] + bwd_cores)
    masks_out = torch.stack([mask_stack[0]] + bwd_masks + [mask_stack[d]])
    return x_out, masks_out


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def _check_hermitian_for_lanczos(H: TTOperator, expm: str) -> None:
    """Guard for ``expm='lanczos'``, which assumes a Hermitian generator:
    checks ``<x, H y> == conj(<y, H x>)`` for two random rank-2 TT vectors
    (seeded) and points to ``expm='dense'`` when it fails."""
    if expm != "lanczos":
        return
    g = torch.Generator().manual_seed(17)
    x = rand_tt(g, H.dims, rmax=2, normalise=True, dtype=H.dtype).to(
        H.device)
    y = rand_tt(g, H.dims, rmax=2, normalise=True, dtype=H.dtype).to(
        H.device)
    a = complex(dot(x, matvec(H, y)))
    b = complex(dot(y, matvec(H, x)))
    scale_ = max(abs(a), abs(b), 1e-30)
    tol = float(torch.finfo(torch.empty((), dtype=H.dtype).real.dtype).eps
                ) ** 0.5 * 100
    if abs(a - b.conjugate()) / scale_ > tol:
        raise ValueError(
            "expm='lanczos' requires a Hermitian generator, but "
            f"<x,Hy>={a:.3e} vs conj(<y,Hx>)={b.conjugate():.3e} "
            f"(rel dev {abs(a - b.conjugate()) / scale_:.1e}); use "
            "expm='dense' for non-Hermitian H")


def _scan_setup(H, u0, imaginary_time, dtype):
    dtc = torch.complex128 if dtype is None else dtype
    real_path = not dtc.is_complex
    if real_path and not imaginary_time:
        raise ValueError("real-dtype TDVP requires imaginary_time=True")
    x = orthogonalize(u0, 0)
    A_stack = pack_op(H.astype(dtc), max(H.ranks))
    return x, dtc, real_path, A_stack


def _step_of(h, dtc, real_path, imaginary_time):
    """The ``dt`` a driver step passes: ``h`` on the real path, ``i h`` in
    complex imaginary time (site evolution ``exp(+h K)``), else ``h``."""
    if real_path or not imaginary_time:
        return h
    return 1j * h


def _normalized(x_stack, rks, rmax):
    out = unpack_tt(x_stack, rks)
    out = scale(1.0 / float(norm(out)), out)
    return pack_tt(out, rmax)


def tdvp1_scan(H: TTOperator, u0: TTVector, steps, imaginary_time=False,
               normalize=True, rmax: int | None = None, expm: str = "lanczos",
               krylov_dim: int = 20, dtype=None):
    """1-site TDVP over ``steps`` (one :func:`tdvp1_step` per entry),
    renormalized between steps when ``normalize``. ``dtype`` defaults to
    complex128; a real dtype selects the real imaginary-time path (needs
    ``imaginary_time=True`` and a real symmetric ``H``). Keep ``h ||H||``
    below about 16 in float32 (36 in float64): beyond it the symmetric
    splitting's re-amplified decayed modes are rounding noise."""
    _check_hermitian_for_lanczos(H, expm)
    x, dtc, real_path, A_stack = _scan_setup(H, u0, imaginary_time, dtype)
    rks = x.ranks
    if rmax is None:
        rmax = max(max(rks), 2)
    masks = rank_masks(rks, rmax, dtype=torch.empty((), dtype=dtc).real.dtype,
                       device=x.device)
    x_stack = pack_tt(x.astype(dtc), rmax)
    for h in np.atleast_1d(steps):
        x_stack = tdvp1_step(A_stack, x_stack, masks,
                             _step_of(float(h), dtc, real_path,
                                      imaginary_time),
                             expm=expm, krylov_dim=krylov_dim,
                             imag_real=real_path)
        if normalize:
            x_stack = _normalized(x_stack, rks, rmax)
    return unpack_tt(x_stack, rks)


def tdvp2_scan(H: TTOperator, u0: TTVector, steps, imaginary_time=False,
               normalize=True, rmax: int | None = None, truncerr: float = 0.0,
               max_bond: int | None = None, expm: str = "lanczos",
               krylov_dim: int = 20, dtype=None, split: str = "svd"):
    """2-site TDVP driver with rank-adaptive masks; options as in
    :func:`tdvp1_scan`, plus ``truncerr``/``max_bond`` of the keep rule
    and the ``split``."""
    _check_hermitian_for_lanczos(H, expm)
    x, dtc, real_path, A_stack = _scan_setup(H, u0, imaginary_time, dtype)
    if rmax is None:
        rmax = max(2 * max(x.ranks), 4)
    if max_bond is None:
        max_bond = rmax
    real_dt = torch.empty((), dtype=dtc).real.dtype
    masks = rank_masks(x.ranks, rmax, dtype=real_dt, device=x.device)
    x_stack = pack_tt(x.astype(dtc), rmax)
    te = torch.as_tensor(truncerr, dtype=real_dt, device=x.device)
    mk = min(max_bond, rmax)

    def ranks():
        return [int(v) for v in masks.real.sum(dim=1).tolist()]

    for h in np.atleast_1d(steps):
        x_stack, masks = tdvp2_step(
            A_stack, x_stack, masks,
            _step_of(float(h), dtc, real_path, imaginary_time), te, mk,
            expm=expm, krylov_dim=krylov_dim, imag_real=real_path,
            split=split)
        if normalize:
            x_stack = _normalized(x_stack, ranks(), rmax)
    return unpack_tt(x_stack, ranks())
