"""TDVP time evolution on the TT manifold (1-site and 2-site) — the eager
tier.

Twin of ``ttnx.solvers.tdvp``. The cores are already in the ``(left,
phys, right)`` MPS layout, so the sweeps run on them directly; the local
exponentials are :func:`ttnx_torch.solvers.krylov.expm_multiply` and the
two-site truncations :func:`ttnx_torch.core.canonical.svdtrunc`. Every
sweep computes in float64 or complex128 whatever the input dtype, as the
reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from ttnx_torch.core.algebra import add, matvec, norm, scale, sub
from ttnx_torch.core.canonical import orthogonalize, svdtrunc
from ttnx_torch.core.tt import TTOperator, TTVector
from ttnx_torch.solvers.krylov import expm_multiply

__all__ = ["tdvp", "tdvp2", "tdvp1sweep", "tdvp2sweep"]


def _mpo_asbs(core):
    """(r_l, s_out, s_in, r_r) -> (r_l, s_out, r_r, s_in)."""
    return core.permute(0, 1, 3, 2)


def _apply_h1(AC, FL, FR, M):
    """``HAC[x,s,z] = FL[x,a,p] AC[p,t,y] M[a,s,b,t] FR[y,b,z]``."""
    t = torch.einsum("xap,pty->xaty", FL, AC)
    t = torch.einsum("xaty,asbt->xysb", t, M)
    return torch.einsum("xysb,ybz->xsz", t, FR)


def _apply_h0(C, FL, FR):
    """``HC[x,z] = FL[x,a,p] C[p,y] FR[y,a,z]``."""
    t = torch.einsum("xap,py->xay", FL, C)
    return torch.einsum("xay,yaz->xz", t, FR)


def _apply_h2(AAC, FL, FR, M1, M2):
    """``HAAC[x,s,v,z] = FL[x,a,p] AAC[p,t,u,y] M1[a,s,b,t] M2[b,v,c,u]
    FR[y,c,z]``."""
    t = torch.einsum("xap,ptuy->xatuy", FL, AAC)
    t = torch.einsum("xatuy,asbt->xuysb", t, M1)
    t = torch.einsum("xuysb,bvcu->xysvc", t, M2)
    return torch.einsum("xysvc,ycz->xsvz", t, FR)


def _update_left_env(A, M, FL):
    """``FL'[a,z,b] = FL[x,p,y] A[y,t,b] M[p,s,z,t] conj(A)[x,s,a]``."""
    t = torch.einsum("xpy,ytb->xptb", FL, A)
    t = torch.einsum("xptb,pszt->xbsz", t, M)
    return torch.einsum("xbsz,xsa->azb", t, A.conj())


def _update_right_env(A, M, FR):
    """``FR'[x,a,b] = A[x,t,y] FR[y,p,z] M[a,s,p,t] conj(A)[b,s,z]``."""
    t = torch.einsum("xty,ypz->xtpz", A, FR)
    t = torch.einsum("xtpz,aspt->xzas", t, M)
    return torch.einsum("xzas,bsz->xab", t, A.conj())


def _init_right_envs(cores, Ms, dtype):
    n_sites = len(cores)
    dev = cores[0].device
    F = [None] * (n_sites + 2)
    F[0] = torch.ones((1, 1, 1), dtype=dtype, device=dev)
    F[n_sites + 1] = torch.ones((1, 1, 1), dtype=dtype, device=dev)
    for k in range(n_sites - 1, -1, -1):
        F[k + 1] = _update_right_env(cores[k], Ms[k], F[k + 2])
    return F


def _t_eff(z):
    """The step as a Python number: real when its imaginary part is 0."""
    z = complex(z)
    return z.real if z.imag == 0 else z


def _sweep_setup(dt, psi, H, F):
    """Cores and MPO in float64/complex128, and the environment cache. A
    real nonzero ``dt`` gives imaginary exponents, so the sweep is complex
    (ttnx gets there by promotion inside the sweep)."""
    complex_t = (isinstance(dt, complex) or psi.is_complex or H.is_complex
                 or isinstance(_t_eff(-1j * dt), complex))
    dtype = torch.complex128 if complex_t else torch.float64
    cores = [c.to(dtype) for c in psi.cores]
    Ms = [_mpo_asbs(c.to(dtype)) for c in H.cores]
    if F is None:
        F = _init_right_envs(cores, Ms, dtype)
    else:
        F = [f.to(dtype) for f in F]
    return cores, Ms, F


def tdvp1sweep(dt, psi: TTVector, H: TTOperator, F=None, ishermitian=True,
               tol=1e-12, krylov_dim=30, verbose=False):
    """One symmetric 1-site TDVP sweep L->R then R->L; each site evolves by
    ``exp(-i dt H1)`` forward and each bond by ``exp(+i dt H0)`` backward.
    Returns ``(psi_new, F)`` with the environment cache for reuse."""
    n_sites = psi.N
    cores, Ms, F = _sweep_setup(dt, psi, H, F)
    fwd, bwd = _t_eff(-1j * dt), _t_eff(+1j * dt)

    AC = cores[0]
    for k in range(n_sites - 1):
        h1 = lambda x, k=k: _apply_h1(x, F[k], F[k + 2], Ms[k])
        AC = expm_multiply(h1, fwd, AC, tol=tol, krylov_dim=krylov_dim)
        if verbose:
            e = torch.vdot(AC.reshape(-1), h1(AC).reshape(-1))
            print(f"TDVP sweep: site={k} energy={float(e.real)}")
        dl, d, dr = AC.shape
        q, r = torch.linalg.qr(AC.reshape(dl * d, dr))
        cores[k] = q.reshape(dl, d, -1)
        F[k + 1] = _update_left_env(cores[k], Ms[k], F[k])
        h0 = lambda x, k=k: _apply_h0(x, F[k + 1], F[k + 2])
        C = expm_multiply(h0, bwd, r, tol=tol, krylov_dim=krylov_dim)
        AC = torch.einsum("ag,gsb->asb", C, cores[k + 1])

    h1n = lambda x: _apply_h1(x, F[n_sites - 1], F[n_sites + 1],
                              Ms[n_sites - 1])
    AC = expm_multiply(h1n, fwd, AC, tol=tol, krylov_dim=krylov_dim)

    for k in range(n_sites - 2, -1, -1):
        dl, d, dr = AC.shape
        qt, rt = torch.linalg.qr(AC.reshape(dl, d * dr).T)
        cores[k + 1] = qt.T.reshape(-1, d, dr)
        F[k + 2] = _update_right_env(cores[k + 1], Ms[k + 1], F[k + 3])
        h0 = lambda x, k=k: _apply_h0(x, F[k + 1], F[k + 2])
        C = expm_multiply(h0, bwd, rt.T, tol=tol, krylov_dim=krylov_dim)
        AC = torch.einsum("asg,gb->asb", cores[k], C)
        h1 = lambda x, k=k: _apply_h1(x, F[k], F[k + 2], Ms[k])
        AC = expm_multiply(h1, fwd, AC, tol=tol, krylov_dim=krylov_dim)

    cores[0] = AC
    return TTVector(cores), F


def tdvp2sweep(dt, psi: TTVector, H: TTOperator, F=None, max_bond=None,
               truncerr=0.0, ishermitian=True, tol=1e-12, krylov_dim=30,
               verbose=False):
    """One 2-site TDVP sweep with half time steps and truncated-SVD rank
    adaptation."""
    n_sites = psi.N
    cores, Ms, F = _sweep_setup(dt, psi, H, F)
    fwd, bwd = _t_eff(-1j * dt / 2), _t_eff(+1j * dt / 2)

    AC = cores[0]
    for k in range(n_sites - 1):
        AAC = torch.einsum("asg,gtb->astb", AC, cores[k + 1])
        h2 = lambda x, k=k: _apply_h2(x, F[k], F[k + 3], Ms[k], Ms[k + 1])
        AAC = expm_multiply(h2, fwd, AAC, tol=tol, krylov_dim=krylov_dim)
        dl, d1, d2, dr = AAC.shape
        u, s, vt = svdtrunc(AAC.reshape(dl * d1, d2 * dr), max_bond=max_bond,
                            truncerr=truncerr)
        cores[k] = u.reshape(dl, d1, -1)
        F[k + 1] = _update_left_env(cores[k], Ms[k], F[k])
        AC = (s[:, None].to(vt.dtype) * vt).reshape(-1, d2, dr)
        if k < n_sites - 2:
            h1 = lambda x, k=k: _apply_h1(x, F[k + 1], F[k + 3], Ms[k + 1])
            AC = expm_multiply(h1, bwd, AC, tol=tol, krylov_dim=krylov_dim)

    for k in range(n_sites - 2, -1, -1):
        AAC = torch.einsum("asg,gtb->astb", cores[k], AC)
        h2 = lambda x, k=k: _apply_h2(x, F[k], F[k + 3], Ms[k], Ms[k + 1])
        AAC = expm_multiply(h2, fwd, AAC, tol=tol, krylov_dim=krylov_dim)
        dl, d1, d2, dr = AAC.shape
        u, s, vt = svdtrunc(AAC.reshape(dl * d1, d2 * dr), max_bond=max_bond,
                            truncerr=truncerr)
        cores[k + 1] = vt.reshape(-1, d2, dr)
        F[k + 2] = _update_right_env(cores[k + 1], Ms[k + 1], F[k + 3])
        AC = (u * s[None, :].to(u.dtype)).reshape(dl, d1, -1)
        if k > 0:
            h1 = lambda x, k=k: _apply_h1(x, F[k], F[k + 2], Ms[k])
            AC = expm_multiply(h1, bwd, AC, tol=tol, krylov_dim=krylov_dim)

    cores[0] = AC
    return TTVector(cores), F


def _tdvp_driver(sweep_fn, H, u0, steps, normalize, return_error, sweeps,
                 carry_env, imaginary_time, verbose, **kwargs):
    psi = orthogonalize(u0, 0)
    wants_complex = not imaginary_time
    if wants_complex and not psi.is_complex:
        psi = psi.astype(torch.complex128)
    Hc = (H.astype(torch.complex128) if (wants_complex and not H.is_complex)
          else H)

    psi_prev = psi
    F = None
    for h in np.atleast_1d(steps):
        psi_prev_step = psi
        dt_eff = (1j * float(h)) if imaginary_time else complex(h)
        for _ in range(sweeps):
            F_in = F if carry_env else None
            psi, F = sweep_fn(dt_eff, psi, Hc, F_in, verbose=verbose, **kwargs)
        if normalize:
            psi = scale(1.0 / float(norm(psi)), psi)
        psi = orthogonalize(psi, 0)
        F = None
        psi_prev = psi_prev_step

    if return_error:
        h = float(np.atleast_1d(steps)[-1])
        diff = scale(1.0 / h, sub(psi, psi_prev))
        if imaginary_time:
            residual = sub(diff, matvec(Hc, psi))
        else:
            residual = add(diff, scale(1j, matvec(Hc, psi)))
        return psi, float(norm(residual) / norm(psi))
    return psi


def tdvp(H: TTOperator, u0: TTVector, steps, normalize=True,
         return_error=False, sweeps=1, carry_env=True, verbose=False,
         imaginary_time=False, config=None, **kwargs):
    """1-site TDVP driver. Real-time evolution of ``i dpsi/dt = H psi``
    (real input is made complex); ``imaginary_time=True`` evolves ``dpsi/dt
    = H psi``. ``config`` (:class:`ttnx_torch.config.TDVPConfig`)
    overrides option defaults."""
    if config is not None:
        normalize, sweeps = config.normalize, config.sweeps
        carry_env = config.carry_env
        imaginary_time = config.imaginary_time
    return _tdvp_driver(tdvp1sweep, H, u0, steps, normalize, return_error,
                        sweeps, carry_env, imaginary_time, verbose, **kwargs)


def tdvp2(H: TTOperator, u0: TTVector, steps, normalize=True,
          return_error=False, sweeps=1, carry_env=True, verbose=False,
          max_bond=None, truncerr=0.0, imaginary_time=False, config=None,
          **kwargs):
    """2-site TDVP driver with rank adaptation. ``config``
    (:class:`ttnx_torch.config.TDVPConfig`) overrides option defaults."""
    if config is not None:
        normalize, sweeps = config.normalize, config.sweeps
        carry_env = config.carry_env
        imaginary_time = config.imaginary_time
        max_bond, truncerr = config.max_bond, config.truncerr
    return _tdvp_driver(tdvp2sweep, H, u0, steps, normalize, return_error,
                        sweeps, carry_env, imaginary_time, verbose,
                        max_bond=max_bond, truncerr=truncerr, **kwargs)
