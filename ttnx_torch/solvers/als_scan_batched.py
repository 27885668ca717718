"""Explicitly-batched scan-ALS: the batch axis B written into every step.

The same algorithm as :func:`ttnx_torch.solvers.als_scan.als_sweeps` over
one shared operator stack ``A (d, RA, n, n, RA)``, a batch of right-hand
sides and states ``(B, d, R, n, R)`` and one shared rank profile ``masks
(d+1, R)``. ``solver='cg'`` runs the batched masked matrix-free CG as plain
torch ops; ``solver='cg_fused'`` takes, for real dtypes, kernel B6
(:func:`ttnx_torch.kernels.env_chain.env_chain_fused_batched`) for the env
stacks and kernel B5 (:func:`ttnx_torch.kernels.local_cg_mf.
cg_matfree_fused_batched`) for every local solve, at every R; complex
dtypes stay on the plain path. Every local CG is warm-started from the
transported current iterate; the gauge is QR.
"""

from __future__ import annotations

import torch

from ttnx_torch.kernels.env_chain import (env_chain_batched_plain,
                                          env_chain_fused_batched,
                                          left_env_b_update, left_env_update,
                                          right_env_b_update,
                                          right_env_update)
from ttnx_torch.kernels.local_cg_mf import (cg_matfree_batched_plain,
                                            cg_matfree_fused_batched)
from ttnx_torch.utils.profiling import span

__all__ = ["als_sweeps_b"]


def _b_boundary_env(B, R, RA, dtype, device):
    e = torch.zeros((B, R, RA, R), dtype=dtype, device=device)
    e[:, 0, 0, 0] = 1.0
    return e


def _b_boundary_env_b(B, R, Rb, dtype, device):
    e = torch.zeros((B, R, Rb), dtype=dtype, device=device)
    e[:, 0, 0] = 1.0
    return e


def _b_local_cg(L, Ac, Renv, Lb, bc, Rb_env, m_l, m_r, cg_iters: int,
                solver: str = "cg", v0=None):
    """Masked matrix-free CG on the batched local systems: ``L/Renv
    (B, R, RA, R)``, ``Lb/Rb_env (B, R, Rb)``, ``bc (B, Rb, n, Rb)``, shared
    ``Ac`` and masks, warm start ``v0 (B, R, n, R)``. ``'cg_fused'`` runs
    the whole solve in kernel B5 for real dtypes."""
    R = L.shape[1]
    n = Ac.shape[1]
    maskv3 = (m_l[:, None, None] * m_r[None, None, :]).expand(R, n, R)
    t = torch.einsum("Bau,Buiv->Baiv", Lb, bc)
    rhs = torch.einsum("Baiv,Bcv->Baic", t, Rb_env) * maskv3
    if solver == "cg_fused" and not L.dtype.is_complex:
        return cg_matfree_fused_batched(L, Ac, Renv, rhs,
                                        maskv3.to(rhs.dtype).contiguous(),
                                        x0=v0, iters=cg_iters)
    return cg_matfree_batched_plain(L, Ac, Renv, rhs, maskv3, x0=v0,
                                    iters=cg_iters)


def als_sweeps_b(A_stack, b_batch, x_batch, masks, sweep_count: int = 2,
                 cg_iters: int = 32, solver: str = "cg"):
    """Batched ALS half-sweeps with matrix-free CG local solves.

    ``A_stack (d, RA, n, n, RA)`` shared operator; ``b_batch (B, d, Rb, n,
    Rb)``, ``x_batch (B, d, R, n, R)``; ``masks (d+1, R)`` shared rank
    profile. Returns the solved ``(B, d, R, n, R)`` stack; represented
    vectors match ``als_sweeps(..., solver='cg')`` problem by problem."""
    if solver not in ("cg", "cg_fused"):
        raise ValueError(f"solver must be 'cg' or 'cg_fused', got {solver!r}")
    Bb, d, R, n, _ = x_batch.shape
    dt, dev = x_batch.dtype, x_batch.device
    RA = A_stack.shape[1]
    Rb = b_batch.shape[2]
    fused = solver == "cg_fused" and not dt.is_complex
    chain = env_chain_fused_batched if fused else env_chain_batched_plain

    def envs(x, left):
        with span("ttnx.als.env"):
            xm = x * masks[1:][None, :, None, None, :]
            return chain(xm, A_stack, b_batch, left=left)

    def forward(x, Renvs, Rb_envs):
        L = _b_boundary_env(Bb, R, RA, dt, dev)
        Lb = _b_boundary_env_b(Bb, R, Rb, dt, dev)
        T = _b_boundary_env_b(Bb, R, R, dt, dev)
        cores = []
        for k in range(d - 1):
            m_r = masks[k + 1]
            with span("ttnx.als.solve"):
                # warm start: the CURRENT iterate's core = T @ x_old[k]
                warm = torch.einsum("Bab,Bbnc->Banc", T, x[:, k])
                V = _b_local_cg(L, A_stack[k], Renvs[:, k + 1], Lb,
                                b_batch[:, k], Rb_envs[:, k + 1], masks[k],
                                m_r, cg_iters, solver, v0=warm)
            with span("ttnx.als.orth"):
                q, r = torch.linalg.qr(V.reshape(Bb, R * n, R))
                core = (q * m_r[None, None, :]).reshape(Bb, R, n, R)
                T = r * m_r[None, :, None]
            with span("ttnx.als.env"):
                L = left_env_update(core, L, A_stack[k])
                Lb = left_env_b_update(core, Lb, b_batch[:, k])
            cores.append(core)
        cores.append(torch.einsum("Bab,Bbnc->Banc", T, x[:, d - 1]))
        return torch.stack(cores, dim=1)

    def backward(x, Lenvs, Lb_envs):
        Renv = _b_boundary_env(Bb, R, RA, dt, dev)
        Rb_env = _b_boundary_env_b(Bb, R, Rb, dt, dev)
        T = _b_boundary_env_b(Bb, R, R, dt, dev)
        cores = [None] * d
        for k in range(d - 1, 0, -1):
            m_l = masks[k]
            with span("ttnx.als.solve"):
                # warm start: the CURRENT iterate's core = x_mid[k] @ T
                warm = torch.einsum("Banb,Bbc->Banc", x[:, k], T)
                V = _b_local_cg(Lenvs[:, k], A_stack[k], Renv, Lb_envs[:, k],
                                b_batch[:, k], Rb_env, m_l, masks[k + 1],
                                cg_iters, solver, v0=warm)
            with span("ttnx.als.orth"):
                qt, rt = torch.linalg.qr(
                    V.reshape(Bb, R, n * R).transpose(1, 2))
                core = qt.transpose(1, 2).reshape(Bb, R, n, R) \
                    * m_l[None, :, None, None]
                T = rt.transpose(1, 2) * m_l[None, None, :]
            with span("ttnx.als.env"):
                Renv = right_env_update(core, A_stack[k], Renv)
                Rb_env = right_env_b_update(core, b_batch[:, k], Rb_env)
            cores[k] = core
        cores[0] = torch.einsum("Banb,Bbc->Banc", x[:, 0], T)
        return torch.stack(cores, dim=1)

    x = x_batch
    half = 0
    while half < sweep_count:
        x = forward(x, *envs(x, left=False))
        half += 1
        if half >= sweep_count:
            break
        x = backward(x, *envs(x, left=True))
        half += 1
    return x
