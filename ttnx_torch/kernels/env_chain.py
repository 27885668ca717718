"""Kernel B2: the ALS environment chains (right and left).

The right-env build is a backward recurrence of pure contractions::

    Renv_d = e0 e0^T,  Renv_k[a,W,b] = sum x[a,i,p] A[W,i,j,w] x[b,j,q] Renv_{k+1}[p,w,q]
    Rb_d   = e0 e0^T,  Rb_k[a,u]     = sum x[a,i,p] b[u,i,v] Rb_{k+1}[p,v]

and the left build its forward mirror. :func:`right_env_chain_fused` and
:func:`left_env_chain_fused` run the whole chain through the Hopper kernels
(``csrc/env_chain.cu``) for CUDA tensors and through the plain versions for
CPU tensors. ``x`` must already carry its rank masks. Every plain
contraction is written as pairwise steps (no three-operand einsum: without
``opt_einsum`` torch contracts left to right through huge intermediates).
"""

from __future__ import annotations

import torch

from ttnx_torch.kernels import _build
from ttnx_torch.kernels.dispatch import counted, require_real, use_kernel

__all__ = ["right_env_chain_fused", "left_env_chain_fused",
           "right_env_chain_plain", "left_env_chain_plain",
           "right_env_update", "right_env_b_update", "left_env_update",
           "left_env_b_update", "boundary_envs"]


def right_env_update(xc, Ac, Renv):
    """``new[a,W,b] = sum conj(x)[a,i,p] A[W,i,j,w] x[b,j,q] Renv[p,w,q]``."""
    t = torch.einsum("bjq,pwq->bjpw", xc, Renv)
    t = torch.einsum("Wijw,bjpw->Wibp", Ac, t)
    return torch.einsum("aip,Wibp->aWb", xc.conj(), t)


def right_env_b_update(xc, bc, Rb_env):
    """``new_b[a,u] = sum conj(x)[a,i,p] b[u,i,v] Rb[p,v]``."""
    t = torch.einsum("uiv,pv->uip", bc, Rb_env)
    return torch.einsum("aip,uip->au", xc.conj(), t)


def left_env_update(xc, L, Ac):
    """``new[c,w,d] = sum conj(x)[a,i,c] L[a,W,b] A[W,i,j,w] x[b,j,d]``."""
    t = torch.einsum("aic,aWb->icWb", xc.conj(), L)
    t = torch.einsum("icWb,Wijw->cbjw", t, Ac)
    return torch.einsum("cbjw,bjd->cwd", t, xc)


def left_env_b_update(xc, Lb, bc):
    """``new_b[p,v] = sum conj(x)[a,i,p] Lb[a,u] b[u,i,v]``."""
    t = torch.einsum("aip,au->ipu", xc.conj(), Lb)
    return torch.einsum("ipu,uiv->pv", t, bc)


def boundary_envs(R, RA, Rb, dtype, device):
    """``(e0 (R, RA, R), e0b (R, Rb))`` with a single 1 at the origin."""
    e = torch.zeros((R, RA, R), dtype=dtype, device=device)
    e[0, 0, 0] = 1.0
    eb = torch.zeros((R, Rb), dtype=dtype, device=device)
    eb[0, 0] = 1.0
    return e, eb


def right_env_chain_plain(x, A, b):
    """Plain PyTorch version of the right chain: ``(envs (d+1, R, RA, R),
    envs_b (d+1, R, Rb))`` with ``envs[k]`` the env of sites k..d-1."""
    d, R, n, _ = x.shape
    RA, Rb = A.shape[1], b.shape[1]
    env, envb = boundary_envs(R, RA, Rb, x.dtype, x.device)
    envs = [env]
    envs_b = [envb]
    for k in range(d - 1, -1, -1):
        env = right_env_update(x[k], A[k], env)
        envb = right_env_b_update(x[k], b[k], envb)
        envs.append(env)
        envs_b.append(envb)
    return torch.stack(envs[::-1]), torch.stack(envs_b[::-1])


def left_env_chain_plain(x, A, b):
    """Plain PyTorch version of the left chain: ``envs[k]`` covers sites
    0..k-1."""
    d, R, n, _ = x.shape
    RA, Rb = A.shape[1], b.shape[1]
    env, envb = boundary_envs(R, RA, Rb, x.dtype, x.device)
    envs = [env]
    envs_b = [envb]
    for k in range(d):
        env = left_env_update(x[k], env, A[k])
        envb = left_env_b_update(x[k], envb, b[k])
        envs.append(env)
        envs_b.append(envb)
    return torch.stack(envs), torch.stack(envs_b)


def _launch(name, x, A, b):
    require_real(name, x, A, b)
    d, R, n, _ = x.shape
    RA, Rb = A.shape[1], b.shape[1]
    if (x.shape != (d, R, n, R) or A.shape != (d, RA, n, n, RA)
            or b.shape != (d, Rb, n, Rb)):
        raise ValueError(f"{name}: shapes x{tuple(x.shape)} A{tuple(A.shape)}"
                         f" b{tuple(b.shape)} are not (d,R,n,R), "
                         f"(d,RA,n,n,RA), (d,Rb,n,Rb)")
    x, A, b = x.contiguous(), A.contiguous(), b.contiguous()
    envs = torch.empty((d + 1, R, RA, R), dtype=x.dtype, device=x.device)
    envs_b = torch.empty((d + 1, R, Rb), dtype=x.dtype, device=x.device)
    scratch = torch.empty(2 * n * RA * R * R + n * R * Rb, dtype=x.dtype,
                          device=x.device)
    entry = "env_chain_left" if name.startswith("left") else "env_chain_right"
    _build.call(entry, x.dtype, x.data_ptr(), A.data_ptr(), b.data_ptr(),
                envs.data_ptr(), envs_b.data_ptr(), scratch.data_ptr(),
                d, R, RA, n, Rb)
    return envs, envs_b


@counted
def right_env_chain_fused(x, A, b):
    """Whole right-environment build: ``x (d, R, n, R)`` masked state,
    ``A (d, RA, n, n, RA)``, ``b (d, Rb, n, Rb)``. Returns ``(envs
    (d+1, R, RA, R), envs_b (d+1, R, Rb))``."""
    if not use_kernel(x, A, b):
        return right_env_chain_plain(x, A, b)
    out = _launch("right_env_chain_fused", x, A, b)
    right_env_chain_fused.launches += 1
    return out


@counted
def left_env_chain_fused(x, A, b):
    """Whole left-environment build, the forward mirror of
    :func:`right_env_chain_fused`."""
    if not use_kernel(x, A, b):
        return left_env_chain_plain(x, A, b)
    out = _launch("left_env_chain_fused", x, A, b)
    left_env_chain_fused.launches += 1
    return out
