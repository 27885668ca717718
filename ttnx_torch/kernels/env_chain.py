"""Kernels B2, B6 and B8: the environment chains (right and left) of the
ALS sweeps, for one problem (B2) or a batch of problems with a shared
operator (B6), and the operator-only chain of the DMRG eigensweeps (B8).

The right-env build is a backward recurrence of pure contractions::

    Renv_d = e0 e0^T,  Renv_k[a,W,b] = sum x[a,i,p] A[W,i,j,w] x[b,j,q] Renv_{k+1}[p,w,q]
    Rb_d   = e0 e0^T,  Rb_k[a,u]     = sum x[a,i,p] b[u,i,v] Rb_{k+1}[p,v]

and the left build its forward mirror. :func:`right_env_chain_fused` and
:func:`left_env_chain_fused` run the whole chain through a Hopper kernel
for CUDA tensors and through the plain versions for CPU tensors.
:func:`env_chain_fused_batched` builds either chain for B problems with
one kernel call; :func:`env_chain_batched_plain` is its plain version.
:func:`env_chain_A_fused` builds the operator envs alone (no rhs), with
:func:`env_chain_A_plain` as its plain version.

B2 and B6 pick their kernel by dtype and shape before the launch, never on
a failure (:func:`env_route`; each wrapper keeps the route of its last
launch in its ``route`` attribute): ``"resident"`` — B6 in f32 at R = 64
or 32 with n = 2, RA = 4, Rb = R: one block a problem walks its whole
chain with the envs in shared memory (``csrc/env_chain_site.cu``);
``"cluster"`` — one chain (B2, or B6 at B = 1) in f32 at R = 64, 32 or 16
with the same n, RA, Rb: one thread-block cluster of R / 4 CTAs, each
owning four columns of the new envs (the same source); ``"staged"`` —
the multi-launch kernels of ``csrc/env_chain.cu`` (a few launches a site)
for f64 and every other shape. B8 picks its kernel by :func:`env_A_route`
(separate from :func:`env_route`, so forcing one leaves the other):
``"cluster"`` — f32 at R = 64, 32 or 16 with n = 2, RA = 5 (the XXX and
XXZ MPOs): B2's cluster update with no rhs (the same source);
``"staged"`` — ``csrc/env_chain.cu`` for f64 and every other shape.
:func:`site_layout` mirrors the site kernels' shared-memory layout.

``x`` must already carry its rank masks. Every plain
contraction is written as pairwise steps (no three-operand einsum: without
``opt_einsum`` torch contracts left to right through huge intermediates),
and takes any leading batch axes on the state, rhs and env operands.
"""

from __future__ import annotations

import torch

from ttnx_torch.kernels import _build
from ttnx_torch.kernels.dispatch import counted, require_real, use_kernel

__all__ = ["right_env_chain_fused", "left_env_chain_fused",
           "right_env_chain_plain", "left_env_chain_plain",
           "env_chain_fused_batched", "env_chain_batched_plain",
           "env_chain_A_fused", "env_chain_A_plain", "env_route",
           "env_A_route", "site_layout", "RESIDENT_SLAB", "CLUSTER_RANKS",
           "right_env_update", "right_env_b_update", "left_env_update",
           "left_env_b_update", "boundary_envs"]

SMEM_BLOCK = 232448  # shared memory one block can use on the H100
RESIDENT_SLAB = {64: 8, 32: 16}  # R -> slab width of route resident
# R of route cluster, on R / 4 CTAs of four env columns each (16 CTAs at
# R = 64, a non-portable cluster size)
CLUSTER_RANKS = (64, 32, 16)


def site_layout(R: int, S: int, RA: int = 4, rhs: bool = True) -> dict:
    """One block's shared memory in routes resident and cluster at rank R,
    slab width S and MPO bond RA, with the rhs envs (B2, B6) or without
    (B8), as ``EnvLayout`` in ``csrc/env_site.cuh`` lays it out (n = 2):
    ``floats`` and ``bytes``."""
    ldp, ldr, lds, ldq = R + 4, RA * R + 4, 2 * R + 4, R + 4
    floats = 2 * R * ldr + 2 * R * ldp + RA * S * lds + RA * 2 * 2 * RA
    if rhs:
        floats += 2 * R * ldq + 2 * 2 * S * ldp
    return dict(floats=floats, bytes=4 * floats)


def env_route(dtype, B: int, R: int, n: int, RA: int, Rb: int) -> str:
    """The kernel of B2 (``B == 1``) or B6 for ``B`` problems of rank
    ``R``: ``"resident"``, ``"cluster"`` or ``"staged"``."""
    if dtype != torch.float32 or n != 2 or RA != 4 or Rb != R:
        return "staged"
    if B == 1 and R in CLUSTER_RANKS:
        return "cluster"
    if B > 1 and R in RESIDENT_SLAB:
        return "resident"
    return "staged"


def env_A_route(dtype, R: int, n: int, RA: int) -> str:
    """The kernel of B8 for a chain of rank ``R``: ``"cluster"`` or
    ``"staged"``."""
    if dtype == torch.float32 and n == 2 and RA == 5 and R in CLUSTER_RANKS:
        return "cluster"
    return "staged"


def right_env_update(xc, Ac, Renv):
    """``new[a,W,b] = sum conj(x)[a,i,p] A[W,i,j,w] x[b,j,q] Renv[p,w,q]``."""
    t = torch.einsum("...bjq,...pwq->...bjpw", xc, Renv)
    t = torch.einsum("Wijw,...bjpw->...Wibp", Ac, t)
    return torch.einsum("...aip,...Wibp->...aWb", xc.conj(), t)


def right_env_b_update(xc, bc, Rb_env):
    """``new_b[a,u] = sum conj(x)[a,i,p] b[u,i,v] Rb[p,v]``."""
    t = torch.einsum("...uiv,...pv->...uip", bc, Rb_env)
    return torch.einsum("...aip,...uip->...au", xc.conj(), t)


def left_env_update(xc, L, Ac):
    """``new[c,w,d] = sum conj(x)[a,i,c] L[a,W,b] A[W,i,j,w] x[b,j,d]``."""
    t = torch.einsum("...aic,...aWb->...icWb", xc.conj(), L)
    t = torch.einsum("...icWb,Wijw->...cbjw", t, Ac)
    return torch.einsum("...cbjw,...bjd->...cwd", t, xc)


def left_env_b_update(xc, Lb, bc):
    """``new_b[p,v] = sum conj(x)[a,i,p] Lb[a,u] b[u,i,v]``."""
    t = torch.einsum("...aip,...au->...ipu", xc.conj(), Lb)
    return torch.einsum("...ipu,...uiv->...pv", t, bc)


def boundary_envs(R, RA, Rb, dtype, device):
    """``(e0 (R, RA, R), e0b (R, Rb))`` with a single 1 at the origin."""
    e = torch.zeros((R, RA, R), dtype=dtype, device=device)
    e[0, 0, 0] = 1.0
    eb = torch.zeros((R, Rb), dtype=dtype, device=device)
    eb[0, 0] = 1.0
    return e, eb


def _chain_plain(x, A, b, left):
    """Either chain over ``x (..., d, R, n, R)`` with any leading batch
    axes: ``(envs (..., d+1, R, RA, R), envs_b (..., d+1, R, Rb))``."""
    batch = x.shape[:-4]
    d, R = x.shape[-4], x.shape[-3]
    RA, Rb = A.shape[1], b.shape[-3]
    env, envb = boundary_envs(R, RA, Rb, x.dtype, x.device)
    env = env.expand(*batch, R, RA, R)
    envb = envb.expand(*batch, R, Rb)
    envs, envs_b = [env], [envb]
    for k in (range(d) if left else range(d - 1, -1, -1)):
        xk, bk = x[..., k, :, :, :], b[..., k, :, :, :]
        if left:
            env = left_env_update(xk, env, A[k])
            envb = left_env_b_update(xk, envb, bk)
        else:
            env = right_env_update(xk, A[k], env)
            envb = right_env_b_update(xk, bk, envb)
        envs.append(env)
        envs_b.append(envb)
    if not left:
        envs, envs_b = envs[::-1], envs_b[::-1]
    return torch.stack(envs, dim=-4), torch.stack(envs_b, dim=-3)


def right_env_chain_plain(x, A, b):
    """Plain PyTorch version of the right chain: ``(envs (d+1, R, RA, R),
    envs_b (d+1, R, Rb))`` with ``envs[k]`` the env of sites k..d-1."""
    return _chain_plain(x, A, b, left=False)


def left_env_chain_plain(x, A, b):
    """Plain PyTorch version of the left chain: ``envs[k]`` covers sites
    0..k-1."""
    return _chain_plain(x, A, b, left=True)


def env_chain_batched_plain(x, A, b, *, left: bool = False,
                            raw: bool = False):
    """Plain PyTorch version of :func:`env_chain_fused_batched`."""
    envs, envs_b = _chain_plain(x, A, b, left)
    if raw:
        envs = envs.transpose(-3, -2).contiguous()
    return envs, envs_b


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
    left = name.startswith("left")
    route = env_route(x.dtype, 1, R, n, RA, Rb)
    if route == "cluster":
        _build.call("env_chain_cluster", x.dtype, x.data_ptr(),
                    A.data_ptr(), b.data_ptr(), envs.data_ptr(),
                    envs_b.data_ptr(), d, R, RA, n, Rb, int(left), 0)
        return envs, envs_b, route
    scratch = torch.empty(2 * n * RA * R * R + n * R * Rb, dtype=x.dtype,
                          device=x.device)
    _build.call("env_chain_left" if left else "env_chain_right", x.dtype,
                x.data_ptr(), A.data_ptr(), b.data_ptr(), envs.data_ptr(),
                envs_b.data_ptr(), scratch.data_ptr(), d, R, RA, n, Rb)
    return envs, envs_b, route


@counted
def right_env_chain_fused(x, A, b):
    """Whole right-environment build: ``x (d, R, n, R)`` masked state,
    ``A (d, RA, n, n, RA)``, ``b (d, Rb, n, Rb)``. Returns ``(envs
    (d+1, R, RA, R), envs_b (d+1, R, Rb))``."""
    if not use_kernel(x, A, b):
        return right_env_chain_plain(x, A, b)
    *out, right_env_chain_fused.route = _launch("right_env_chain_fused", x,
                                                A, b)
    right_env_chain_fused.launches += 1
    return tuple(out)


@counted
def left_env_chain_fused(x, A, b):
    """Whole left-environment build, the forward mirror of
    :func:`right_env_chain_fused`."""
    if not use_kernel(x, A, b):
        return left_env_chain_plain(x, A, b)
    *out, left_env_chain_fused.route = _launch("left_env_chain_fused", x, A,
                                               b)
    left_env_chain_fused.launches += 1
    return tuple(out)


@counted
def env_chain_fused_batched(x, A, b, *, left: bool = False,
                            raw: bool = False):
    """Env chains of B problems with a shared operator: ``x (B, d, R, n, R)``
    masked states, ``A (d, RA, n, n, RA)``, ``b (B, d, Rb, n, Rb)``. Returns
    ``(envs (B, d+1, R, RA, R), envs_b (B, d+1, R, Rb))``, the left chain
    with ``left=True``; ``raw=True`` gives envs as ``(B, d+1, RA, R, R)``."""
    if not use_kernel(x, A, b):
        return env_chain_batched_plain(x, A, b, left=left, raw=raw)
    require_real("env_chain_fused_batched", x, A, b)
    B, d, R, n, _ = x.shape
    RA, Rb = A.shape[1], b.shape[2]
    if (x.shape != (B, d, R, n, R) or A.shape != (d, RA, n, n, RA)
            or b.shape != (B, d, Rb, n, Rb)):
        raise ValueError(f"env_chain_fused_batched: shapes x{tuple(x.shape)}"
                         f" A{tuple(A.shape)} b{tuple(b.shape)} are not "
                         f"(B,d,R,n,R), (d,RA,n,n,RA), (B,d,Rb,n,Rb)")
    x, A = x.contiguous(), A.contiguous()
    env_shape = (RA, R, R) if raw else (R, RA, R)
    envs = torch.empty((B, d + 1) + env_shape, dtype=x.dtype,
                       device=x.device)
    envs_b = torch.empty((B, d + 1, R, Rb), dtype=x.dtype, device=x.device)
    route = env_route(x.dtype, B, R, n, RA, Rb)
    if route == "resident":
        # one rhs broadcast over the batch is read in place (stride 0)
        shared = b.stride(0) == 0 and b[0].is_contiguous()
        b = b if shared else b.contiguous()
        _build.call("env_chain_resident", x.dtype, x.data_ptr(),
                    A.data_ptr(), b.data_ptr(), envs.data_ptr(),
                    envs_b.data_ptr(), 0 if shared else b[0].numel(), B, d,
                    R, RA, n, Rb, int(left), int(raw))
    elif route == "cluster":
        b = b.contiguous()
        _build.call("env_chain_cluster", x.dtype, x.data_ptr(),
                    A.data_ptr(), b.data_ptr(), envs.data_ptr(),
                    envs_b.data_ptr(), d, R, RA, n, Rb, int(left),
                    int(raw))
    else:
        b = b.contiguous()
        scratch = torch.empty(B * (2 * n * RA * R * R + n * R * Rb),
                              dtype=x.dtype, device=x.device)
        _build.call("env_chain_batched", x.dtype, x.data_ptr(),
                    A.data_ptr(), b.data_ptr(), envs.data_ptr(),
                    envs_b.data_ptr(), scratch.data_ptr(), B, d, R, RA, n,
                    Rb, int(left), int(raw))
    env_chain_fused_batched.launches += 1
    env_chain_fused_batched.route = route
    return envs, envs_b


def env_chain_A_plain(x, A, *, left: bool = False):
    """Plain PyTorch version of :func:`env_chain_A_fused`."""
    d, R = x.shape[0], x.shape[1]
    env, _ = boundary_envs(R, A.shape[1], 1, x.dtype, x.device)
    envs = [env]
    for k in (range(d) if left else range(d - 1, -1, -1)):
        env = (left_env_update(x[k], env, A[k]) if left
               else right_env_update(x[k], A[k], env))
        envs.append(env)
    return torch.stack(envs if left else envs[::-1])


@counted
def env_chain_A_fused(x, A, *, left: bool = False):
    """Operator-only env chain of the eigensweeps: ``x (d, R, n, R)``
    masked state, ``A (d, RA, n, n, RA)``. Returns ``envs (d+1, R, RA,
    R)``: the right chain (``envs[k]`` covers sites k..d-1), or the left
    chain with ``left=True`` (``envs[k]`` covers sites 0..k-1)."""
    if not use_kernel(x, A):
        return env_chain_A_plain(x, A, left=left)
    require_real("env_chain_A_fused", x, A)
    d, R, n, _ = x.shape
    RA = A.shape[1]
    if x.shape != (d, R, n, R) or A.shape != (d, RA, n, n, RA):
        raise ValueError(f"env_chain_A_fused: shapes x{tuple(x.shape)} "
                         f"A{tuple(A.shape)} are not (d,R,n,R), "
                         f"(d,RA,n,n,RA)")
    x, A = x.contiguous(), A.contiguous()
    envs = torch.empty((d + 1, R, RA, R), dtype=x.dtype, device=x.device)
    route = env_A_route(x.dtype, R, n, RA)
    if route == "cluster":
        _build.call("env_chain_A_cluster", x.dtype, x.data_ptr(),
                    A.data_ptr(), envs.data_ptr(), d, R, RA, n, int(left))
    else:
        scratch = torch.empty(2 * n * RA * R * R, dtype=x.dtype,
                              device=x.device)
        _build.call("env_chain_A_left" if left else "env_chain_A_right",
                    x.dtype, x.data_ptr(), A.data_ptr(), envs.data_ptr(),
                    scratch.data_ptr(), d, R, RA, n)
    env_chain_A_fused.launches += 1
    env_chain_A_fused.route = route
    return envs


right_env_chain_fused.route = None
left_env_chain_fused.route = None
env_chain_fused_batched.route = None
env_chain_A_fused.route = None
