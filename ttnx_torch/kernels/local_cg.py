"""Kernels B3 and B10: fixed-iteration CG and BiCGStab on the dense masked
local operator.

One ALS microstep solves ``K v = rhs`` with ``K (M, M)``, ``M = R * n * R``.
At rank 16 (``M = 512``) the dense K is assembled and
:func:`cg_solve_fused` (SPD K) runs every CG iteration, plus the
warm-start matvec, in one launch of the Hopper kernel
(``csrc/local_cg.cu``) for a CUDA tensor, or :func:`cg_solve_plain` for a
CPU tensor. :func:`bicgstab_solve_fused` does the same for a general K
by BiCGStab, always from a cold start as the JAX kernel does.

``x0`` and ``iters`` are keyword-only (the JAX twin takes ``x0`` as its
third positional parameter, ahead of ``iters``).

B3 and B10 pick their kernels by dtype and size, never on a failure
(:func:`cg_route`, :func:`bicgstab_route`):
``"cluster"`` — f32 with ``M <= CG_CLUSTER_MAX_M`` / ``CLUSTER_MAX_M``,
one cluster of 8 CTAs holding K's rows in their shared memory
(``csrc/dense_cluster.cuh``); ``"l2"`` — f64 and larger M, one block
streaming K from L2.
"""

from __future__ import annotations

import torch

from ttnx_torch.kernels import _build
from ttnx_torch.kernels.dispatch import counted, require_real, use_kernel

__all__ = ["cg_solve_fused", "cg_solve_plain", "cg_route", "cg_cluster_smem",
           "bicgstab_solve_fused", "bicgstab_solve_plain", "bicgstab_route",
           "cluster_smem"]

SMEM_BLOCK = 232448  # shared memory one block can use on the H100
CLUSTER = 8          # CTAs of the cluster route: the portable maximum


def _up4(x: int) -> int:
    return (x + 3) // 4 * 4


def cluster_smem(M: int, C: int = CLUSTER) -> int:
    """Bytes of shared memory one CTA of the cluster route holds for K (M,
    M): its ``ceil(M / C)`` rows of K and full p and s (rows of ``up4(M)``
    floats), its slices of x, r, rhat, v, t and four slot arrays of C."""
    rpc = (M + C - 1) // C
    return 4 * (rpc * _up4(M) + 2 * _up4(M) + 5 * _up4(rpc) + 4 * C)


CLUSTER_MAX_M = max(M for M in range(1, 1025)
                    if cluster_smem(M) <= SMEM_BLOCK)  # 668


def cg_cluster_smem(M: int, C: int = CLUSTER) -> int:
    """Bytes of shared memory one CTA of B3's cluster route holds for K
    (M, M): its ``ceil(M / C)`` rows of K and full p and r (rows of
    ``up4(M)`` floats), its slices of x and K p and two slot arrays of
    C."""
    rpc = (M + C - 1) // C
    return 4 * (rpc * _up4(M) + 2 * _up4(M) + 2 * _up4(rpc) + 2 * C)


CG_CLUSTER_MAX_M = max(M for M in range(1, 1025)
                       if cg_cluster_smem(M) <= SMEM_BLOCK)  # 672


def cg_route(dtype, M: int) -> str:
    """The kernel of :func:`cg_solve_fused` for ``K (M, M)``:
    ``"cluster"`` or ``"l2"``."""
    return "cluster" if dtype == torch.float32 and M <= CG_CLUSTER_MAX_M \
        else "l2"


def bicgstab_route(dtype, M: int) -> str:
    """The kernel of :func:`bicgstab_solve_fused` for ``K (M, M)``:
    ``"cluster"`` or ``"l2"``."""
    return "cluster" if dtype == torch.float32 and M <= CLUSTER_MAX_M \
        else "l2"


def _safe_div(a, c):
    ok = c.abs() > 0
    return torch.where(ok, a / torch.where(ok, c, torch.ones_like(c)),
                       torch.zeros_like(a))


def cg_solve_plain(K, rhs, *, x0=None, iters: int = 48):
    """Plain PyTorch version: ``iters`` CG steps on SPD ``K``, from ``x0``
    (one extra matvec) or from zero. No host syncs."""
    if x0 is None:
        x = torch.zeros_like(rhs)
        r = rhs
    else:
        x = x0
        r = rhs - K @ x0
    p = r
    rs = torch.dot(r, r)
    for _ in range(iters):
        ap = K @ p
        alpha = _safe_div(rs, torch.dot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        beta = _safe_div(rs_new, rs)
        p = r + beta * p
        rs = rs_new
    return x


@counted
def cg_solve_fused(K, rhs, *, x0=None, iters: int = 48):
    """Solve ``K x = rhs`` (SPD ``K (M, M)``, ``rhs (M,)``) by ``iters`` CG
    steps, optionally warm-started at ``x0``: one Hopper kernel launch for
    CUDA tensors (real f32/f64), the plain version for CPU tensors."""
    args = (K, rhs) if x0 is None else (K, rhs, x0)
    if not use_kernel(*args):
        return cg_solve_plain(K, rhs, x0=x0, iters=iters), None
    require_real("cg_solve_fused", *args)
    M = K.shape[0]
    if K.shape != (M, M) or rhs.shape != (M,) or (
            x0 is not None and x0.shape != (M,)):
        raise ValueError("cg_solve_fused: K must be (M, M), rhs and x0 (M,)")
    K, rhs = K.contiguous(), rhs.contiguous()
    x0c = rhs if x0 is None else x0.contiguous()  # unread when cold
    out = torch.empty_like(rhs)
    route = cg_route(K.dtype, M)
    _build.call("cg_solve_cluster" if route == "cluster" else "cg_solve",
                K.dtype, K.data_ptr(), rhs.data_ptr(), x0c.data_ptr(),
                out.data_ptr(), M, int(iters), int(x0 is not None))
    return out, route


def bicgstab_solve_plain(K, rhs, *, iters: int = 32):
    """Plain PyTorch version of :func:`bicgstab_solve_fused`: ``iters``
    unpreconditioned BiCGStab steps from zero with ``rhat = rhs``, every
    division guarded (a zero denominator gives 0). No host syncs."""
    x = torch.zeros_like(rhs)
    r = rhs
    rhat = rhs
    rho = torch.dot(rhat, r)
    p = r
    for _ in range(iters):
        v = K @ p
        alpha = _safe_div(rho, torch.dot(rhat, v))
        s = r - alpha * v
        t = K @ s
        omega = _safe_div(torch.dot(t, s), torch.dot(t, t))
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho_new = torch.dot(rhat, r)
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        rho = rho_new
    return x


@counted
def bicgstab_solve_fused(K, rhs, *, iters: int = 32):
    """Solve ``K x = rhs`` for a general ``K (M, M)``, ``rhs (M,)`` by
    ``iters`` BiCGStab steps from zero: one Hopper kernel launch for CUDA
    tensors (real f32/f64), the plain version for CPU tensors."""
    if not use_kernel(K, rhs):
        return bicgstab_solve_plain(K, rhs, iters=iters), None
    require_real("bicgstab_solve_fused", K, rhs)
    M = K.shape[0]
    if K.shape != (M, M) or rhs.shape != (M,) or iters < 0:
        raise ValueError("bicgstab_solve_fused: K must be (M, M), rhs (M,), "
                         "iters >= 0")
    K, rhs = K.contiguous(), rhs.contiguous()
    out = torch.empty_like(rhs)
    route = bicgstab_route(K.dtype, M)
    _build.call("bicgstab_cluster" if route == "cluster" else "bicgstab",
                K.dtype, K.data_ptr(), rhs.data_ptr(), out.data_ptr(), M,
                int(iters))
    return out, route
