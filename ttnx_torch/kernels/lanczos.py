"""Kernel B9: fixed-iteration Lanczos with full reorthogonalization on a
dense symmetric matrix, the DMRG local eigensolve of
``eig_solver='lanczos_fused'``.

:func:`lanczos_fused` runs every step in one launch of a Hopper kernel
(``csrc/lanczos.cu``) for CUDA tensors and :func:`lanczos_plain` for CPU
tensors. Both return ``(Q (iters, M), alphas (iters,), betas (iters,))``:
two reorthogonalization passes against every stored row a step; a
breakdown (``|w| <= 1e-12``) writes ``betas[j] = 0`` and leaves every later
row of ``Q`` and every later alpha exactly zero; ``betas[iters-1]`` is
always 0. ``iters`` is keyword-only.

The kernel is picked by dtype and size, never on a failure
(:func:`lanczos_route`): ``"cluster"`` — f32 with ``M <=
CLUSTER_MAX_M``, one cluster of ``CLUSTER`` CTAs (a non-portable size),
each holding as many of its rows of K in shared memory as
:func:`cluster_layout` finds room for and streaming the rest from L2
(``csrc/dense_cluster.cuh``); ``"l2"`` — f64 and larger M, one block
streaming K from L2.
"""

from __future__ import annotations

import torch

from ttnx_torch.kernels import _build
from ttnx_torch.kernels.dispatch import counted, require_real, use_kernel

__all__ = ["lanczos_fused", "lanczos_plain", "can_fuse_lanczos",
           "lanczos_route", "cluster_layout"]

TINY = 1e-12
SMEM_BLOCK = 232448  # shared memory one block can use on the H100
CLUSTER = 16         # CTAs of the cluster route
CLUSTER_MAX_M = 1024  # a streamed row is 32 loads a lane at most


def _up4(x: int) -> int:
    return (x + 3) // 4 * 4


def cluster_layout(M: int, iters: int, C: int = CLUSTER,
                   budget: int = SMEM_BLOCK) -> dict:
    """One CTA's shared memory in the cluster route, as
    ``lanczos_cluster_layout`` in ``csrc/lanczos.cu`` computes it:
    ``fixed`` floats (full v, its w slice, the coefficients and slot
    arrays), the basis slice in shared memory (``q_in_smem``) when it
    fits, ``resident`` rows of K (at most ``ceil(M / C)``) in what is left
    of ``budget`` bytes, and ``bytes`` in all."""
    ld, rpc = _up4(M), (M + C - 1) // C
    rp4 = _up4(rpc)
    fixed = ld + rp4 + _up4(iters) + 2 * _up4(iters * C) + _up4(C)
    cap, q = budget // 4, iters * rp4
    q_in_smem = fixed + q <= cap
    used = fixed + (q if q_in_smem else 0)
    resident = min(rpc, max(cap - used, 0) // ld)
    return dict(fixed=fixed, q_in_smem=q_in_smem, resident=resident,
                bytes=4 * (used + resident * ld))


def lanczos_route(dtype, M: int) -> str:
    """The kernel of :func:`lanczos_fused` for ``K (M, M)``:
    ``"cluster"`` or ``"l2"``."""
    return "cluster" if dtype == torch.float32 and M <= CLUSTER_MAX_M \
        else "l2"


def can_fuse_lanczos(dtype, M: int) -> bool:
    """Dense-K Lanczos (kernel B9) for real dtypes at ``M <= 1024``, the
    JAX package's rule; larger or complex problems take the matrix-free
    Lanczos."""
    return not dtype.is_complex and M <= 1024


def lanczos_plain(K, v0, *, iters: int = 16):
    """Plain PyTorch version of :func:`lanczos_fused`. No host syncs."""
    M = K.shape[0]
    Q = torch.zeros((iters, M), dtype=K.dtype, device=K.device)
    alphas = torch.zeros(iters, dtype=K.dtype, device=K.device)
    betas = torch.zeros(iters, dtype=K.dtype, device=K.device)
    zero = torch.zeros((), dtype=K.dtype, device=K.device)
    v = v0
    for j in range(iters):
        Q[j] = v
        w = K @ v
        alphas[j] = torch.dot(v, w)
        if j + 1 == iters:
            break
        for _ in range(2):
            w = w - Q.T @ (Q @ w)
        b = torch.sqrt(torch.clamp(torch.dot(w, w), min=0.0))
        ok = b > TINY
        betas[j] = torch.where(ok, b, zero)
        v = torch.where(ok, w / torch.clamp(b, min=TINY), zero)
    return Q, alphas, betas


@counted
def lanczos_fused(K, v0, *, iters: int = 16):
    """``iters`` Lanczos steps on symmetric ``K (M, M)`` from the unit
    vector ``v0 (M,)``: one Hopper kernel launch for CUDA tensors (real
    f32/f64), the plain version for CPU tensors."""
    if not use_kernel(K, v0):
        return lanczos_plain(K, v0, iters=iters), None
    require_real("lanczos_fused", K, v0)
    M = K.shape[0]
    if K.shape != (M, M) or v0.shape != (M,) or iters < 1:
        raise ValueError("lanczos_fused: K must be (M, M), v0 (M,), "
                         "iters >= 1")
    K, v0 = K.contiguous(), v0.contiguous()
    Q = torch.empty((iters, M), dtype=K.dtype, device=K.device)
    alphas = torch.empty(iters, dtype=K.dtype, device=K.device)
    betas = torch.empty(iters, dtype=K.dtype, device=K.device)
    route = lanczos_route(K.dtype, M)
    _build.call("lanczos_cluster" if route == "cluster" else "lanczos",
                K.dtype, K.data_ptr(), v0.data_ptr(), Q.data_ptr(),
                alphas.data_ptr(), betas.data_ptr(), M, int(iters))
    return (Q, alphas, betas), route
