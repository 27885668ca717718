"""Kernel B9: fixed-iteration Lanczos with full reorthogonalization on a
dense symmetric matrix, the DMRG local eigensolve of
``eig_solver='lanczos_fused'``.

:func:`lanczos_fused` runs every step in one launch of the Hopper kernel
(``csrc/lanczos.cu``) for CUDA tensors and :func:`lanczos_plain` for CPU
tensors. Both return ``(Q (iters, M), alphas (iters,), betas (iters,))``:
two reorthogonalization passes against every stored row a step; a
breakdown (``|w| <= 1e-12``) writes ``betas[j] = 0`` and leaves every later
row of ``Q`` and every later alpha exactly zero; ``betas[iters-1]`` is
always 0. ``iters`` is keyword-only.
"""

from __future__ import annotations

import torch

from ttnx_torch.kernels import _build
from ttnx_torch.kernels.dispatch import counted, require_real, use_kernel

__all__ = ["lanczos_fused", "lanczos_plain", "can_fuse_lanczos"]

TINY = 1e-12


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
        return lanczos_plain(K, v0, iters=iters)
    require_real("lanczos_fused", K, v0)
    M = K.shape[0]
    if K.shape != (M, M) or v0.shape != (M,) or iters < 1:
        raise ValueError("lanczos_fused: K must be (M, M), v0 (M,), "
                         "iters >= 1")
    K, v0 = K.contiguous(), v0.contiguous()
    Q = torch.empty((iters, M), dtype=K.dtype, device=K.device)
    alphas = torch.empty(iters, dtype=K.dtype, device=K.device)
    betas = torch.empty(iters, dtype=K.dtype, device=K.device)
    _build.call("lanczos", K.dtype, K.data_ptr(), v0.data_ptr(),
                Q.data_ptr(), alphas.data_ptr(), betas.data_ptr(), M,
                int(iters))
    lanczos_fused.launches += 1
    return Q, alphas, betas
