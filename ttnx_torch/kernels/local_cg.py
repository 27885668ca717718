"""Kernel B3: fixed-iteration CG on the dense masked local operator.

One ALS microstep solves ``K v = rhs`` with ``K (M, M)``, ``M = R * n * R``.
At rank 16 (``M = 512``) the dense K is assembled and
:func:`cg_solve_fused` runs every CG iteration, plus the warm-start
matvec, in one launch of the Hopper kernel (``csrc/local_cg.cu``) for a
CUDA tensor, or :func:`cg_solve_plain` for a CPU tensor.

``x0`` and ``iters`` are keyword-only (the JAX twin takes ``x0`` as its
third positional parameter, ahead of ``iters``).
"""

from __future__ import annotations

import torch

from ttnx_torch.kernels import _build
from ttnx_torch.kernels.dispatch import counted, require_real, use_kernel

__all__ = ["cg_solve_fused", "cg_solve_plain"]


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
        return cg_solve_plain(K, rhs, x0=x0, iters=iters)
    require_real("cg_solve_fused", *args)
    M = K.shape[0]
    if K.shape != (M, M) or rhs.shape != (M,) or (
            x0 is not None and x0.shape != (M,)):
        raise ValueError("cg_solve_fused: K must be (M, M), rhs and x0 (M,)")
    K, rhs = K.contiguous(), rhs.contiguous()
    x0c = rhs if x0 is None else x0.contiguous()  # unread when cold
    out = torch.empty_like(rhs)
    _build.call("cg_solve", K.dtype, K.data_ptr(), rhs.data_ptr(),
                x0c.data_ptr(), out.data_ptr(), M, int(iters),
                int(x0 is not None))
    cg_solve_fused.launches += 1
    return out
