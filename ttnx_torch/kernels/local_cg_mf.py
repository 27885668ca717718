"""Kernel B4: matrix-free fixed-iteration CG for the ALS local solve.

Above ``M = R n R = 1024`` the dense local K is not assembled; CG applies

    K v[a,i,c] = sum L[a,W,b] Ac[W,i,J,w] Renv[c,w,d] v[b,J,d]

with the identity on masked-out (padded) directions. :func:`cg_matfree_fused`
runs the whole solve in one launch of the Hopper kernel
(``csrc/local_cg_mf.cu``) for CUDA tensors and :func:`cg_matfree_plain` for
CPU tensors. On the card it serves every real shape, including R < 32
(it computes what the einsum ``'cg'`` path computes).

``x0`` and ``iters`` are keyword-only.
"""

from __future__ import annotations

import torch

from ttnx_torch.kernels import _build
from ttnx_torch.kernels.dispatch import counted, require_real, use_kernel
from ttnx_torch.kernels.local_cg import _safe_div

__all__ = ["cg_matfree_fused", "cg_matfree_plain", "apply_local_op"]


def apply_local_op(L, Ac, Renv, v):
    """``out[a,i,c] = sum L[a,W,b] Ac[W,i,J,w] Renv[c,w,d] v[b,J,d]`` as
    pairwise contractions."""
    s = torch.einsum("bJd,cwd->bJcw", v, Renv)
    m = torch.einsum("WiJw,bJcw->Wibc", Ac, s)
    return torch.einsum("aWb,Wibc->aic", L, m)


def _vdot(a, b):
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def cg_matfree_plain(L, Ac, Renv, rhs, mask, *, x0=None, iters: int = 32):
    """Plain PyTorch version of the masked matrix-free CG; returns
    ``x * mask``."""
    rhs = rhs * mask

    def apply_k(p):
        return apply_local_op(L, Ac, Renv, p * mask) * mask + (1.0 - mask) * p

    if x0 is None:
        x = torch.zeros_like(rhs)
        r = rhs
    else:
        x = x0 * mask
        r = rhs - apply_k(x)
    p = r
    rs = _vdot(r, r)
    for _ in range(iters):
        ap = apply_k(p)
        alpha = _safe_div(rs, _vdot(p, ap))
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _vdot(r, r)
        beta = _safe_div(rs_new, rs)
        p = r + beta * p
        rs = rs_new
    return x * mask


@counted
def cg_matfree_fused(L, Ac, Renv, rhs, mask, *, x0=None, iters: int = 32):
    """Masked matrix-free CG, optionally warm-started at ``x0``. ``L/Renv
    (R, RA, R)``, ``Ac (RA, n, n, RA)``, ``rhs/mask/x0 (R, n, R)``; returns
    ``x (R, n, R)``."""
    args = (L, Ac, Renv, rhs, mask) + (() if x0 is None else (x0,))
    if not use_kernel(*args):
        return cg_matfree_plain(L, Ac, Renv, rhs, mask, x0=x0, iters=iters)
    require_real("cg_matfree_fused", *args)
    R, RA, _ = L.shape
    n = rhs.shape[1]
    vec = (R, n, R)
    if (L.shape != (R, RA, R) or Renv.shape != (R, RA, R)
            or Ac.shape != (RA, n, n, RA) or rhs.shape != vec
            or mask.shape != vec or (x0 is not None and x0.shape != vec)):
        raise ValueError("cg_matfree_fused: expected L/Renv (R, RA, R), "
                         "Ac (RA, n, n, RA), rhs/mask/x0 (R, n, R)")
    L, Ac, Renv = L.contiguous(), Ac.contiguous(), Renv.contiguous()
    rhs, mask = rhs.contiguous(), mask.contiguous()
    x0c = rhs if x0 is None else x0.contiguous()  # unread when cold
    out = torch.empty_like(rhs)
    V = R * n * R
    scratch = torch.empty(3 * V + 2 * RA * V, dtype=rhs.dtype,
                          device=rhs.device)
    _build.call("cg_matfree", rhs.dtype, L.data_ptr(), Ac.data_ptr(),
                Renv.data_ptr(), rhs.data_ptr(), mask.data_ptr(),
                x0c.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                R, RA, n, int(iters), int(x0 is not None))
    cg_matfree_fused.launches += 1
    return out
