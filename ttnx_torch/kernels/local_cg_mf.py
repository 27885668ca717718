"""Kernels B4 and B5: matrix-free fixed-iteration CG for the ALS local
solve, for one problem (B4) or a batch of problems (B5).

Above ``M = R n R = 1024`` the dense local K is not assembled; CG applies

    K v[a,i,c] = sum L[a,W,b] Ac[W,i,J,w] Renv[c,w,d] v[b,J,d]

with the identity on masked-out (padded) directions. :func:`cg_matfree_fused`
runs the whole solve in one kernel launch for CUDA tensors and
:func:`cg_matfree_plain` for CPU tensors. On the card it serves every real
shape, including R < 32 (it computes what the einsum ``'cg'`` path
computes).

:func:`cg_matfree_fused_batched` solves B such systems in one launch on a
grid of B blocks, with a shared MPO core and mask and one set of CG
scalars per problem; :func:`cg_matfree_batched_plain` is its plain version
(and, with its conjugating dot, the batched einsum ``'cg'`` path for
complex dtypes too). B4 is the same kernel on a grid of one.

The kernel is chosen by dtype and shape alone, before the launch and never
on a failure (:func:`matfree_route`); each wrapper keeps the route of its
last launch in its ``route`` attribute:

* ``"resident"`` -- ``csrc/local_cg_site.cu``: float32 at ``(R, n, RA)``
  in :data:`RESIDENT_SHAPES`; L and Renv stay in shared memory for the
  whole solve, the apply runs on B7's site engine.
* ``"streamed"`` -- ``csrc/local_cg_mf.cu`` (operands streamed from L2
  every apply): float64 and every other shape.

``x0`` and ``iters`` are keyword-only.
"""

from __future__ import annotations

import torch

from ttnx_torch.kernels import _build
from ttnx_torch.kernels.dispatch import counted, require_real, use_kernel
from ttnx_torch.kernels.local_cg import _safe_div

__all__ = ["cg_matfree_fused", "cg_matfree_plain", "apply_local_op",
           "cg_matfree_fused_batched", "cg_matfree_batched_plain",
           "matfree_route", "RESIDENT_SHAPES"]

# (R, n, RA) the resident kernel is instantiated for: the CN step's and the
# batched bench's rank-64 heat problem and the rank-32 CN step
RESIDENT_SHAPES = ((64, 2, 4), (32, 2, 4))


def matfree_route(dtype, R: int, n: int, RA: int) -> str:
    """The kernel of B4 and B5: ``"resident"`` for float32 at an
    instantiated shape, else ``"streamed"``."""
    if dtype == torch.float32 and (R, n, RA) in RESIDENT_SHAPES:
        return "resident"
    return "streamed"


def _launch(L, Ac, Renv, rhs, mask, x0, iters: int, batched: bool):
    """Launch B5 (``batched``) or B4 on checked operands; returns ``(x,
    route)``. B4's resident route is B5's kernel on a grid of one."""
    L, Ac, Renv = L.contiguous(), Ac.contiguous(), Renv.contiguous()
    rhs, mask = rhs.contiguous(), mask.contiguous()
    x0c = rhs if x0 is None else x0.contiguous()  # unread when cold
    out = torch.empty_like(rhs)
    B = L.shape[0] if batched else 1
    R, RA = L.shape[-3], L.shape[-2]
    n = rhs.shape[-2]
    route = matfree_route(rhs.dtype, R, n, RA)
    V = R * n * R
    per_problem = 3 * V if route == "resident" else 3 * V + 2 * RA * V
    scratch = torch.empty(B * per_problem, dtype=rhs.dtype,
                          device=rhs.device)
    if route == "resident":
        entry, sizes = "cg_matfree_site", (B,)
    elif batched:
        entry, sizes = "cg_matfree_batched", (B,)
    else:
        entry, sizes = "cg_matfree", ()
    _build.call(entry, rhs.dtype, L.data_ptr(), Ac.data_ptr(),
                Renv.data_ptr(), rhs.data_ptr(), mask.data_ptr(),
                x0c.data_ptr(), out.data_ptr(), scratch.data_ptr(), *sizes,
                R, RA, n, int(iters), int(x0 is not None))
    return out, route


def apply_local_op(L, Ac, Renv, v):
    """``out[a,i,c] = sum L[a,W,b] Ac[W,i,J,w] Renv[c,w,d] v[b,J,d]`` as
    pairwise contractions; ``L``, ``Renv`` and ``v`` may carry the same
    leading batch axes, ``Ac`` is shared."""
    s = torch.einsum("...bJd,...cwd->...bJcw", v, Renv)
    m = torch.einsum("WiJw,...bJcw->...Wibc", Ac, s)
    return torch.einsum("...aWb,...Wibc->...aic", L, m)


def _vdot(a, b):
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def cg_matfree_plain(L, Ac, Renv, rhs, mask, *, x0=None, iters: int = 32):
    """Plain PyTorch version of the masked matrix-free CG (the batched one
    on a batch of one); returns ``x * mask``."""
    return cg_matfree_batched_plain(
        L[None], Ac, Renv[None], rhs[None], mask,
        x0=None if x0 is None else x0[None], iters=iters)[0]


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
    out, cg_matfree_fused.route = _launch(L, Ac, Renv, rhs, mask, x0,
                                          iters, batched=False)
    cg_matfree_fused.launches += 1
    return out


def _pdot(a, b):
    """Per-problem ``<a, b>`` over all axes but the leading one."""
    return (a.conj() * b).reshape(a.shape[0], -1).sum(1)


def cg_matfree_batched_plain(L, Ac, Renv, rhs, mask, *, x0=None,
                             iters: int = 32):
    """Plain PyTorch version of the batched masked matrix-free CG: ``L/Renv
    (B, R, RA, R)``, shared ``Ac (RA, n, n, RA)`` and ``mask (R, n, R)``,
    ``rhs/x0 (B, R, n, R)``; CG scalars per problem. Returns ``x * mask``."""
    rhs = rhs * mask

    def apply_k(p):
        return apply_local_op(L, Ac, Renv, p * mask) * mask + (1.0 - mask) * p

    def per_problem(c):
        return c[:, None, None, None]

    if x0 is None:
        x = torch.zeros_like(rhs)
        r = rhs
    else:
        x = x0 * mask
        r = rhs - apply_k(x)
    p = r
    rs = _pdot(r, r)
    for _ in range(iters):
        ap = apply_k(p)
        alpha = per_problem(_safe_div(rs, _pdot(p, ap)))
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _pdot(r, r)
        p = r + per_problem(_safe_div(rs_new, rs)) * p
        rs = rs_new
    return x * mask


@counted
def cg_matfree_fused_batched(L, Ac, Renv, rhs, mask, *, x0=None,
                             iters: int = 32):
    """Batched masked matrix-free CG, optionally warm-started at ``x0``:
    ``L/Renv (B, R, RA, R)``, shared ``Ac (RA, n, n, RA)`` and ``mask
    (R, n, R)``, ``rhs/x0 (B, R, n, R)``. Returns ``x (B, R, n, R)``."""
    args = (L, Ac, Renv, rhs, mask) + (() if x0 is None else (x0,))
    if not use_kernel(*args):
        return cg_matfree_batched_plain(L, Ac, Renv, rhs, mask, x0=x0,
                                        iters=iters)
    require_real("cg_matfree_fused_batched", *args)
    B, R, RA, _ = L.shape
    n = rhs.shape[2]
    vec = (B, R, n, R)
    if (Renv.shape != (B, R, RA, R) or Ac.shape != (RA, n, n, RA)
            or rhs.shape != vec or mask.shape != (R, n, R)
            or (x0 is not None and x0.shape != vec)):
        raise ValueError("cg_matfree_fused_batched: expected L/Renv "
                         "(B, R, RA, R), Ac (RA, n, n, RA), rhs/x0 "
                         "(B, R, n, R), mask (R, n, R)")
    out, cg_matfree_fused_batched.route = _launch(
        L, Ac, Renv, rhs, mask, x0, iters, batched=True)
    cg_matfree_fused_batched.launches += 1
    return out


cg_matfree_fused.route = None
cg_matfree_fused_batched.route = None
