"""Kernel B7: the whole forward + backward batched ALS pass in one launch.

One operator stack ``A (d, RA, n, n, RA)``, a batch of right-hand sides and
states ``b, x (B, d, R, n, R)`` with ``Rb == R``, one shared rank profile
``masks (d+1, R)``. Per problem: the right-env chain of the input, the
forward half-sweep (rhs from the carried left envs, warm start from the
transported iterate, the MPO folded into the right env, warm matrix-free
CG, two-pass Newton–Schulz polar orthogonalization of the columns, carried
left envs), the backward mirror (rows orthogonalized, carried right envs)
and the final site-0 core. The gauge is ``T = G^{1/2}`` (NS polar), not
QR; represented vectors match ``als_sweeps_b(..., sweep_count=2)``.

:func:`als_fwd_bwd_fused_batched` runs the pass through a Hopper kernel
for CUDA tensors and through :func:`als_fwd_bwd_plain` for CPU tensors.
The kernel is chosen by dtype, shape and ``cg_refine`` alone, never on a
failure (:func:`sweep_route`); the route of the last launch is kept in the
wrapper's ``route`` attribute:

* ``"site"`` — ``csrc/als_sweep_site.cu``: float32 at ``(R, n, RA)`` in
  :data:`SITE_SHAPES` with ``cg_refine == 0``; the site's operators stay in
  shared memory for its whole CG, every product a register-tiled GEMM
  from shared memory.
* ``"folded"`` — ``csrc/als_sweep_fused.cu`` (the MPO folded into the
  right env, products through L2): float64, other shapes, and the bf16
  refine stage, whose rounding points follow the TPU's folded form.

The plain version follows the TPU kernel body step by step in batched
torch ops: no per-apply masking in the CG (the envs come from masked
cores), the result re-masked once.
``cg_refine`` CG iterations after the main loop take bf16-rounded operands
with accumulation in the working type, then ``cg_polish`` full-precision
ones, each stage restarted from the true residual.
"""

from __future__ import annotations

import torch

from ttnx_torch.kernels import _build
from ttnx_torch.kernels.dispatch import counted, require_real, use_kernel

__all__ = ["als_fwd_bwd_fused_batched", "als_fwd_bwd_plain", "sweep_route",
           "SITE_SHAPES"]

# (R, n, RA) the site-resident kernel is instantiated for: the bench's
# rank-64 heat problem and the rank-32 check shape
SITE_SHAPES = ((64, 2, 4), (32, 2, 4))


def sweep_route(dtype, R: int, n: int, RA: int, cg_refine: int) -> str:
    """The kernel of :func:`als_fwd_bwd_fused_batched`: ``"site"`` for
    float32 at an instantiated shape without a refine stage, else
    ``"folded"``."""
    if (dtype == torch.float32 and (R, n, RA) in SITE_SHAPES
            and cg_refine == 0):
        return "site"
    return "folded"


def _bf16(t):
    """``t`` rounded to bf16, kept in its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _ns_polar(G, eye, iters: int):
    """Coupled Newton–Schulz: ``(G^{1/2}, G^{-1/2})`` for a batch of SPD
    ``G (B, R, R)``, scaled by each problem's Frobenius norm."""
    fr = torch.sqrt((G * G).sum((-2, -1), keepdim=True))
    sq = torch.sqrt(fr)
    Y = G * (1.0 / fr)
    Z = eye.expand_as(G)
    for _ in range(iters):
        T = 1.5 * eye - 0.5 * (Z @ Y)
        Y, Z = Y @ T, T @ Z
    return Y * sq, Z * (1.0 / sq)


def _orth_cols(V, dpad, m2, eye, it1: int, it2: int):
    """Forward gauge: ``V (B, R, n, R) = Q T`` over the merged (R n, R)
    matrices, ``Q`` with masked orthonormal columns, two NS passes."""
    B, R, n, _ = V.shape
    Q, Gh = V, []
    for iters in (it1, it2):
        M = Q.reshape(B, R * n, R)
        Gh_k, Gi = _ns_polar(M.transpose(1, 2) @ M + dpad, eye, iters)
        Q = (M @ Gi).reshape(B, R, n, R) * m2
        Gh.append(Gh_k)
    return Q, Gh[1] @ Gh[0]


def _orth_rows(V, dpad, m2, eye, it1: int, it2: int):
    """Backward gauge: ``V (B, R, n, R) = T Q`` over the merged (R, n R)
    matrices, ``Q`` with masked orthonormal rows."""
    B, R, n, _ = V.shape
    Q, Gh = V, []
    for iters in (it1, it2):
        M = Q.reshape(B, R, n * R)
        Gh_k, Gi = _ns_polar(M @ M.transpose(1, 2) + dpad, eye, iters)
        Q = (Gi @ M).reshape(B, R, n, R) * m2
        Gh.append(Gh_k)
    return Q, Gh[0] @ Gh[1]


def _right_update(xk, Ak, bk, G, Gb):
    """Right env of one more site: ``G (B, RA, R, R)`` with ``G[:, W] =
    Renv[:, W, :]``, ``Gb (B, R, R)``."""
    s = torch.einsum("Bbjq,Bwpq->Bjwbp", xk, G)
    m = torch.einsum("Wijw,Bjwbp->BWibp", Ak, s)
    G_new = torch.einsum("Baip,BWibp->BWab", xk, m)
    sb = torch.einsum("Buiv,Bpv->Buip", bk, Gb)
    return G_new, torch.einsum("Baip,Buip->Bau", xk, sb)


def _left_update(Q, Ak, L, t1):
    """Left env of one more site from the new core ``Q``; ``t1 = Lb b``."""
    t = torch.einsum("Baic,BWab->BiWcb", Q, L)
    mm = torch.einsum("Wijw,BiWcb->Bwjcb", Ak, t)
    L_new = torch.einsum("Bwjcb,Bbjd->Bwcd", mm, Q)
    return L_new, torch.einsum("Baic,Baiv->Bcv", Q, t1)


def _cg_site(L, RAcat, rhs, m2, x0, iters: int, refine: int, polish: int):
    """Warm matrix-free CG on one site's systems with the folded operands
    ``RAcat (B, n, n, RA, R, R)`` and left envs ``L (B, RA, R, R)``; no
    per-apply mask, the result re-masked once."""

    def apply32(p):
        u = torch.einsum("BiJWcd,BbJd->BiWcb", RAcat, p)
        return torch.einsum("BWab,BiWcb->Baic", L, u)

    def apply16(p):
        u = _bf16(torch.einsum("BiJWcd,BbJd->BiWcb", _bf16(RAcat),
                               _bf16(p)))
        return torch.einsum("BWab,BiWcb->Baic", _bf16(L), u)

    def pdot(a, b):
        return (a * b).sum((1, 2, 3), keepdim=True)

    def run(apply_k, x, count):
        r = rhs - apply32(x)
        p, rs = r, pdot(r, r)
        for _ in range(count):
            ap = apply_k(p)
            denom = pdot(p, ap)
            ok = denom.abs() > 0
            alpha = torch.where(ok, rs / torch.where(ok, denom, 1.0), 0.0)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = pdot(r, r)
            okb = rs.abs() > 0
            beta = torch.where(okb, rs_new / torch.where(okb, rs, 1.0), 0.0)
            p = r + beta * p
            rs = rs_new
        return x

    x = run(apply32, x0 * m2, iters)
    if refine > 0:
        x = run(apply16, x, refine)
    if polish > 0:
        x = run(apply32, x, polish)
    return x * m2


def als_fwd_bwd_plain(A_stack, b_batch, x_batch, masks, *,
                      cg_iters: int = 24, cg_refine: int = 0,
                      cg_polish: int = 0, ns_iters=(24, 8)):
    """Plain PyTorch version of :func:`als_fwd_bwd_fused_batched`."""
    B, d, R, n, _ = x_batch.shape
    RA = A_stack.shape[1]
    dt, dev = x_batch.dtype, x_batch.device
    ns1, ns2 = ns_iters
    eye = torch.eye(R, dtype=dt, device=dev)
    masks = masks.to(dt)

    def m2(k):  # (R, 1, R): broadcasts over (B, R, n, R)
        return (masks[k][:, None] * masks[k + 1][None, :])[:, None, :]

    def dpad(k):
        return torch.diag(1.0 - masks[k])

    def fold(Ak, G):  # RAcat[:, i, J, W] = sum_w A[W,i,J,w] G[:, w]
        return torch.einsum("WiJw,Bwcd->BiJWcd", Ak, G)

    def e0(*shape):
        e = torch.zeros((B,) + shape, dtype=dt, device=dev)
        e.view(B, -1)[:, 0] = 1.0
        return e

    # right-env chain of the input, column-masked (envs[0] is never used)
    Renvs, Rbs = [None] * (d + 1), [None] * (d + 1)
    Renvs[d], Rbs[d] = e0(RA, R, R), e0(R, R)
    for k in range(d - 1, 0, -1):
        xk = x_batch[:, k] * masks[k + 1]
        Renvs[k], Rbs[k] = _right_update(xk, A_stack[k], b_batch[:, k],
                                         Renvs[k + 1], Rbs[k + 1])

    # forward half-sweep: sites 0..d-2, left envs carried
    L, Lb = e0(RA, R, R), e0(R, R)
    Lenvs, Lbs, fwd_Q = [L], [Lb], []
    T = None
    for k in range(d - 1):
        t1 = torch.einsum("Bau,Buiv->Baiv", Lb, b_batch[:, k])
        rhs = torch.einsum("Baiv,Bcv->Baic", t1, Rbs[k + 1]) * m2(k)
        warm = (x_batch[:, k] if T is None
                else torch.einsum("Bab,Bbic->Baic", T, x_batch[:, k]))
        V = _cg_site(L, fold(A_stack[k], Renvs[k + 1]), rhs, m2(k), warm,
                     cg_iters, cg_refine, cg_polish)
        Q, T = _orth_cols(V, dpad(k + 1), m2(k), eye, ns1, ns2)
        fwd_Q.append(Q)
        L, Lb = _left_update(Q, A_stack[k], L, t1)
        Lenvs.append(L)
        Lbs.append(Lb)

    # backward half-sweep: sites d-1..1, right envs carried
    Renv, Rb = Renvs[d], Rbs[d]
    out = [None] * d
    for k in range(d - 1, 0, -1):
        t1 = torch.einsum("Bau,Buiv->Baiv", Lbs[k], b_batch[:, k])
        rhs = torch.einsum("Baiv,Bcv->Baic", t1, Rb) * m2(k)
        if k == d - 1:  # the current core at d-1 is T_fwd @ x_in[d-1]
            warm = torch.einsum("Bab,Bbic->Baic", T, x_batch[:, k])
        else:
            warm = torch.einsum("Baib,Bbc->Baic", fwd_Q[k], T)
        V = _cg_site(Lenvs[k], fold(A_stack[k], Renv), rhs, m2(k), warm,
                     cg_iters, cg_refine, cg_polish)
        Q, T = _orth_rows(V, dpad(k), m2(k), eye, ns1, ns2)
        Renv, Rb = _right_update(Q, A_stack[k], b_batch[:, k], Renv, Rb)
        out[k] = Q
    out[0] = torch.einsum("Baib,Bbc->Baic", fwd_Q[0], T) * m2(0)
    return torch.stack(out, dim=1)


@counted
def als_fwd_bwd_fused_batched(A_stack, b_batch, x_batch, masks, *,
                              cg_iters: int = 24, cg_refine: int = 0,
                              cg_polish: int = 0, ns_iters=(24, 8)):
    """One full forward + backward ALS pass over a batch: ``A_stack (d, RA,
    n, n, RA)`` shared, ``b_batch/x_batch (B, d, R, n, R)`` with ``Rb ==
    R``, ``masks (d+1, R)`` shared. Returns the solved ``(B, d, R, n, R)``
    stack."""
    if b_batch.shape[2] != x_batch.shape[2]:
        raise ValueError("fused half-sweep requires Rb == R")
    args = (A_stack, b_batch, x_batch, masks)
    kw = dict(cg_iters=cg_iters, cg_refine=cg_refine, cg_polish=cg_polish,
              ns_iters=ns_iters)
    if not use_kernel(*args):
        return als_fwd_bwd_plain(*args, **kw)
    require_real("als_fwd_bwd_fused_batched", *args)
    B, d, R, n, _ = x_batch.shape
    RA = A_stack.shape[1]
    if (b_batch.shape != x_batch.shape or A_stack.shape != (d, RA, n, n, RA)
            or masks.shape != (d + 1, R) or d < 2):
        raise ValueError(f"als_fwd_bwd_fused_batched: shapes A"
                         f"{tuple(A_stack.shape)} b{tuple(b_batch.shape)} x"
                         f"{tuple(x_batch.shape)} masks{tuple(masks.shape)}"
                         f" are not (d,RA,n,n,RA), (B,d,R,n,R) twice, "
                         f"(d+1,R) with d >= 2")
    A_stack, b_batch = A_stack.contiguous(), b_batch.contiguous()
    x_batch, masks = x_batch.contiguous(), masks.contiguous()
    out = torch.empty_like(x_batch)
    route = sweep_route(x_batch.dtype, R, n, RA, cg_refine)
    entry = "als_sweep_site" if route == "site" else "als_sweep_pair"
    per_problem = _build.query(f"{entry}_scratch", d, R, RA, n)
    scratch = torch.empty(B * per_problem, dtype=x_batch.dtype,
                          device=x_batch.device)
    ns1, ns2 = ns_iters
    _build.call(entry, x_batch.dtype, A_stack.data_ptr(),
                b_batch.data_ptr(), x_batch.data_ptr(), masks.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), B, d, R, RA, n,
                int(cg_iters), int(cg_refine), int(cg_polish), int(ns1),
                int(ns2))
    als_fwd_bwd_fused_batched.launches += 1
    als_fwd_bwd_fused_batched.route = route
    return out


als_fwd_bwd_fused_batched.route = None
