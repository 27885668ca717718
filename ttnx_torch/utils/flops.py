"""Analytic FLOP accounting for the CN step, the batched ALS, the DMRG
eigensweep and the core contraction chains.

Counts the executed (padded-shape) contraction FLOPs, the numerator for
achieved-rate reporting. Each einsum is costed along numpy's optimal
pairwise path with ``2 * prod(dims)`` per pairwise contraction; dense
factorizations (eigh, QR) and elementwise masking are excluded, which only
understates the rate.
"""

from __future__ import annotations

import numpy as np

__all__ = ["einsum_flops", "als_sweeps_flops", "cn_step_flops",
           "gram_chain_flops", "round_gram_flops", "dmrg_eig_sweep_flops",
           "cn_step_bicgstab_flops", "contraction_chain_flops",
           "matmul_chain_flops"]


def einsum_flops(expr: str, *shapes) -> float:
    """FLOPs of ``np.einsum(expr, ...)`` along the optimal pairwise path."""
    arrs = [np.lib.stride_tricks.as_strided(np.zeros(1), s, (0,) * len(s))
            for s in shapes]
    path, _ = np.einsum_path(expr, *arrs, optimize=("optimal", 1e30))
    assert path[0] == "einsum_path"
    inputs, _ = expr.replace(" ", "").split("->")
    terms = inputs.split(",")
    dims: dict[str, int] = {}
    for t, s in zip(terms, shapes):
        for c, d in zip(t, s):
            dims[c] = d
    total = 0.0
    for contraction in path[1:]:
        picked = [terms[i] for i in contraction]
        for i in sorted(contraction, reverse=True):
            terms.pop(i)
        union = set("".join(picked))
        total += 2.0 * float(np.prod([dims[c] for c in union]))
        keep = union & (set("".join(terms)) | set(expr.split("->")[1]))
        terms.append("".join(sorted(keep)))
    return total


def als_sweeps_flops(d: int, R: int, RA: int, Rb: int, n: int = 2,
                     sweep_count: int = 2, cg_iters: int = 32) -> float:
    """Contraction FLOPs of one ``als_sweeps`` call with matrix-free CG."""
    env_A = einsum_flops("aip,Wijw,bjq,pwq->aWb",
                         (R, n, R), (RA, n, n, RA), (R, n, R), (R, RA, R))
    env_b = einsum_flops("aip,uiv,pv->au", (R, n, R), (Rb, n, Rb), (R, Rb))
    rhs = einsum_flops("au,uiv,cv->aic", (R, Rb), (Rb, n, Rb), (R, Rb))
    apply_k = einsum_flops("aWb,WiJw,cwd,bJd->aic",
                           (R, RA, R), (RA, n, n, RA), (R, RA, R), (R, n, R))
    absorb = einsum_flops("ab,bnc->anc", (R, R), (R, n, R))
    env_build = d * (env_A + env_b)
    half = (d - 1) * (rhs + cg_iters * apply_k + env_A + env_b) + absorb
    return sweep_count * (env_build + half)


def gram_chain_flops(d: int, RB: int, n: int = 2) -> float:
    """Backward right-Gram sweep of a ``(d, RB, n, RB)`` chain: per site,
    ``n`` pairs of ``(RB, RB) @ (RB, RB)`` products."""
    return (d - 1) * n * 2 * (2.0 * RB ** 3)


def round_gram_flops(d: int, RB: int, R_out: int, n: int = 2) -> float:
    """Contraction FLOPs of ``tt_round_gram`` (eigh excluded)."""
    absorb = einsum_flops("ab,bnc->anc", (R_out, RB), (RB, n, RB))
    B_asm = einsum_flops("ab,bc,xc->ax",
                         (R_out * n, RB), (RB, RB), (R_out * n, RB))
    T_new = 2.0 * R_out * (R_out * n) * RB
    return (gram_chain_flops(d, RB, n)
            + (d - 1) * (absorb + B_asm + T_new) + absorb)


def cn_step_flops(d: int, R: int, RA_lhs: int, RA_rhs: int, n: int = 2,
                  sweep_count: int = 2, cg_iters: int = 32) -> float:
    """Contraction FLOPs of one CN step (gram_chain rounding, matrix-free
    CG ALS): padded MPO apply + rounding + ``sweep_count`` half-sweeps."""
    RB = RA_rhs * R
    matvec = einsum_flops("kaijb,kcjd->kacibd",
                          (d, RA_rhs, n, n, RA_rhs), (d, R, n, R))
    return (matvec + round_gram_flops(d, RB, R, n)
            + als_sweeps_flops(d, R, RA_lhs, R, n, sweep_count, cg_iters))


def cn_step_bicgstab_flops(d: int, R: int, RA_lhs: int, RA_rhs: int,
                           n: int = 2, sweep_count: int = 2,
                           bicg_iters: int = 32) -> float:
    """Contraction FLOPs of one CN step with ``solver='bicgstab_fused'``
    (gram_chain rounding): as :func:`cn_step_flops`, with every local solve
    an assembly of the dense K (``M = R n R``) and ``bicg_iters`` BiCGStab
    iterations of two ``(M, M)`` matvecs in place of the matrix-free CG."""
    RB, M = RA_rhs * R, R * n * R
    matvec = einsum_flops("kaijb,kcjd->kacibd",
                          (d, RA_rhs, n, n, RA_rhs), (d, R, n, R))
    assemble = (einsum_flops("aWb,WiJw->aibJw", (R, RA_lhs, R),
                             (RA_lhs, n, n, RA_lhs))
                + einsum_flops("aibJw,cwd->aicbJd", (R, n, R, n, RA_lhs),
                               (R, RA_lhs, R)))
    solves = sweep_count * (d - 1) * (assemble + bicg_iters * 4.0 * M * M)
    return (matvec + round_gram_flops(d, RB, R, n) + solves
            + als_sweeps_flops(d, R, RA_lhs, R, n, sweep_count, cg_iters=0))


def dmrg_eig_sweep_flops(d: int, R: int, RA: int, n: int = 2,
                         lanczos_iters: int = 8) -> float:
    """Contraction FLOPs of one ``dmrg_eig_sweep`` with matrix-free
    Lanczos: the two operator env chains (B8), ``lanczos_iters`` two-site
    applies at each of the ``2 (d-1)`` sites and an env update after each.
    Splits (SVD/eigh), the Krylov reorthogonalization and the dense-K
    assembly of ``'lanczos_fused'`` are excluded: a utilization view."""
    env = einsum_flops("aip,Wijw,bjq,pwq->aWb",
                       (R, n, R), (RA, n, n, RA), (R, n, R), (R, RA, R))
    apply2 = einsum_flops("aWb,WiIw,wjJv,cvd,bIJd->aijc",
                          (R, RA, R), (RA, n, n, RA), (RA, n, n, RA),
                          (R, RA, R), (R, n, n, R))
    return 2 * d * env + 2 * (d - 1) * (lanczos_iters * apply2 + env)


def contraction_chain_flops(batch: int, r: int, n: int, iters: int) -> float:
    """``merge_resplit_chain`` (``bench_pallas_chain``): a merge ``(r n, r)
    @ (r, n r)`` and a re-split ``(r n, n r) @ (n r, r)`` a round."""
    return 2 * (2.0 * batch * (r * n) * r * (n * r)) * iters


def matmul_chain_flops(batch: int, m: int, k: int, iters: int) -> float:
    """``matmul_chain`` (``bench_pallas_matmul_ceiling``): one ``(m, k) @
    (k, k)`` product a round."""
    return 2.0 * batch * m * k * k * iters
