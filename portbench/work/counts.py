"""Frozen copy of the port's FLOP arithmetic (``ttnx_torch/utils/flops.py``
as of the benchmark's first version): executed padded-shape contraction
FLOPs, each einsum costed along numpy's optimal pairwise path at
``2 * prod(dims)`` a pairwise contraction; eigh, QR and masking left out,
which only understates the work."""

from __future__ import annotations

import numpy as np

__all__ = ["einsum_flops", "als_sweeps_flops", "gram_chain_flops",
           "round_gram_flops", "cn_step_flops"]


def einsum_flops(expr: str, *shapes) -> float:
    """FLOPs of ``np.einsum(expr, ...)`` along the optimal pairwise path."""
    arrs = [np.lib.stride_tricks.as_strided(np.zeros(1), s, (0,) * len(s))
            for s in shapes]
    path, _ = np.einsum_path(expr, *arrs, optimize=("optimal", 1e30))
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
    """One ALS call with matrix-free CG: ``cg_iters`` operator applies a
    local solve."""
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
    return (d - 1) * n * 2 * (2.0 * RB ** 3)


def round_gram_flops(d: int, RB: int, R_out: int, n: int = 2) -> float:
    absorb = einsum_flops("ab,bnc->anc", (R_out, RB), (RB, n, RB))
    B_asm = einsum_flops("ab,bc,xc->ax",
                         (R_out * n, RB), (RB, RB), (R_out * n, RB))
    T_new = 2.0 * R_out * (R_out * n) * RB
    return (gram_chain_flops(d, RB, n)
            + (d - 1) * (absorb + B_asm + T_new) + absorb)


def cn_step_flops(d: int, R: int, RA_lhs: int, RA_rhs: int, n: int = 2,
                  sweep_count: int = 2, cg_iters: int = 32) -> float:
    """Padded MPO apply + Gram-chain rounding + ALS half-sweeps."""
    RB = RA_rhs * R
    matvec = einsum_flops("kaijb,kcjd->kacibd",
                          (d, RA_rhs, n, n, RA_rhs), (d, R, n, R))
    return (matvec + round_gram_flops(d, RB, R, n)
            + als_sweeps_flops(d, R, RA_lhs, R, n, sweep_count, cg_iters))
