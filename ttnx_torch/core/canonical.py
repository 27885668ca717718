"""Canonical forms: orthogonalization, entropy, SVD truncation, compression.

All functional (return new ``TTVector``s). QR/LQ sweeps are one reshape and
one ``torch.linalg.qr`` per site. Rank choices from singular values happen
on the host (eager setup code, not the step).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ttnx_torch.core.linalg import thin_svd
from ttnx_torch.core.tt import TTOperator, TTVector

__all__ = [
    "orthogonalize",
    "entanglement_entropy",
    "svdtrunc",
    "tt_compress",
    "tt_round",
    "round_op",
]


def _left_orth_step(core, nxt):
    """Left-orthogonalize ``core``; absorb the triangular factor into ``nxt``."""
    rl, n, rr = core.shape
    q, r = torch.linalg.qr(core.reshape(rl * n, rr))
    return q.reshape(rl, n, -1), torch.einsum("ab,bnc->anc", r, nxt)


def _right_orth_step(prev, core):
    """Right-orthogonalize ``core``; absorb the triangular factor into ``prev``."""
    rl, n, rr = core.shape
    qt, rt = torch.linalg.qr(core.reshape(rl, n * rr).T)
    return (torch.einsum("anb,bc->anc", prev, rt.T),
            qt.T.reshape(-1, n, rr))


def orthogonalize(x: TTVector, i: int = 0) -> TTVector:
    """Mixed-canonical form with the center at site ``i``: sites ``< i``
    left-orthogonal (ot=+1), sites ``> i`` right-orthogonal (ot=-1)."""
    d = x.N
    if not 0 <= i < d:
        raise ValueError("orthogonalization center out of range")
    cores = list(x.cores)
    for j in range(i):
        cores[j], cores[j + 1] = _left_orth_step(cores[j], cores[j + 1])
    for j in range(d - 1, i, -1):
        cores[j - 1], cores[j] = _right_orth_step(cores[j - 1], cores[j])
    ot = [1] * i + [0] + [-1] * (d - 1 - i)
    return TTVector(cores, ot)


def entanglement_entropy(psi: TTVector, base: float = math.e) -> np.ndarray:
    """Von Neumann entanglement entropy at every bond; entry ``k`` is the
    entropy of the bipartition ``0:k+1 | k+1:N``. Host numpy vector."""
    if base <= 0 or base == 1:
        raise ValueError("base must be positive and not equal to 1")
    n_sites = psi.N
    out = np.zeros(max(n_sites - 1, 0))
    if n_sites <= 1:
        return out
    logscale = math.log(base)
    cores = list(orthogonalize(psi, 0).cores)
    for k in range(n_sites - 1):
        rl, n, rr = cores[k].shape
        u, s, vt = thin_svd(cores[k].reshape(rl * n, rr))
        p = (s.abs() ** 2).cpu().numpy()
        tot = p.sum()
        if tot > 0:
            p = p / tot
            nz = p[p > 0]
            out[k] = float(-(nz * np.log(nz)).sum() / logscale)
        if k < n_sites - 2:
            transfer = s[:, None].to(vt.dtype) * vt
            cores[k + 1] = torch.einsum("ab,bnc->anc", transfer, cores[k + 1])
    return out


entanglemententropy = entanglement_entropy


def svdtrunc(a, max_bond: int | None = None, truncerr: float = 0.0):
    """Truncated SVD keeping ``min(max_bond, #{s_i >= truncerr})`` singular
    values (at least one). Returns ``(U, s, Vt)`` with ``s`` a vector."""
    u, s, vt = thin_svd(a)
    s_host = s.cpu().numpy()
    keep = int(np.sum(s_host >= truncerr)) if truncerr > 0 else s_host.size
    if max_bond is not None:
        keep = min(keep, max_bond)
    keep = max(keep, 1)
    return u[:, :keep], s[:keep], vt[:keep, :]


def _bond_truncate(cores, k, max_bond, truncerr):
    """Two-site merge -> truncated SVD -> sqrt-balanced split at bond k."""
    a, b = cores[k], cores[k + 1]
    rl, n1, _ = a.shape
    _, n2, rr = b.shape
    merged = torch.einsum("anb,bmc->anmc", a, b).reshape(rl * n1, n2 * rr)
    u, s, vt = svdtrunc(merged, max_bond=max_bond, truncerr=truncerr)
    sq = torch.sqrt(s).to(u.dtype)
    cores[k] = (u * sq[None, :]).reshape(rl, n1, -1)
    cores[k + 1] = (sq[:, None] * vt).reshape(-1, n2, rr)


def tt_compress(x: TTVector, max_bond: int, truncerr: float = 0.0,
                sweeps: int = 1) -> TTVector:
    """Sweeping two-site SVD compression."""
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    cores = list(x.cores)
    d = len(cores)
    for _ in range(sweeps):
        for k in range(d - 1):
            _bond_truncate(cores, k, max_bond, truncerr)
        for k in range(d - 2, -1, -1):
            _bond_truncate(cores, k, max_bond, truncerr)
    return TTVector(cores)


def tt_round(x: TTVector, max_bond: int | None = None,
             rel_tol: float = 0.0) -> TTVector:
    """TT rounding (Oseledets): right-orthogonalize, then one left-to-right
    truncated-SVD sweep with relative discarded-weight tolerance."""
    d = x.N
    if d == 1:
        return x.copy()
    cores = list(orthogonalize(x, 0).cores)
    for k in range(d - 1):
        rl, n, rr = cores[k].shape
        u, s, vt = thin_svd(cores[k].reshape(rl * n, rr))
        s_host = s.cpu().numpy()
        keep = s_host.size
        if rel_tol > 0:
            nrm2 = float((s_host ** 2).sum())
            tail = np.cumsum(s_host[::-1] ** 2)[::-1]
            ok = tail > (rel_tol ** 2) * nrm2
            keep = int(ok.sum()) if ok.any() else 1
        if max_bond is not None:
            keep = min(keep, max_bond)
        keep = max(keep, 1)
        cores[k] = u[:, :keep].reshape(rl, n, keep)
        transfer = s[:keep, None].to(vt.dtype) * vt[:keep, :]
        cores[k + 1] = torch.einsum("ab,bnc->anc", transfer, cores[k + 1])
    ot = [1] * (d - 1) + [0]
    return TTVector(cores, ot)


def round_op(A: TTOperator) -> TTOperator:
    """``A`` at its exact TT ranks: :func:`tt_round` of the cores read as a
    TT of physical size ``n_out * n_in``, dropping at each bond only the
    directions whose discarded weight is under 1e-13 of the bond's total,
    so the result represents ``A`` to about 1e-13. Round in float64, then
    cast."""
    x = tt_round(TTVector([c.reshape(c.shape[0], -1, c.shape[-1])
                           for c in A.cores]), rel_tol=1e-13)
    return TTOperator([c.reshape(c.shape[0], *a.shape[1:3], c.shape[-1])
                       for c, a in zip(x.cores, A.cores)])
