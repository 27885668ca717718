"""Distributed TT rounding: the padded-rank rounding of
:mod:`ttnx_torch.solvers.round_scan` with every site unfolding
column-sharded over a ``tp`` mesh axis.

The O(R^2 n R) Gram accumulations and basis applications — the FLOPs of
rounding — run sharded over ``tp``, with one reduce-scatter and one
``psum`` a site, while the small eigendecompositions run replicated.

Sharding layout (per site, ``R`` = padded input rank, ``p`` = tp size):

    right-orth sweep  cm = (R, n*R)     columns sharded -> Gram psum (R, R)
    truncation sweep  cm = (R_out*n, R) columns sharded -> Gram psum (tiny)
                       t_k all-gathered (k x R) to carry the sweep

SPMD form of ``ttnx.parallel.round_dist``: every rank of the axis calls
with its column block ``y_loc (d, R, n, R/p)`` of the padded chain
(:func:`shard_chain` cuts it), masks and ``R_out`` whole; the rounded
``(d, R_out, n, R_out)`` chain comes back whole on every rank. The
collectives are :mod:`ttnx_torch.parallel.comm`'s.
"""

from __future__ import annotations

import torch

from ttnx_torch.parallel.comm import (all_gather, axis_index, axis_size,
                                      local_block, psum, psum_scatter)
from ttnx_torch.solvers.round_scan import _gram_sqrt

__all__ = ["gram_round_dist", "gram_chain_round_dist",
           "gram_chain_round_dist_pair", "shard_chain",
           "make_cn_step_dist", "tp_rounding_worthwhile"]


def _e00(rows, cols, like):
    out = torch.zeros((rows, cols), dtype=like.dtype, device=like.device)
    out[0, 0] = 1.0
    return out


def _check_split(y_loc, mesh, axis):
    """``R`` (the full left rank axis) must divide over the axis, and the
    block must hold ``R / p`` columns."""
    R, R_loc = y_loc.shape[-3], y_loc.shape[-1]
    p = axis_size(mesh, axis)
    if R % p != 0:
        raise ValueError(f"padded rank {R} not divisible by {axis}={p}")
    if R_loc * p != R:
        raise ValueError(f"a block of {R_loc} columns is not 1/{p} of the "
                         f"padded rank {R}")


def _gram_sqrt_apply(cm_loc, mesh, axis):
    """Local columns of ``cm``: ``(q_loc, T)`` with ``cm = T q`` (T =
    (cm cm^H)^{1/2}, replicated; q column-sharded, orthonormal rows on the
    row space). One psum of the Gram matrix over ``axis``."""
    R = cm_loc.shape[0]
    return _gram_sqrt(psum(cm_loc @ cm_loc.conj().T, mesh, axis), cm_loc, R)


def _last_site(T2, y_last_loc, R_out, mesh, axis):
    """The last site absorbs the transfer; the global boundary column 0
    lives in axis rank 0's block."""
    c_loc = torch.einsum("ob,bnc->onc", T2, y_last_loc)
    on_first = 1.0 if axis_index(mesh, axis) == 0 else 0.0
    last_col = psum(c_loc[:, :, 0:1] * on_first, mesh, axis)
    return torch.nn.functional.pad(last_col, (0, R_out - 1))


def _round_kernel(y_loc, masks_y, masks_out, *, R_out: int, mesh, axis):
    """The sharded gram rounding: right-orthogonalize, then truncate."""
    d, R, n, R_loc = y_loc.shape
    idx = axis_index(mesh, axis)
    rows = slice(idx * R_loc, (idx + 1) * R_loc)

    # ---- right-orthogonalization sweep (sites d-1 .. 1) -----------------
    cores_loc = [None] * d
    T = _e00(R, R, y_loc)
    for i in range(d - 1, 0, -1):
        # c[a,n,c'] = sum_b core[a,n,b] T[b,c']: b is this site's sharded
        # column axis -> local partial, then the reduce-scatter re-shards
        # the fresh c' columns in the same collective
        c_part = torch.einsum("anb,bc->anc", y_loc[i], T[rows])
        c_loc = psum_scatter(c_part, mesh, axis, dim=2)   # (R, n, R/p)
        m_l = masks_y[i]
        q_loc, T = _gram_sqrt_apply(c_loc.reshape(R, n * R_loc), mesh, axis)
        cores_loc[i] = q_loc.reshape(R, n, R_loc) * m_l[:, None, None]
        T = T * m_l[None, :]
    c_part = torch.einsum("anb,bc->anc", y_loc[0], T[rows])
    cores_loc[0] = psum_scatter(c_part, mesh, axis, dim=2)

    # ---- truncation sweep (sites 0 .. d-2) -------------------------------
    out = [None] * d
    k = min(R_out, R)
    T2 = _e00(R_out, R, y_loc)
    for i in range(d - 1):
        # c = T2 @ core over the full left rank axis: local, and the result
        # keeps the core's sharded right axis
        cm_loc = torch.einsum("ob,bnc->onc", T2, cores_loc[i]).reshape(
            R_out * n, R_loc)
        m_r = masks_out[i + 1]
        G = psum(cm_loc @ cm_loc.conj().T, mesh, axis)    # tiny
        w, V = torch.linalg.eigh(G)
        u_k = torch.flip(V, (1,))[:, :k] * m_r[None, :k].to(V.dtype)
        t_loc = u_k.conj().T @ cm_loc                     # (k, R/p)
        pad = torch.zeros((R_out * n, R_out - k), dtype=cm_loc.dtype,
                          device=cm_loc.device)
        out[i] = torch.cat([u_k, pad], dim=1).reshape(R_out, n, R_out)
        # carry: the next site's left axis is whole, so T2 is replicated
        t_full = all_gather(t_loc, mesh, axis, dim=1)
        t_full = t_full * m_r[:k, None].to(t_full.dtype)
        T2 = torch.cat([t_full, torch.zeros((R_out - k, R),
                                            dtype=t_full.dtype,
                                            device=t_full.device)], dim=0)
    out[d - 1] = _last_site(T2, cores_loc[d - 1], R_out, mesh, axis)
    return torch.stack(out)


def _gram_chain_kernel_dist(y_loc, masks_out, *, R_out: int, mesh, axis):
    """The sharded GRAM-CHAIN rounding of one chain: every factorization is
    a small ``(R_out n)^2`` eigh and the O(R^3) work is matmuls sharded
    1/p. Collectives a site: backward sweep, one reduce-scatter (re-shard
    the ``Y_i G`` partial products onto this rank's columns) and one
    ``psum`` of the (R, R) Gram; forward sweep, one ``psum`` of the
    (R_out n, R) half-product, one small ``psum`` of B and one all-gather
    of the (R_out, R) transfer. It is :func:`_gram_chain_kernel_dist_pipe`
    on a pair of one."""
    return _gram_chain_kernel_dist_pipe(y_loc[None], masks_out, R_out=R_out,
                                        mesh=mesh, axis=axis)[0]


def _gram_chain_kernel_dist_pipe(y2_loc, masks_out, *, R_out: int, mesh,
                                 axis):
    """The Gram-chain rounding of several chains ``y2_loc (P, d, R, n,
    R/p)`` with their site loops interleaved: in program order each
    collective of one chain is followed by the next chain's independent
    partial products, the structure that lets collectives of one chain
    overlap the other's compute (the recurrence within a chain is strictly
    sequential). Each chain's arithmetic is exactly the one-chain kernel's."""
    P2, d, R, n, R_loc = y2_loc.shape
    idx = axis_index(mesh, axis)
    rows = slice(idx * R_loc, (idx + 1) * R_loc)

    # ---- backward Gram sweeps, interleaved: Gs[q][k] = G_{k+1} ----------
    G = [_e00(R, R, y2_loc) for _ in range(P2)]
    Gs = [[None] * d for _ in range(P2)]
    for q in range(P2):
        Gs[q][d - 1] = G[q]
    for k in range(d - 1, 0, -1):
        t_loc = [None] * P2
        for q in range(P2):
            # partial over this rank's b block: t = Y_k G, then re-shard
            # the b' columns so the second contraction is local
            t_part = torch.einsum("anb,bc->anc", y2_loc[q, k], G[q][rows])
            t_loc[q] = psum_scatter(t_part, mesh, axis, dim=2)
        for q in range(P2):
            G_part = torch.einsum("anc,bnc->ab", t_loc[q],
                                  y2_loc[q, k].conj())
            G[q] = psum(G_part, mesh, axis)                 # (R, R)
            Gs[q][k - 1] = G[q]

    # ---- forward truncation sweeps, interleaved --------------------------
    out = [[None] * d for _ in range(P2)]
    T2 = [_e00(R_out, R, y2_loc) for _ in range(P2)]
    for k in range(d - 1):
        cm_loc = [None] * P2
        t_half = [None] * P2
        for q in range(P2):
            cm_loc[q] = torch.einsum("ob,bnc->onc", T2[q],
                                     y2_loc[q, k]).reshape(R_out * n, R_loc)
            t_half[q] = psum(cm_loc[q] @ Gs[q][k][rows], mesh, axis)
        m_r = masks_out[k + 1]
        for q in range(P2):
            B = psum(t_half[q][:, rows] @ cm_loc[q].conj().T, mesh, axis)
            B = 0.5 * (B + B.conj().T)
            w, V = torch.linalg.eigh(B)
            u_k = torch.flip(V, (1,))[:, :R_out] * m_r[None, :R_out].to(
                V.dtype)
            out[q][k] = u_k.reshape(R_out, n, R_out)
            t2_loc = u_k.conj().T @ cm_loc[q]               # (R_out, R/p)
            T2[q] = all_gather(t2_loc, mesh, axis, dim=1)
            T2[q] = T2[q] * m_r[:R_out, None].to(T2[q].dtype)
    for q in range(P2):
        out[q][d - 1] = _last_site(T2[q], y2_loc[q, d - 1], R_out, mesh,
                                   axis)
    return torch.stack([torch.stack(o) for o in out])


def gram_chain_round_dist_pair(y_pair_loc, R_out: int, masks_out, mesh,
                               axis: str = "tp"):
    """Round TWO padded chains ``y_pair (2, d, R, n, R)`` (this rank's
    column block ``(2, d, R, n, R/p)``) with the pair-pipelined Gram-chain
    kernel (:func:`_gram_chain_kernel_dist_pipe`). Equals two independent
    :func:`gram_chain_round_dist` calls."""
    _check_split(y_pair_loc, mesh, axis)
    return _gram_chain_kernel_dist_pipe(y_pair_loc, masks_out, R_out=R_out,
                                        mesh=mesh, axis=axis)


def gram_chain_round_dist(y_loc, R_out: int, masks_out, mesh,
                          axis: str = "tp"):
    """Distributed :func:`ttnx_torch.solvers.round_scan.tt_round_gram`: the
    Gram-chain rounding with every O(R^3) matmul column-sharded over
    ``mesh[axis]`` and only small ``(R_out n)^2`` eighs replicated — the tp
    form without the replicated (R, R) eighs of :func:`gram_round_dist`.
    ``R`` must divide by the axis size; returns the rounded ``(d, R_out, n,
    R_out)`` chain on every rank."""
    _check_split(y_loc, mesh, axis)
    return _gram_chain_kernel_dist(y_loc, masks_out, R_out=R_out, mesh=mesh,
                                   axis=axis)


def shard_chain(y, mesh, axis: str = "tp"):
    """This rank's block of the last (rank) axis of a padded chain ``(...,
    R)`` over ``mesh[axis]`` (the twin of ``device_put`` with ``P(None,
    None, None, axis)``)."""
    return local_block(y, mesh, axis, y.ndim - 1).contiguous()


def gram_round_dist(y_loc, masks_y, R_out: int, masks_out, mesh,
                    axis: str = "tp"):
    """Distributed :func:`ttnx_torch.solvers.round_scan.tt_round_scan`
    (``method='gram'``): ``y (d, R, n, R)`` column-sharded over
    ``mesh[axis]`` (``y_loc`` this rank's block), rounded to buffer rank
    ``R_out`` (returned on every rank). ``R`` must be divisible by the axis
    size."""
    _check_split(y_loc, mesh, axis)
    return _round_kernel(y_loc, masks_y, masks_out, R_out=R_out, mesh=mesh,
                         axis=axis)


def tp_rounding_worthwhile(RA: int, rmax: int, p: int,
                           overhead_x: float = 2.0) -> bool:
    """Auto-select predicate: is tp-sharding the gram rounding expected to
    beat replicated execution?

    The formula and both constants are the JAX package's, kept so that the
    auto path picks what the reference picks; neither was measured on an
    NVIDIA card. 0.56 is the replicated fraction of the gram rounding (the
    per-site eigh of the (R, R) Gram, which scales with the same O(R^3) as
    the sharded matmuls) and 2.0 the collective overhead factor, both taken
    by the reference on its own hardware. With them the Amdahl bound
    ``1 / (0.56 + 0.44 / p)`` stays below 2 for every ``p``, so the
    predicate is False and the auto path rounds replicated; the sharded
    kernels run on request (``force_tp=True``).
    """
    R = RA * rmax
    ideal = 1.0 / (0.56 + 0.44 / p)
    return ideal > overhead_x and R >= 512


def make_cn_step_dist(A, h: float, rmax: int, dims, u_rks, mesh,
                      dtype=torch.float64, sweep_count: int = 4,
                      solver: str = "lu", axis: str = "tp",
                      force_tp: bool | None = None,
                      round_method: str = "gram"):
    """Crank–Nicolson step with the rounding stage tp-sharded: the
    distributed twin of :func:`ttnx_torch.solvers.round_scan.make_cn_step`.
    Every rank of the mesh calls it and steps the same state: the MPO
    application and the ALS solve run replicated at the target rank; the
    ``R = R_A rmax`` sized rounding runs column-sharded over
    ``mesh[axis]`` (:func:`gram_round_dist` or, for ``round_method=
    'gram_chain'``, :func:`gram_chain_round_dist`). Returns ``(step_fn,
    pack, unpack)``; the state is whole on every rank.

    ``force_tp=None`` (auto) consults :func:`tp_rounding_worthwhile`, which
    keeps the rounding replicated (``tt_round_scan(method='gram')`` or
    ``tt_round_gram``, the latter kernel B1 for real dtypes);
    ``force_tp=True`` runs the sharded kernels when the axis has more than
    one rank."""
    from ttnx_torch.solvers.als_scan import als_sweeps, unpack_tt
    from ttnx_torch.solvers.round_scan import (_cn_pack, _cn_parts,
                                               matvec_padded, tt_round_gram,
                                               tt_round_scan)

    if round_method not in ("gram", "gram_chain"):
        raise ValueError("round_method must be 'gram' or 'gram_chain', "
                         f"got {round_method!r}")
    c = _cn_parts(A, h, rmax, dims, u_rks, dtype)
    p = axis_size(mesh, axis)
    use_tp = (tp_rounding_worthwhile(c["RA"], rmax, p) if force_tp is None
              else bool(force_tp)) and p > 1

    def step_fn(u_stack):
        big = matvec_padded(c["rhs_stack"], u_stack)
        if use_tp:
            big = shard_chain(big, mesh, axis)
            if round_method == "gram_chain":
                b = gram_chain_round_dist(big, rmax, c["masks_out"], mesh,
                                          axis)
            else:
                b = gram_round_dist(big, c["masks_big"], rmax,
                                    c["masks_out"], mesh, axis)
        elif round_method == "gram_chain":
            b = tt_round_gram(big, rmax, c["masks_out"])
        else:
            b = tt_round_scan(big, c["masks_big"], rmax, c["masks_out"],
                              method="gram")
        return als_sweeps(c["lhs_stack"], b, u_stack + c["guess_noise"],
                          c["masks_u"], sweep_count, solver=solver)

    def pack(u):
        return _cn_pack(u, rmax, dtype, A.device)

    def unpack(s):
        return unpack_tt(s, c["u_rks"])

    return step_fn, pack, unpack
