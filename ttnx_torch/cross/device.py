"""Device TT-cross: the fixed-rank MaxVol and two-site DMRG cross with
every step on the card.

Twin of ``ttnx.cross.device``. There one compiled XLA program runs a whole
cross and ``jax.vmap`` batches crosses; here each site step is a handful of
batched torch calls and a leading batch axis takes ``vmap``'s place: with
``batch=B`` the black box maps ``(B, m, N)`` int64 indices to ``(B, m)``
values, every site step runs once for all problems (one batched QR, LU,
inverse, maxvol and ``f_idx`` call), and the cores come back ``(B, R_j,
I_j, R_{j+1})`` with ``val_eps`` ``(B, n_iters)``, the shapes ``vmap``
returns. Without ``batch`` the shapes are ttnx's.

Ranks are static (feasibility-clamped), pivot buffers are fixed-size and
the maxvol row swaps run on the card: each problem of a batch swaps until
its coefficients are dominated by ``tol`` or ``maxiter`` swaps are done,
then stays frozen, and the host reads the batch's convergence flag once
every :data:`CHECK_EVERY` swaps. The math is ttnx's non-TPU branch: an LU
partial-pivot start with a pseudo-inverse start matrix, ``inv`` of the
pivot block and a true thin SVD (:func:`ttnx_torch.core.linalg.thin_svd`,
through which the pseudo-inverse is built as well). The random starting
index sets come from an explicit ``torch.Generator``: each maker returns
``fn(generator)``, which draws them and hands them to a module-private
sweep function (:func:`_maxvol_sweeps`, :func:`_dmrg_sweeps`) that takes
the sets as arguments.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ttnx_torch.core.linalg import thin_svd
from ttnx_torch.core.tt import TTVector
from ttnx_torch.cross.cross import _cap_ranks

__all__ = ["maxvol_fixed", "evaluate_tt_indices", "index_evaluator",
           "maxvol_cross_device", "dmrg_cross_device", "tt_cross_device",
           "tt_cross_device_adaptive", "CHECK_EVERY"]

# maxvol swaps run on the card between two host reads of the batch's
# convergence flag
CHECK_EVERY = 8


def _pinv(m: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse of a stack of matrices through :func:`thin_svd`, with
    ``jnp.linalg.pinv``'s cutoff: singular values at or below ``10 max(p,
    q) eps`` times the largest count as zero."""
    u, s, vh = thin_svd(m)
    rtol = 10.0 * max(m.shape[-2:]) * torch.finfo(s.dtype).eps
    s = torch.where(s > rtol * s[..., :1], s, torch.inf).to(u.dtype)
    return vh.mH @ (u.mH / s[..., :, None])


def _take_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x[b, rows[b]]`` for every ``b``: ``x (B, n, c)``, ``rows (B, k)``."""
    return x.gather(1, rows[..., None].expand(-1, -1, x.shape[-1]))


def _lu_rows(a: torch.Tensor, r: int) -> torch.Tensor:
    """Sorted first ``r`` rows of the LU partial-pivot permutation of each
    tall ``a (B, n, r)``: ``a[perm] = L U``, as ``lax.linalg.lu`` gives it."""
    lu, pivots, _ = torch.linalg.lu_factor_ex(a)
    p, _, _ = torch.lu_unpack(lu, pivots, unpack_data=False)
    # a = P L U: row i of L U is row perm[i] of a, the column of P's one
    perm = p.real.argmax(-2)
    return perm[:, :r].sort(-1).values


def _dominant(b: torch.Tensor, tol: float):
    """The flat index of each problem's largest ``|b|`` (the first on
    ties, as ``jnp.argmax``) and whether it exceeds ``tol``."""
    mag = b.abs().flatten(1)
    flat = mag.argmax(-1)
    return flat, mag.gather(1, flat[:, None])[:, 0] > tol


def _swap(b, rows, flat, active):
    """One row swap with its rank-1 update in each active problem; the
    others are returned unchanged."""
    r = b.shape[-1]
    i, j = flat // r, flat % r
    bj = b.gather(2, j[:, None, None].expand(-1, b.shape[1], 1))
    row = b.gather(1, i[:, None, None].expand(-1, 1, r))
    pivot = row.gather(2, j[:, None, None])
    unit = torch.arange(r, device=b.device) == j[:, None]
    bi = row - unit[:, None, :].to(b.dtype)
    b = torch.where(active[:, None, None], b - (bj * bi) / pivot, b)
    swapped = rows.scatter(1, j[:, None], i[:, None])
    return b, torch.where(active[:, None], swapped, rows)


def maxvol_fixed(a: torch.Tensor, tol: float = 1.05,
                 maxiter: int = 100) -> torch.Tensor:
    """Row indices (int64) of an ``r x r`` dominant submatrix of each tall
    ``a``: ``(n, r)`` gives ``(r,)``, a stack ``(B, n, r)`` gives ``(B,
    r)``. The Goreinov–Tyrtyshnikov swap iteration of
    :func:`ttnx_torch.cross.maxvol.maxvol` from the LU partial-pivot rows,
    with a fixed-size pivot buffer: a problem stops when every ``|a @
    inv(a[rows])|`` entry is at most ``tol`` or after ``maxiter`` swaps, and
    its rows equal those of the sequential loop. The swaps run on
    ``a``'s device; the host reads the batch's convergence flag once every
    :data:`CHECK_EVERY` swaps."""
    stack = a if a.dim() == 3 else a[None]
    batch, n, r = stack.shape
    if n <= r:
        rows = torch.arange(n, device=a.device).expand(batch, n)
        return rows if a.dim() == 3 else rows[0]
    rows = _lu_rows(stack, r)
    b = stack @ _pinv(_take_rows(stack, rows))
    flat, active = _dominant(b, tol)
    done = 0
    while done < maxiter:
        block = min(CHECK_EVERY, maxiter - done)
        for _ in range(block):
            b, rows = _swap(b, rows, flat, active)
            flat, active = _dominant(b, tol)
        done += block
        if not bool(active.any()):
            break
    return rows if a.dim() == 3 else rows[0]


def evaluate_tt_indices(cores, indices: torch.Tensor) -> torch.Tensor:
    """Batched TT evaluation at index rows: ``cores`` a list of ``(r_l, n,
    r_r)`` tensors and ``indices (m, N)`` give ``(m,)``; a batch of TTs,
    cores ``(B, r_l, n, r_r)`` and ``indices (B, m, N)``, gives ``(B, m)``
    (reference tt_cross_interpolation.jl:128-142)."""
    if indices.dim() == 2:
        return evaluate_tt_indices([c[None] for c in cores],
                                   indices[None])[0]
    batch, m, _ = indices.shape
    at = torch.arange(batch, device=indices.device)[:, None]
    state = torch.ones((batch, m, 1), dtype=cores[0].dtype,
                       device=cores[0].device)
    for d, core in enumerate(cores):
        slices = core.permute(0, 2, 1, 3)[at, indices[:, :, d]]
        state = torch.einsum("bml,bmlr->bmr", state, slices)
    return state[..., 0]


def index_evaluator(f: Callable, domain: Sequence, dtype=torch.float64, *,
                    device) -> Callable:
    """Wrap a torch coordinate function ``f(coords (..., N)) -> (...)`` and
    per-dimension grids into an index evaluator ``f_idx(indices (..., N))
    -> (...)``, the grids on ``device``."""
    grids = [torch.as_tensor(np.asarray(g), dtype=dtype, device=device)
             for g in domain]

    def f_idx(indices):
        return f(torch.stack([g[indices[..., d]] for d, g in enumerate(grids)],
                             dim=-1))

    return f_idx


def _grid_index(shape, axis: int, device) -> torch.Tensor:
    """The ``axis`` coordinate of every point of a C-order grid of
    ``shape``, flattened."""
    view = [-1 if a == axis else 1 for a in range(len(shape))]
    return torch.arange(shape[axis], device=device).view(view).expand(
        shape).reshape(-1)


def _index_rows(lset, rset, sites, k: int, N: int):
    """``(B, rl * prod(sites) * rr, N)`` index rows of the left set ``lset
    (B, rl, k)``, every index of the one or two ``sites`` dims, and the
    right set ``rset (B, rr, N - k - len(sites))``; C-order, left major and
    right minor — the contract of the host ``_fiber_indices`` and
    ``_superblock_indices``."""
    batch = lset.shape[0]
    shape = (lset.shape[1], *sites, rset.shape[1])
    dev = lset.device
    parts = []
    if k > 0:
        parts.append(lset[:, _grid_index(shape, 0, dev)])
    for axis in range(1, len(shape) - 1):
        parts.append(_grid_index(shape, axis, dev)[None, :, None].expand(
            batch, -1, 1))
    if N - k - len(sites) > 0:
        parts.append(rset[:, _grid_index(shape, len(shape) - 1, dev)])
    return torch.cat(parts, dim=-1)


def _draw(generator: torch.Generator, batch: int, rows: int, highs):
    """``(batch, rows, len(highs))`` uniform int64 indices, column ``c`` in
    ``[0, highs[c])``, each problem its own."""
    dev = generator.device
    return torch.stack([torch.randint(0, h, (batch, rows), generator=generator,
                                      device=dev) for h in highs], dim=-1)


def _empty_set(batch: int, device) -> torch.Tensor:
    return torch.zeros((batch, 1, 0), dtype=torch.int64, device=device)


def _pivot_inverse(q, tol, maxiter):
    """``(piv, q @ inv(q[piv]))`` with ``piv`` the maxvol rows of ``q``."""
    piv = maxvol_fixed(q, tol, maxiter)
    return piv, q @ torch.linalg.inv_ex(_take_rows(q, piv))[0]


class _Validation:
    """The validation sample of a cross and its relative errors."""

    def __init__(self, f_idx, Xv, dtype):
        self.Xv, self.dtype = Xv, dtype
        self.yv = None if Xv is None else f_idx(Xv)

    def eps(self, cores, batch, device):
        if self.Xv is None:
            return torch.zeros(batch, dtype=self.dtype.to_real(),
                               device=device)
        err = self.yv - evaluate_tt_indices(cores, self.Xv)
        return (torch.linalg.vector_norm(err, dim=-1)
                / torch.clamp(torch.linalg.vector_norm(self.yv, dim=-1),
                              min=1e-300))


def _maxvol_sweeps(f_idx, Is, Rs, rsets, Xv, n_iters, pivot_tol,
                   pivot_maxiter, dtype):
    """The alternating MaxVol cross from the right index sets ``rsets[j]
    (B, Rs[j+1], N-j-1)`` (``rsets[N-1]`` empty, ``(B, 1, 0)``) and the
    validation indices ``Xv (B, n_val, N)`` (or None); ``f_idx`` maps ``(B,
    m, N)`` to ``(B, m)``. Returns ``(cores, val_eps (B, n_iters))``."""
    N = len(Is)
    rsets = list(rsets)
    batch, dev = rsets[-1].shape[0], rsets[-1].device
    lsets = [_empty_set(batch, dev)] + [None] * (N - 1)
    cores = [None] * N
    val = _Validation(f_idx, Xv, dtype)
    eps_hist = []
    for _ in range(n_iters):
        # L -> R: maxvol pivots of the left fiber unfolding
        for j in range(N - 1):
            idx = _index_rows(lsets[j], rsets[j], (Is[j],), j, N)
            V = f_idx(idx).reshape(batch, Rs[j] * Is[j], Rs[j + 1])
            q, _ = torch.linalg.qr(V)
            piv, G = _pivot_inverse(q, pivot_tol, pivot_maxiter)
            cores[j] = G.reshape(batch, Rs[j], Is[j], Rs[j + 1])
            lsets[j + 1] = torch.cat([_take_rows(lsets[j], piv // Is[j]),
                                      (piv % Is[j])[..., None]], dim=-1)
        # R -> L: mirrored
        for j in range(N - 1, 0, -1):
            idx = _index_rows(lsets[j], rsets[j], (Is[j],), j, N)
            V = f_idx(idx).reshape(batch, Rs[j], Is[j] * Rs[j + 1])
            q, _ = torch.linalg.qr(V.transpose(-1, -2))
            piv, G = _pivot_inverse(q, pivot_tol, pivot_maxiter)
            cores[j] = G.reshape(batch, Is[j], Rs[j + 1],
                                 Rs[j]).permute(0, 3, 1, 2)
            rsets[j - 1] = torch.cat(
                [(piv // Rs[j + 1])[..., None],
                 _take_rows(rsets[j], piv % Rs[j + 1])], dim=-1)
        idx = _index_rows(lsets[0], rsets[0], (Is[0],), 0, N)
        cores[0] = f_idx(idx).reshape(batch, 1, Is[0], Rs[1])
        eps_hist.append(val.eps(cores, batch, dev))
    return cores, torch.stack(eps_hist, dim=-1)


def _dmrg_sweeps(f_idx, Is, Rs, Il, Ig, Xv, n_iters, pivot_tol,
                 pivot_maxiter, dtype):
    """The two-site DMRG cross from the left index sets ``Il[k] (B, Rs[k],
    k)`` (``Il[0]`` empty) and the right ones ``Ig[k] (B, Rs[k+1],
    N-1-k)`` (``Ig[N-1]`` empty), validated on ``Xv``; as
    :func:`_maxvol_sweeps` otherwise."""
    N = len(Is)
    Il, Ig = list(Il), list(Ig)
    batch, dev = Il[0].shape[0], Il[0].device
    cores = [None] * N
    val = _Validation(f_idx, Xv, dtype)
    eps_hist = []

    def superblock(k):
        rl, rg = Rs[k], Rs[k + 2]
        idx = _index_rows(Il[k], Ig[k + 1], (Is[k], Is[k + 1]), k, N)
        sb = f_idx(idx).reshape(batch, rl * Is[k], Is[k + 1] * rg)
        return sb, rl, rg

    for _ in range(n_iters):
        for k in range(N - 1):  # L -> R superblock sweep
            sb, rl, rg = superblock(k)
            r = Rs[k + 1]
            u_r = thin_svd(sb)[0][..., :r]
            if k < N - 2:
                piv, G = _pivot_inverse(u_r, pivot_tol, pivot_maxiter)
                cores[k] = G.reshape(batch, rl, Is[k], r)
                Il[k + 1] = torch.cat([_take_rows(Il[k], piv // Is[k]),
                                       (piv % Is[k])[..., None]], dim=-1)
            else:
                cores[k] = u_r.reshape(batch, rl, Is[k], r)
                # the exact projection of sb onto span(u_r)
                cores[k + 1] = (u_r.mH @ sb).reshape(batch, r, Is[k + 1], rg)
        for k in range(N - 2, -1, -1):  # R -> L superblock sweep
            sb, rl, rg = superblock(k)
            r = Rs[k + 1]
            q = thin_svd(sb)[2][..., :r, :].mH  # (s2 * rg, r)
            if k > 0:
                piv, G = _pivot_inverse(q, pivot_tol, pivot_maxiter)
                cores[k + 1] = G.mH.reshape(batch, r, Is[k + 1], rg)
                Ig[k] = torch.cat([(piv // rg)[..., None],
                                   _take_rows(Ig[k + 1], piv % rg)], dim=-1)
            else:
                # sb ~ (sb q) q^H; ttnx's sb @ conj(q) is wrong for complex
                # data (ROADMAP C.9)
                cores[k] = (sb @ q).reshape(batch, rl, Is[k], r)
                cores[k + 1] = q.mH.reshape(batch, r, Is[k + 1], rg)
        eps_hist.append(val.eps(cores, batch, dev))
    return cores, torch.stack(eps_hist, dim=-1)


def _batched(f_idx, batch):
    """``f_idx`` on a leading batch axis: itself with a batch, else the
    single-problem evaluator on a batch of one."""
    if batch is not None:
        return f_idx
    return lambda idx: f_idx(idx[0])[None]


def _unbatched(cores, eps, batch):
    if batch is not None:
        return cores, eps
    return [c[0] for c in cores], eps[0]


def maxvol_cross_device(f_idx: Callable, Is: Sequence[int], rank: int,
                        n_iters: int = 3, pivot_tol: float = 1.05,
                        pivot_maxiter: int = 100, dtype=torch.float64,
                        n_val: int = 0, *, batch: int | None = None):
    """The fixed-rank alternating MaxVol cross.

    Returns ``fn(generator) -> (cores, val_eps)``: ``cores`` the list of
    ``(R_j, I_j, R_{j+1})`` TT cores (static feasibility-clamped ranks),
    ``val_eps`` the per-iteration validation errors on ``n_val`` random
    points (shape ``(n_iters,)``; all-zero when ``n_val == 0``). Fixed trip
    count. ``f_idx`` maps int64 indices ``(m, N)`` to ``(m,)`` values; with
    ``batch=B`` it maps ``(B, m, N)`` to ``(B, m)`` and the results gain a
    leading axis of ``B``, each problem with its own starting sets drawn
    from ``generator`` (on the device the cross runs on)."""
    Is = [int(i) for i in Is]
    N = len(Is)
    Rs = _cap_ranks([1] + [int(rank)] * (N - 1) + [1], Is, int(rank))
    nb = 1 if batch is None else int(batch)
    fb = _batched(f_idx, batch)

    def run(generator: torch.Generator):
        # nested right index sets: rsets[j] (B, Rs[j+1], N-j-1)
        rsets = [_draw(generator, nb, Rs[j + 1], Is[j + 1:])
                 for j in range(N - 1)] + [_empty_set(nb, generator.device)]
        Xv = _draw(generator, nb, n_val, Is) if n_val else None
        cores, eps = _maxvol_sweeps(fb, Is, Rs, rsets, Xv, n_iters,
                                    pivot_tol, pivot_maxiter, dtype)
        return _unbatched(cores, eps, batch)

    return run


def dmrg_cross_device(f_idx: Callable, Is: Sequence[int], rank: int,
                      n_iters: int = 3, pivot_tol: float = 1.05,
                      pivot_maxiter: int = 100, dtype=torch.float64,
                      n_val: int = 0, *, batch: int | None = None):
    """Fixed-rank two-site DMRG-cross (device twin of the host
    ``DMRGCross`` path, reference tt_cross_interpolation.jl:523-658):
    superblock sampling, thin SVD truncated to the static target rank,
    maxvol pivots on the orthonormal factor, nested index-set updates.
    Returns ``fn(generator) -> (cores, val_eps)``; ``batch`` as in
    :func:`maxvol_cross_device`."""
    Is = [int(i) for i in Is]
    N = len(Is)
    if N < 2:
        raise ValueError("dmrg_cross_device needs N >= 2 dimensions")
    Rs = _cap_ranks([1] + [int(rank)] * (N - 1) + [1], Is, int(rank))
    nb = 1 if batch is None else int(batch)
    fb = _batched(f_idx, batch)

    def run(generator: torch.Generator):
        empty = _empty_set(nb, generator.device)
        Il = [empty] + [_draw(generator, nb, Rs[k], Is[:k])
                        for k in range(1, N)]
        Ig = [_draw(generator, nb, Rs[k + 1], Is[k + 1:])
              for k in range(N - 1)] + [empty]
        Xv = _draw(generator, nb, n_val, Is) if n_val else None
        cores, eps = _dmrg_sweeps(fb, Is, Rs, Il, Ig, Xv, n_iters,
                                  pivot_tol, pivot_maxiter, dtype)
        return _unbatched(cores, eps, batch)

    return run


_MAKERS = {"maxvol": maxvol_cross_device, "dmrg": dmrg_cross_device}


def tt_cross_device(f: Callable, domain, rank: int, n_iters: int = 3,
                    pivot_tol: float = 1.05, dtype=torch.float64,
                    n_val: int = 0, seed: int = 0, method: str = "maxvol", *,
                    device):
    """Convenience driver: the device cross (``method='maxvol'``
    alternating-fiber or ``'dmrg'`` two-site superblock) of a torch
    coordinate function ``f`` on coordinate grids, on ``device``, from a
    generator seeded with ``seed``; returns ``(TTVector, val_eps)``."""
    f_idx = index_evaluator(f, domain, dtype=dtype, device=device)
    Is = [len(np.asarray(g)) for g in domain]
    run = _MAKERS[method](f_idx, Is, rank, n_iters=n_iters,
                          pivot_tol=pivot_tol, dtype=dtype, n_val=n_val)
    cores, eps = run(torch.Generator(device=device).manual_seed(seed))
    return TTVector(cores), eps.cpu().numpy()


def tt_cross_device_adaptive(f: Callable, domain, tol: float = 1e-10,
                             rank_schedule=(2, 4, 8, 16), n_iters: int = 3,
                             n_val: int = 1000, seed: int = 0,
                             method: str = "maxvol", dtype=torch.float64,
                             pivot_tol: float = 1.05, *, device):
    """Rank-adaptive device cross: a host loop over static-rank stages (the
    analog of the host path's kickrank growth); the validation eps decides
    whether to escalate. Every stage starts from a generator seeded with
    ``seed``. Returns ``(TTVector, eps, rank_used)``."""
    f_idx = index_evaluator(f, domain, dtype=dtype, device=device)
    Is = [len(np.asarray(g)) for g in domain]
    cores = eps = None
    rank_used = None
    for rank in rank_schedule:
        run = _MAKERS[method](f_idx, Is, int(rank), n_iters=n_iters,
                              pivot_tol=pivot_tol, dtype=dtype, n_val=n_val)
        cores, eps = run(torch.Generator(device=device).manual_seed(seed))
        eps = eps.cpu().numpy()
        rank_used = int(rank)
        if float(eps[-1]) < tol:
            break
    return TTVector(cores), eps, rank_used
