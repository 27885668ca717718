"""Continuous batching of independent QTT solves: one operator (or one per
problem), a batch of right-hand sides, initial guesses and states; and the
mesh that spreads such a batch over the ranks of a process group.

:func:`batched_als_sweeps` is the twin of ``ttnx.parallel.batch.
batched_als_sweeps`` (a ``vmap`` of ``als_sweeps`` there). It runs the batch
as a loop over problems through :func:`ttnx_torch.solvers.als_scan.
als_sweeps`, so every solver option keeps its exact semantics; the batch
written out is :func:`ttnx_torch.solvers.als_scan_batched.als_sweeps_b`
(kernels B5/B6) and, for the whole pass in one launch,
:func:`ttnx_torch.kernels.als_sweep_fused.als_fwd_bwd_fused_batched` (B7).

:func:`batched_dmrg_eig_sweeps`, :func:`batched_tdvp1_steps` and
:func:`batched_tdvp2_steps` are the twins of the JAX package's ``vmap``s
of the DMRG and TDVP sweeps, likewise loops over problems: the operator
stack is shared (5-D) or one per problem (6-D), masks are per problem, and
a step ``h`` is a scalar or one value per problem.

The mesh half is SPMD (every rank of an initialized ``torch.distributed``
group makes the same calls): :func:`make_mesh` builds the ``(dp, tp)``
``DeviceMesh``; :func:`shard_batch` and :func:`shard_batched_problem`
return this rank's ``dp`` block of the batched arrays (the twins of
``device_put`` with ``P("dp")``), and the batched loops above then run on
those blocks; :func:`batched_als_linsolve` takes and returns whole lists on
every rank, solving only this rank's ``dp`` share.
"""

from __future__ import annotations

import numpy as np
import torch

from ttnx_torch.parallel.comm import all_gather, local_block
from ttnx_torch.solvers.als_scan import (als_sweeps, pack_op, pack_tt,
                                         rank_masks, unpack_tt)
from ttnx_torch.solvers.dmrg_scan import dmrg_eig_sweep
from ttnx_torch.solvers.tdvp_scan import tdvp1_step, tdvp2_step

__all__ = ["make_mesh", "batched_als_sweeps", "batched_als_linsolve",
           "batched_dmrg_eig_sweeps", "batched_tdvp1_steps",
           "batched_tdvp2_steps", "shard_batched_problem", "shard_batch"]


def make_mesh(dp: int | None = None, tp: int = 1, *, device):
    """A ``(dp, tp)`` ``DeviceMesh`` over the ranks of the initialized
    process group, axes ``("dp", "tp")``: data-parallel batch axis x
    tensor-parallel rank axis, on ``device``'s type. Defaults to all ranks
    on ``dp``; ``dp * tp`` must be the world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp must equal the world size ({dp}*{tp} != "
                         f"{n})")
    return init_device_mesh(torch.device(device).type, (dp, tp),
                            mesh_dim_names=("dp", "tp"))


def batched_als_sweeps(A_stack, b_batch, x_batch, masks, sweep_count: int = 2,
                       solver: str = "lu"):
    """``als_sweeps`` (its default ``cg_iters=48``) on each problem of the
    leading axis of ``b_batch/x_batch``; returns the stacked solutions."""
    return torch.stack([
        als_sweeps(A_stack, b, x, masks, sweep_count, solver=solver)
        for b, x in zip(b_batch, x_batch)])


def _op_axis(A):
    """0 when the operator stack carries a leading batch axis (one operator
    per problem, ``(B, d, RA, n, n, RA)``), else None (one shared
    operator)."""
    if A.ndim == 6:
        return 0
    if A.ndim == 5:
        return None
    raise ValueError(f"operator stack must be 5-D or 6-D, got {A.ndim}-D")


def _per_problem(A, B):
    """The operator stack of each of the B problems."""
    return list(A) if _op_axis(A) == 0 else [A] * B


def _steps(h, B):
    """The step of each of the B problems: ``h`` itself when it is a
    scalar (no cast: a Python float stays exact in float64 runs)."""
    nd = h.ndim if torch.is_tensor(h) else np.ndim(h)
    return list(h) if nd == 1 else [h] * B


def batched_dmrg_eig_sweeps(A, x_batch, mask_batch, tol, degen_tol,
                            n_sweeps: int = 1, lanczos_iters: int = 24,
                            split: str = "svd"):
    """``n_sweeps`` DMRG eigensweeps of each problem (a parameter sweep:
    one Hamiltonian per problem, or one shared). Returns ``(x_batch,
    mask_batch, energies (B, n_sweeps * 2 (d-1)))``."""
    xs, ms, Es = [], [], []
    for A_stack, x, m in zip(_per_problem(A, len(x_batch)), x_batch,
                             mask_batch):
        lams = []
        for _ in range(n_sweeps):
            x, m, E = dmrg_eig_sweep(A_stack, x, m, tol, degen_tol,
                                     lanczos_iters=lanczos_iters,
                                     split=split)
            lams.append(E)
        xs.append(x)
        ms.append(m)
        Es.append(torch.cat(lams))
    return torch.stack(xs), torch.stack(ms), torch.stack(Es)


def batched_tdvp1_steps(A, x_batch, mask_batch, h, n_steps: int = 1,
                        expm: str = "lanczos", krylov_dim: int = 20,
                        imag_real: bool = False):
    """``n_steps`` 1-site TDVP steps of each problem; ``h`` is a scalar
    step or one per problem. Returns the evolved ``x_batch``."""
    B = len(x_batch)
    out = []
    for A_stack, x, m, hh in zip(_per_problem(A, B), x_batch, mask_batch,
                                 _steps(h, B)):
        for _ in range(n_steps):
            x = tdvp1_step(A_stack, x, m, hh, expm=expm,
                           krylov_dim=krylov_dim, imag_real=imag_real)
        out.append(x)
    return torch.stack(out)


def batched_tdvp2_steps(A, x_batch, mask_batch, h, truncerr, max_bond,
                        n_steps: int = 1, expm: str = "lanczos",
                        krylov_dim: int = 20, imag_real: bool = False,
                        split: str = "svd"):
    """``n_steps`` rank-adaptive 2-site TDVP steps of each problem; masks
    adapt per problem. Returns ``(x_batch, mask_batch)``."""
    B = len(x_batch)
    te = torch.as_tensor(truncerr, dtype=x_batch.real.dtype,
                         device=x_batch.device)
    xs, ms = [], []
    for A_stack, x, m, hh in zip(_per_problem(A, B), x_batch, mask_batch,
                                 _steps(h, B)):
        for _ in range(n_steps):
            x, m = tdvp2_step(A_stack, x, m, hh, te, max_bond, expm=expm,
                              krylov_dim=krylov_dim, imag_real=imag_real,
                              split=split)
        xs.append(x)
        ms.append(m)
    return torch.stack(xs), torch.stack(ms)


def shard_batch(mesh, *arrays):
    """This rank's ``dp`` block of each batched array (leading problem
    axis) — the generic dp placement for the batched DMRG/TDVP tiers."""
    return tuple(local_block(a, mesh, "dp") for a in arrays)


def shard_batched_problem(mesh, A_stack, b_batch, x_batch, masks):
    """A batched problem on this rank: the ``dp`` blocks of ``b_batch`` and
    ``x_batch``, the operator and masks whole. The JAX package also shards
    ``x``'s last rank axis over ``tp``; here ``x`` stays whole within a
    ``tp`` group (the result is the same)."""
    b_sh, x_sh = shard_batch(mesh, b_batch, x_batch)
    return A_stack, b_sh, x_sh, masks


def batched_als_linsolve(mesh, A, bs, x0s, sweep_count: int = 2,
                         rmax: int | None = None, solver: str = "lu"):
    """Solve many independent ``A x = b_k`` problems across the mesh.

    All problems must share dims and the rank profile of ``x0s[0]`` (pad
    the guesses to a common ``rmax`` first); their number must divide by
    ``dp``. Every rank passes the whole lists and gets the whole list of
    TTVectors back; it solves its ``dp`` share, and the shares are
    gathered along ``dp``."""
    from functools import reduce

    from ttnx_torch.core.canonical import orthogonalize

    x0s = [orthogonalize(x, 0) for x in x0s]
    rks = x0s[0].ranks
    if rmax is None:
        rmax = max(rks)
    dt = reduce(torch.promote_types, [b.dtype for b in bs], A.dtype)
    A_stack = pack_op(A.astype(dt), max(A.ranks))
    Rb = max(max(b.ranks) for b in bs)
    b_batch = torch.stack([pack_tt(b.astype(dt), Rb) for b in bs])
    x_batch = torch.stack([pack_tt(x.astype(dt), rmax) for x in x0s])
    real_dt = torch.empty((), dtype=dt).real.dtype
    masks = rank_masks(rks, rmax, dtype=real_dt, device=A_stack.device)

    A_sh, b_sh, x_sh, m_sh = shard_batched_problem(
        mesh, A_stack, b_batch, x_batch, masks)
    out = all_gather(batched_als_sweeps(A_sh, b_sh, x_sh, m_sh, sweep_count,
                                        solver=solver), mesh, "dp")
    return [unpack_tt(out[k], rks) for k in range(len(bs))]
