"""Continuous batching of independent QTT solves: one operator, a batch of
right-hand sides and initial guesses.

:func:`batched_als_sweeps` is the twin of ``ttnx.parallel.batch.
batched_als_sweeps`` (a ``vmap`` of ``als_sweeps`` there). It runs the batch
as a loop over problems through :func:`ttnx_torch.solvers.als_scan.
als_sweeps`, so every solver option keeps its exact semantics; the batch
written out is :func:`ttnx_torch.solvers.als_scan_batched.als_sweeps_b`
(kernels B5/B6) and, for the whole pass in one launch,
:func:`ttnx_torch.kernels.als_sweep_fused.als_fwd_bwd_fused_batched` (B7).
"""

from __future__ import annotations

import torch

from ttnx_torch.solvers.als_scan import als_sweeps

__all__ = ["batched_als_sweeps"]


def batched_als_sweeps(A_stack, b_batch, x_batch, masks, sweep_count: int = 2,
                       solver: str = "lu"):
    """``als_sweeps`` (its default ``cg_iters=48``) on each problem of the
    leading axis of ``b_batch/x_batch``; returns the stacked solutions."""
    return torch.stack([
        als_sweeps(A_stack, b, x, masks, sweep_count, solver=solver)
        for b, x in zip(b_batch, x_batch)])
