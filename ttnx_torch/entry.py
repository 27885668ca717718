"""The flagship step, the d=12 Crank–Nicolson QTT heat step, and the
batched implicit-heat problem.

``entry(device)`` returns ``(fn, (u_stack,))``: one CN step of
``du/dt = A u`` with ``A`` the scaled Dirichlet Laplacian, rank 16, f32,
through the production configuration (matrix-free/dense fused CG,
Gram-chain rounding, no TF32, 16 warm-started CG iterations).

``batched_als_problem(device)`` builds the throughput workload: B
independent rank-64 d=12 implicit heat solves ``(I - h/2 A) x = u0`` sharing
one operator, for ``als_sweeps_b`` and ``als_fwd_bwd_fused_batched``.
``flat_spectrum_stack`` makes distinct, well-conditioned states for holding
the batched kernels against their plain versions.
"""

from __future__ import annotations

import torch

import numpy as np

from ttnx_torch.core.algebra import add_op, scale_op
from ttnx_torch.core.canonical import tt_round
from ttnx_torch.core.tt import id_tto, r_and_d_to_rks
from ttnx_torch.ops.operators import toeplitz_to_qtto
from ttnx_torch.ops.qtt import qtt_sin
from ttnx_torch.solvers.als_scan import pack_op, pack_tt, rank_masks
from ttnx_torch.solvers.round_scan import make_cn_step

__all__ = ["entry", "flagship_cn_step", "three_mode_state",
           "batched_als_problem", "flat_spectrum_stack"]


def flagship_cn_step(device, rmax: int = 16, d: int = 12, h: float = 1e-9,
                     dtype=torch.float32, cg_iters: int = 16):
    """``make_cn_step`` at the production settings on ``device``."""
    hg = 1.0 / (2 ** d + 1)
    A = (-1.0 / hg ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, d,
                                            device=device)
    return make_cn_step(
        A, h, rmax=rmax, dims=(2,) * d,
        u_rks=(1,) + (rmax,) * (d - 1) + (1,), dtype=dtype, sweep_count=2,
        solver="cg_fused", round_method="gram_chain", precision="highest",
        cg_iters=cg_iters)


def entry(device):
    """``(fn, (u_stack,))``: the flagship step and a packed ``qtt_sin``
    state on ``device``."""
    d = 12
    hg = 1.0 / (2 ** d + 1)
    step_fn, pack, _ = flagship_cn_step(device, d=d)
    u_stack = pack(qtt_sin(d, a=hg, b=1 - hg, device=device))
    return step_fn, (u_stack,)


def three_mode_state(d: int, hg: float, device="cpu"):
    """Sum of three Dirichlet eigenmodes of the grid Laplacian (rank 6) on
    the interior grid, float64."""

    def mode(lam):
        return qtt_sin(d, a=hg, b=1 - hg, lam=lam, device=device)

    return mode(1.0) + 0.5 * mode(3.0) + 0.25 * mode(9.0)


def batched_als_problem(device, *, batch: int = 512, rmax: int = 64,
                        d: int = 12, h: float = 1e-6, dtype=torch.float32):
    """The batched implicit heat solve on ``device``: ``lhs_stack`` of
    ``I - h/2 A``, the rank-``rmax`` three-mode state packed as ``b_batch``
    and ``x_batch`` (broadcast over ``batch``), ``masks``, ``u_rks`` and the
    unpacked float64 state ``u0``. Returns a dict of those six."""
    hg = 1.0 / (2 ** d + 1)
    A = ((-1.0 / hg ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, d,
                                             device=device)).astype(dtype)
    lhs = add_op(id_tto(d, dtype=dtype, device=device),
                 scale_op(-h / 2, A))
    lhs_stack = pack_op(lhs, max(lhs.ranks))
    u_rks = r_and_d_to_rks((1,) + (rmax,) * (d - 1) + (1,), (2,) * d,
                           rmax=rmax)
    masks = rank_masks(u_rks, rmax, dtype=dtype, device=device)
    u0 = three_mode_state(d, hg, device)
    us = pack_tt(tt_round(u0, max_bond=rmax).astype(dtype), rmax)
    b_batch = us.expand((batch,) + us.shape)
    return dict(lhs_stack=lhs_stack, b_batch=b_batch, x_batch=b_batch,
                masks=masks, u_rks=u_rks, u0=u0)


def flat_spectrum_stack(rng, rks, R: int, n: int = 2):
    """Padded ``(d, R, n, R)`` numpy stack of a TT with ranks ``rks`` whose
    cores are left- and right-orthonormal up to scale (random orthogonal
    blocks from ``rng``), so every bond has a flat singular spectrum. Such
    states keep the Newton–Schulz gauge of the fused sweep well
    conditioned; states whose bond spectra fall to rounding level do not
    (ROADMAP C)."""
    d = len(rks) - 1
    out = np.zeros((d, R, n, R))
    for k in range(d):
        rl, rr = rks[k], rks[k + 1]
        if rl == rr:
            for i in range(n):
                q, _ = np.linalg.qr(rng.standard_normal((rl, rl)))
                out[k, :rl, i, :rr] = q / np.sqrt(n)
        elif max(rl, rr) == n * min(rl, rr):  # rising or falling ranks
            q, _ = np.linalg.qr(rng.standard_normal((max(rl, rr),) * 2))
            out[k, :rl, :, :rr] = q.reshape(rl, n, rr)
        else:
            raise ValueError(f"flat_spectrum_stack: bond ranks {rl} -> {rr}"
                             f" are neither equal nor a factor {n} apart")
    return out
