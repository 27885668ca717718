"""The flagship step: the d=12 Crank–Nicolson QTT heat step.

``entry(device)`` returns ``(fn, (u_stack,))``: one CN step of
``du/dt = A u`` with ``A`` the scaled Dirichlet Laplacian, rank 16, f32,
through the production configuration (matrix-free/dense fused CG,
Gram-chain rounding, no TF32, 16 warm-started CG iterations).
"""

from __future__ import annotations

import torch

from ttnx_torch.ops.operators import toeplitz_to_qtto
from ttnx_torch.ops.qtt import qtt_sin
from ttnx_torch.solvers.round_scan import make_cn_step

__all__ = ["entry", "flagship_cn_step"]


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
