"""QTT operator constructors (the slice's part: the Toeplitz stencil).

Cores are small structured constants assembled with numpy and moved once
to the requested device. Layout: ``(r_left, n_out, n_in, r_right)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ttnx_torch.core.tt import TTOperator

__all__ = ["toeplitz_to_qtto"]

_ID = np.eye(2)
_J = np.array([[0.0, 1.0], [0.0, 0.0]])  # superdiagonal shift block
_JT = _J.T


def _op(blocks, dtype=torch.float64, device="cpu") -> TTOperator:
    """Build a TTOperator from per-site nested lists of 2x2 physical blocks
    (or ``0``); entry ``(a, b)`` connects left bond a to right bond b."""
    cores = []
    for block in blocks:
        rl, rr = len(block), len(block[0])
        core = np.zeros((rl, 2, 2, rr))
        for a in range(rl):
            for b in range(rr):
                blk = block[a][b]
                if isinstance(blk, (int, float)) and blk == 0:
                    continue
                core[a, :, :, b] = blk
        cores.append(torch.as_tensor(core, dtype=dtype, device=device))
    return TTOperator(cores)


def toeplitz_to_qtto(alpha, beta, gamma, d: int, *, dtype=torch.float64,
                     device="cpu") -> TTOperator:
    """Rank-3 exact QTT of the tridiagonal Toeplitz matrix
    ``alpha*I + beta*sub + gamma*super``."""
    first = [[_ID, _JT, _J]]
    mid = [[_ID, _JT, _J], [0, _J, 0], [0, 0, _JT]]
    last = [[alpha * _ID + beta * _J + gamma * _JT], [gamma * _J],
            [beta * _JT]]
    if d == 1:
        return _op([[[alpha * _ID + beta * _J + gamma * _JT]]], dtype, device)
    return _op([first] + [mid] * (d - 2) + [last], dtype, device)
