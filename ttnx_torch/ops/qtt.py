"""Quantics-TT function encodings (the slice's part: ``qtt_sin``).

Big-endian bits: site 0 carries the most significant bit, so a C-order
``reshape(-1)`` of the dense tensor is the uniform-grid vector.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ttnx_torch.core.tt import TTVector

__all__ = ["qtt_sin"]


def _qtt_rank_struct(d: int, r: int) -> list[np.ndarray]:
    """Zero cores of the (1, r, ..., r, 1) rank profile."""
    rks = [1] + [r] * (d - 1) + [1]
    return [np.zeros((rks[k], 2, rks[k + 1])) for k in range(d)]


def _qtt_trig(d: int, a: float, b: float, lam: float, first_row, last_col,
              dtype, device) -> TTVector:
    """Rank-2 rotation cores shared by sin and cos."""
    h = (b - a) / (2 ** d - 1)
    cores = _qtt_rank_struct(d, 2)

    def rot(t):
        c, s = math.cos(lam * math.pi * t), math.sin(lam * math.pi * t)
        return np.array([[c, -s], [s, c]])

    cores[0][0, 0, :] = first_row(a)
    cores[0][0, 1, :] = first_row(a + h * 2 ** (d - 1))
    for k in range(1, d - 1):
        tk = h * 2 ** (d - 1 - k)
        cores[k][:, 0, :] = np.eye(2)
        cores[k][:, 1, :] = rot(tk)
    cores[d - 1][0, 0, 0] = 1.0
    cores[d - 1][:, 1, 0] = last_col(h)
    return TTVector([torch.as_tensor(c, dtype=dtype, device=device)
                     for c in cores])


def qtt_sin(d: int, a: float = 0.0, b: float = 1.0, lam: float = 1.0, *,
            dtype=torch.float64, device) -> TTVector:
    """Exact rank-2 QTT of ``sin(lam*pi*x)`` on the uniform grid of [a, b],
    on ``device`` (a required keyword)."""
    return _qtt_trig(
        d, a, b, lam,
        first_row=lambda t: [math.sin(lam * math.pi * t),
                             math.cos(lam * math.pi * t)],
        last_col=lambda t: [math.cos(lam * math.pi * t),
                            math.sin(lam * math.pi * t)],
        dtype=dtype, device=device)
