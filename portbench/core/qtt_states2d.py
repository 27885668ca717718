"""Sums of 2-D Dirichlet sine modes as padded serial QTT stacks, the inputs
of the 2-D heat cells.

On ``N x N`` interior points, ``N = 2^da`` and ``hg = 1 / (N + 1)``, mode
number ``m`` (1 .. N^2) is the pair ``k = (m - 1) // N + 1``,
``l = (m - 1) % N + 1``, and state ``s`` samples
``sum_m amps[s, m] sin(k pi hg (i + 1)) sin(l pi hg (j + 1))``. The grid
vector is ``u[i N + j]``: the first ``da`` sites are the bits of ``i``, most
significant first, then the ``da`` bits of ``j`` (the serial order). The
samples of a state are one product of two ``N x M`` sine tables; a
left-to-right chain of SVDs splits them into cores at the feasible ranks
``min(2^k, 2^(d-k))`` capped at ``R``, keeping the leading singular
directions (the TT-SVD), so a sum that needs more than ``R`` at a bond is
truncated there and one that needs less carries directions of weight zero.
All of it runs in float64 on ``device``, a chunk of states at a time; the
stack is cast at the end.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["mode_pairs", "plane_values", "plane_states"]

F64 = torch.float64


def mode_pairs(modes, da: int) -> tuple[np.ndarray, np.ndarray]:
    """``(k, l)`` of flat mode numbers ``modes`` on a ``2^da`` square."""
    m = np.asarray(modes) - 1
    return m // 2 ** da + 1, m % 2 ** da + 1


def plane_values(modes, amps, da: int, device) -> torch.Tensor:
    """``(S, N, N)`` float64 samples of the states on ``device``."""
    N = 2 ** da
    hg = 1.0 / (N + 1)
    i = torch.arange(1, N + 1, dtype=F64, device=device)

    def table(k):                                        # (S, N, M)
        k = torch.as_tensor(k, dtype=F64, device=device)
        return torch.sin(torch.pi * hg * i[None, :, None] * k[:, None, :])

    k, l = mode_pairs(modes, da)
    a = torch.as_tensor(np.asarray(amps), dtype=F64, device=device)
    return (table(k) * a[:, None, :]) @ table(l).mT


def _svd_driver(device) -> dict:
    """LAPACK's ``gesvd`` on CUDA, as ``ttnx_torch.core.linalg.thin_svd``
    asks; the CPU takes its default."""
    return {"driver": "gesvd"} if torch.device(device).type == "cuda" else {}


def _split(values, d: int, R: int) -> list[torch.Tensor]:
    """The TT-SVD of ``values (S, 2^d)``: at each bond the leading left
    singular vectors of the unfolding ``M``, taken from the triangular
    factor of ``M^T = Q T`` (``M = T^T Q^T`` has ``T^T``'s), and the
    remainder ``U^T M``."""
    ranks = [min(2 ** k, 2 ** (d - k), R) for k in range(d + 1)]
    S = values.shape[0]
    cores, rest = [], values.reshape(S, 1, -1)
    for k in range(d - 1):
        r, keep = ranks[k], ranks[k + 1]
        m = rest.reshape(S, 2 * r, -1)
        t = torch.linalg.qr(m.mT, mode="r")[1]
        u = torch.linalg.svd(t.mT, full_matrices=False,
                             **_svd_driver(m.device))[0][..., :keep]
        cores.append(u.reshape(S, r, 2, keep))
        rest = u.mT @ m
    cores.append(rest.reshape(S, ranks[d - 1], 2, 1))
    return cores


def plane_states(modes, amps, da: int, R: int, dtype,
                 device) -> torch.Tensor:
    """Padded ``(S, 2 da, R, 2, R)`` stack of the states on ``device``, 16
    states at a time (128 MiB of float64 samples at da = 10)."""
    modes, amps, chunk = np.asarray(modes), np.asarray(amps), 16
    out = torch.zeros((len(modes), 2 * da, R, 2, R), dtype=dtype,
                      device=device)
    for c in range(0, len(modes), chunk):
        values = plane_values(modes[c:c + chunk], amps[c:c + chunk], da,
                              device)
        for k, core in enumerate(_split(values, 2 * da, R)):
            out[c:c + chunk, k, :core.shape[1], :, :core.shape[3]] = core
    return out
