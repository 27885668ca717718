"""Sums of Dirichlet sine modes as padded QTT stacks, the inputs of the heat
cells.

State ``s`` samples ``sum_m amps[s, m] sin(modes[s, m] pi hg (j + 1))`` at
``j = 0 .. 2^d - 1``, ``hg = 1 / (2^d + 1)``, with site 0 the most
significant bit of ``j``. The samples are one sine transform (DST-I) of the
sparse mode coefficients; a left-to-right chain of exact QR factorisations
splits them into cores at the feasible ranks ``min(2^k, 2^(d-k))``, the
whole space, so any sum of modes fits and no rank is padded inside it.
Built in float64 on the host (a few hundred kilobytes a state), then
padded to ``R`` and cast on the device, one copy a core.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.fft
import torch

__all__ = ["sine_values", "sine_cores", "sine_states"]


def sine_values(modes, amps, d: int) -> np.ndarray:
    """``(S, 2^d)`` float64 samples of the states."""
    S = modes.shape[0]
    coef = np.zeros((S, 2 ** d))
    np.put_along_axis(coef, np.asarray(modes) - 1,
                      np.asarray(amps, dtype=np.float64), axis=1)
    return 0.5 * scipy.fft.dst(coef, type=1, axis=1)


def _split(values, d: int) -> list[np.ndarray]:
    cores, rest, r = [], values[:, None, :], 1
    for _ in range(d - 1):
        q, rest = np.linalg.qr(rest.reshape(rest.shape[0], 2 * r, -1))
        cores.append(q.reshape(q.shape[0], r, 2, q.shape[-1]))
        r = q.shape[-1]
    cores.append(rest.reshape(rest.shape[0], r, 2, 1))
    return cores


def sine_cores(modes, amps, d: int, chunk: int = 64) -> list[np.ndarray]:
    """Float64 cores ``(S, r_k, 2, r_{k+1})`` of the states at the feasible
    ranks, left-orthogonal but the last; chunks of states split in threads
    (LAPACK releases the interpreter lock)."""
    if d < 2:
        raise ValueError("d must be at least 2")
    values = sine_values(modes, amps, d)
    parts = [values[i:i + chunk] for i in range(0, len(values), chunk)]
    with ThreadPoolExecutor(min(len(parts), os.cpu_count() or 1)) as pool:
        split = list(pool.map(lambda v: _split(v, d), parts))
    return [np.concatenate([s[k] for s in split]) for k in range(d)]


def sine_states(modes, amps, d: int, R: int, dtype, device) -> torch.Tensor:
    """Padded ``(S, d, R, 2, R)`` stack of the states on ``device``; needs
    ``R >= 2^(d // 2)``, the largest feasible rank."""
    if R < 2 ** (d // 2):
        raise ValueError(f"buffer rank {R} is under the feasible rank "
                         f"{2 ** (d // 2)} of d = {d}")
    cores = sine_cores(np.asarray(modes), amps, d)
    out = torch.zeros((len(modes), d, R, 2, R), dtype=dtype, device=device)
    for k, c in enumerate(cores):
        out[:, k, :c.shape[1], :, :c.shape[3]] = torch.from_numpy(c).to(
            device, dtype)
    return out
