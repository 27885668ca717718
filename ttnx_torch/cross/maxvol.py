"""Maxvol pivot selection (quasi-maximum-volume submatrix) on the host.

Twin of ``ttnx.cross.maxvol``: the Goreinov–Tyrtyshnikov row-swap
iteration with an LU partial-pivot start and rank-1 coefficient updates,
in numpy and scipy. The host cross (:mod:`ttnx_torch.cross.cross`) calls
it; the device cross has its own batched form,
:func:`ttnx_torch.cross.device.maxvol_fixed`.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

__all__ = ["maxvol"]


def maxvol(a: np.ndarray, tol: float = 1.05, maxiter: int = 100) -> np.ndarray:
    """Return row indices of an ``r x r`` quasi-dominant submatrix of the tall
    ``n x r`` matrix ``a`` (``n >= r``). Iterates row swaps until every entry
    of ``a @ inv(a[rows])`` is below ``tol`` in modulus or ``maxiter`` swaps.
    """
    a = np.asarray(a)
    n, r = a.shape
    if n <= r:
        return np.arange(n)
    # initialize with LU partial-pivot rows of the rectangular matrix
    p, _, _ = scipy.linalg.lu(a, p_indices=True)
    rows = np.array(sorted(p[:r]))
    try:
        b = a @ np.linalg.solve(a[rows], np.eye(r, dtype=a.dtype))
    except np.linalg.LinAlgError:
        b = a @ np.linalg.pinv(a[rows])
    for _ in range(maxiter):
        flat = np.argmax(np.abs(b))
        i, j = divmod(flat, r)
        if np.abs(b[i, j]) <= tol:
            break
        # swap row rows[j] <- i, rank-1 update of b
        bj = b[:, j].copy()
        bi = b[i, :].copy()
        bi[j] -= 1.0
        b -= np.outer(bj, bi) / b[i, j]
        rows[j] = i
    return rows
