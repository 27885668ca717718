"""3-D interpolation of 1/|x - c| by black-box TT-cross on the
one-(x,y,z)-bit-per-site train, split into an interleaved QTT and reordered,
plus the multiscale QTT-cross of 1/x, on PyTorch (the twin of
examples/interpolation_3d.py).

Run: python examples_torch/interpolation_3d.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

import ttnx_torch as tx
from ttnx_torch import (MaxVol, QTTVector, function_to_qttv, qttv_to_array,
                        reorder, to_qtt, tt_cross)
from ttnx_torch.config import script_device

dev = script_device()
eps = 0.01
numbits = 5
n_grid = 2 ** numbits
h = 1.0 / (n_grid - 1)


def f3d(x, y, z):
    return 1.0 / np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2
                         + (z - 0.5) ** 2 + eps)


# --- black-box cross on the one-(x,y,z)-bit-per-site train ------------------
# site k carries the k-th bit of all three coordinates: physical dim 8,
# big-endian within each coordinate (site 0 = MSB) — the interleaved layout.
def f_indices(idx):
    idx = np.asarray(idx).astype(np.int64)      # (m, numbits) in 0..7
    bits = np.stack([(idx >> s) & 1 for s in (2, 1, 0)], axis=-1)
    weights = (2.0 ** -(1 + np.arange(numbits)))[None, :, None]
    xyz = (bits * weights).sum(axis=1) * (2 ** numbits) / (2 ** numbits - 1)
    return f3d(xyz[:, 0], xyz[:, 1], xyz[:, 2])


tt8 = tt_cross(f_indices, [np.arange(8)] * numbits, MaxVol(tol=1e-10),
               ranks=12, device=dev)
print("cross train dims:", tt8.dims, " ranks:", tt8.ranks)

# --- split each 8-leg into 2x2x2 QTT bits -> interleaved QTT ---------------
ttv_split = to_qtt(tt8, [[2, 2, 2]] * numbits, threshold=1e-12)
q_il = QTTVector(ttv_split.cores, 3, numbits, "interleaved")
q_sr = reorder(q_il, "serial")
arr_il = qttv_to_array(q_il).cpu().numpy()
arr_sr = qttv_to_array(q_sr).cpu().numpy()
assert np.max(np.abs(arr_il - arr_sr)) < 1e-8

# --- against native dense-sampled construction ------------------------------
q_native_sr = function_to_qttv(
    lambda c: f3d(c[..., 0], c[..., 1], c[..., 2]), 3, numbits,
    ordering="serial", device=dev)
arr_native = qttv_to_array(q_native_sr).cpu().numpy()

rng = np.random.default_rng(0)
max_err_cross = 0.0
max_err_native = 0.0
for _ in range(500):
    ix, iy, iz = rng.integers(0, n_grid, 3)
    val = f3d(ix * h, iy * h, iz * h)
    max_err_native = max(max_err_native,
                         abs(arr_native[ix, iy, iz] - val))
    max_err_cross = max(max_err_cross, abs(arr_sr[ix, iy, iz] - val))
print(f"max |cross  - f3d| at grid pts: {max_err_cross:.3e}")
print(f"max |native - f3d| at grid pts: {max_err_native:.3e}")
assert max_err_native < 1e-10
assert max_err_cross < 1e-4 * np.max(np.abs(arr_native))
print("bond dims — cross-split serial:", q_sr.ranks)
print("bond dims — native serial:     ", q_native_sr.ranks)

# --- multiscale 1-D: singular g(x) = 1/x -----------------------------------
# cross-interpolate g directly over the bit indices of the QTT binary grid
# (site 0 = MSB), where 1/x has low QTT rank away from the singularity.
g1d = lambda x: np.where(x == 0.0, 0.0,  # noqa: E731
                         1.0 / np.maximum(x, 1e-300))
n_levels = 10


def g_bits(idx):
    idx = np.asarray(idx).astype(np.int64)      # (m, n_levels) bits
    weights = 2.0 ** -(1 + np.arange(n_levels))
    return g1d(idx @ weights)


tt_ms = tt_cross(g_bits, [np.arange(2)] * n_levels, MaxVol(tol=1e-12),
                 ranks=14, device=dev)
print("multiscale 1/x QTT-cross ranks:", tt_ms.ranks)
tt_ms_c = tx.tt_round(tt_ms, max_bond=12)
xs = np.arange(1, 2 ** n_levels) / 2 ** n_levels
vals = tx.matricize(tt_ms_c, n_levels).cpu().numpy()[1:]
rel = np.abs(vals - g1d(xs)) / np.abs(g1d(xs))
# relative accuracy away from the singular left edge (smallest 1/16 of x)
assert np.max(rel[2 ** (n_levels - 4):]) < 1e-8
print(f"compressed ranks: {tt_ms_c.ranks}; "
      f"rel err away from singularity: "
      f"{np.max(rel[2 ** (n_levels - 4):]):.2e}")
print("interpolation_3d OK")
