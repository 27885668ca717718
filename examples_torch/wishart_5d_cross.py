"""The 5-D Wishart Laplace transform det(I + sigma x)^(-p) by MaxVol
TT-cross with rank kicks, validated at random points, on PyTorch (the twin
of examples/wishart_5d_cross.py). The cross runs on the host, as in the JAX
package; the cores land on the device.

Run: python examples_torch/wishart_5d_cross.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

import ttnx_torch as tx
from ttnx_torch.config import script_device
from ttnx_torch.cross.cross import _evaluate_tt

dev = script_device()
d = 5
nu = d + 2
p = nu / 2
Sigma = np.array([
    [1.0, 0.3, 0.2, 0.1, 0.18],
    [0.3, 1.2, 0.25, 0.15, 0.22],
    [0.2, 0.25, 0.9, 0.2, 0.28],
    [0.1, 0.15, 0.2, 1.1, 0.19],
    [0.18, 0.22, 0.28, 0.19, 1.05],
])
sigma = 2 * Sigma


def f(X):
    out = np.empty(X.shape[0])
    eye = np.eye(d)
    for i in range(X.shape[0]):
        out[i] = np.linalg.det(eye + sigma * X[i][None, :]) ** (-p)
    return out


domain = [np.linspace(0.0, 2.0, 8)] * d
tt = tx.tt_cross(
    f, domain,
    tx.MaxVol(tol=1e-6, maxiter=25, rmax=60, kickrank=2, verbose=True),
    ranks=2, val_size=1500, seed=2026, device=dev)

rng = np.random.default_rng(2027)
ncheck = 200
idx = np.stack([rng.integers(0, 8, ncheck) for _ in range(d)], axis=1)
coords = np.stack([domain[k][idx[:, k]] for k in range(d)], axis=1)
ys = f(coords)
yhat = _evaluate_tt([c.cpu().numpy() for c in tt.cores], idx)
rel_l2 = np.linalg.norm(ys - yhat) / np.linalg.norm(ys)
print(f"ranks: {tt.ranks}")
print(f"validation rel-L2: {rel_l2:.3e}")
assert rel_l2 < 1e-4
