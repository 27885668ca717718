"""TT-cross on complex domains: MaxVol on a complex exponential, DMRG cross
on a non-separable function and the complex 5-D Wishart Laplace transform,
on PyTorch (the twin of examples/complex_cross.py). The cross runs on the
host, as in the JAX package; the cores land on the device.

Run: python examples_torch/complex_cross.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from ttnx_torch import DMRG, MaxVol, tt_cross
from ttnx_torch.config import script_device
from ttnx_torch.cross.cross import _evaluate_tt

dev = script_device()
rng = np.random.default_rng(20260)


def validate(tt, domain, f, nsamp=400):
    n = len(domain[0])
    d = len(domain)
    idx = np.stack([rng.integers(0, n, nsamp) for _ in range(d)], axis=1)
    X = np.stack([np.asarray(domain[k])[idx[:, k]] for k in range(d)], axis=1)
    y = np.asarray(f(X)).reshape(-1)
    yhat = _evaluate_tt([c.cpu().numpy() for c in tt.cores], idx)
    return float(np.linalg.norm(y - yhat) / max(np.linalg.norm(y), 1e-14))


# --- 1. MaxVol on a complex domain -----------------------------------------
d, n = 3, 7
base = np.linspace(0.0, 1.2, n)
imag_axis = np.linspace(-0.4, 0.4, n)
domain = [base + 1j * imag_axis for _ in range(d)]
f1 = lambda X: np.exp(X[:, 0] + 0.6 * X[:, 1] - 0.2 * X[:, 2])  # noqa: E731
tt1 = tt_cross(f1, domain, MaxVol(tol=1e-8, maxiter=20, rmax=40, kickrank=2),
               ranks=2, val_size=1200, device=dev)
rel1 = validate(tt1, domain, f1)
print(f"MaxVol complex exponential: ranks {tt1.ranks}, rel L2 {rel1:.2e}")
assert rel1 < 1e-8

# --- 2. DMRG cross on a complex domain -------------------------------------
d, n = 4, 6
t = np.linspace(-1.0, 1.0, n)
domain = [0.4 * ((k + 1) * t) + 1j * (0.3 * t) for k in range(d)]


def f2(X):
    z = X[:, 0] + 1.7 * X[:, 1]
    return np.sin(z) * np.exp(-0.4 * X[:, 2]) + 0.3 / (1 + X[:, 3])


tt2 = tt_cross(f2, domain, DMRG(tol=1e-8, maxiter=18, rmax=50),
               ranks=2, val_size=1200, device=dev)
rel2 = validate(tt2, domain, f2)
print(f"DMRG complex non-separable:  ranks {tt2.ranks}, rel L2 {rel2:.2e}")
assert rel2 < 1e-6

# --- 3. Complex 5-D Wishart Laplace transform ------------------------------
d = 5
nu = d + 2
p = nu / 2
Sigma = np.array([
    [1.0, 0.3, 0.2, 0.1, 0.18],
    [0.3, 1.2, 0.25, 0.15, 0.22],
    [0.2, 0.25, 0.9, 0.2, 0.28],
    [0.1, 0.15, 0.2, 1.1, 0.19],
    [0.18, 0.22, 0.28, 0.19, 1.05]])
assert np.all(np.linalg.eigvalsh(Sigma) > 0)
sigma = 2.0 * Sigma


def f3(X):
    out = np.empty(X.shape[0], dtype=np.complex128)
    for i in range(X.shape[0]):
        out[i] = np.linalg.det(
            np.eye(d, dtype=np.complex128) + sigma * np.diag(X[i])) ** (-p)
    return out


n = 6
re_axis = np.linspace(0.0, 1.0, n)
im_axis = np.linspace(-0.35, 0.35, n)
domain = [re_axis + 1j * im_axis for _ in range(d)]
tt3 = tt_cross(f3, domain, MaxVol(tol=6e-6, maxiter=25, rmax=70, kickrank=2),
               ranks=2, val_size=2000, device=dev)
rel3 = validate(tt3, domain, f3, nsamp=500)
print(f"Complex 5-D Wishart:         ranks {tt3.ranks}, rel L2 {rel3:.2e}")
assert rel3 < 1e-4
print("complex_cross OK")
