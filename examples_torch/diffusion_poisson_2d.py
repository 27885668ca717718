"""2-D Poisson problem -Delta u = 2 pi^2 sin(pi x) sin(pi y) solved by DMRG
on a serial QTT, on PyTorch (the twin of examples/diffusion_poisson_2d.py).

Run: python examples_torch/diffusion_poisson_2d.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import ttnx_torch as tx
from ttnx_torch import QTToperator, QTTVector
from ttnx_torch.config import script_device

dev = script_device()
d = 6                      # 2^6 = 64 interior points per dimension
N = 2 ** d
h = 1.0 / (N + 1)
xes = h * np.arange(1, N + 1)

# discrete -laplacian = -(1/h^2)(D (x) I + I (x) D), D = tridiag(-2,1,1)
D1 = tx.toeplitz_to_qtto(-2.0, 1.0, 1.0, d, device=dev)
I1 = tx.id_tto(d, device=dev)
A_raw = (-1.0 / h ** 2) * (tx.kron_tto(D1, I1) + tx.kron_tto(I1, D1))
A = QTToperator(A_raw.cores, 2, d, "serial")

# exact solution u = sin(pi x) sin(pi y); f = 2 pi^2 u
b_raw = (2 * np.pi ** 2) * tx.kron_tt(tx.qtt_sin(d, a=h, b=1 - h, device=dev),
                                      tx.qtt_sin(d, a=h, b=1 - h, device=dev))
b = QTTVector(b_raw.cores, 2, d, "serial")

x0 = QTTVector(
    tx.rand_tt(torch.Generator().manual_seed(0), b_raw.dims, rks=b_raw.ranks,
               normalise=True).to(dev).cores, 2, d, "serial")
x_sol = tx.dmrg_linsolve(A, b, x0, sweep_schedule=[10], tol=1e-10)

sol = tx.qttv_to_array(QTTVector(x_sol.cores, 2, d, "serial")).cpu().numpy()
# discrete eigen-identity: the exact DISCRETE solution of the 5-point stencil
# for this rhs is (2 pi^2 / lam_h) sin(pi x) sin(pi y) with
# lam_h = 2*(2 - 2 cos(pi h))/h^2 (sum over the two dimensions)
lam_h = 2.0 * (2.0 - 2.0 * np.cos(np.pi * h)) / h ** 2
u_disc = (2 * np.pi ** 2 / lam_h) * np.outer(np.sin(np.pi * xes),
                                             np.sin(np.pi * xes))
rel = np.linalg.norm(sol - u_disc) / np.linalg.norm(u_disc)
print(f"DMRG 2-D Poisson: ranks={tuple(x_sol.ranks)} rel err vs discrete "
      f"exact = {rel:.2e}")
assert rel < 1e-8, rel

# and the continuum solution to discretization accuracy O(h^2)
u_cont = np.outer(np.sin(np.pi * xes), np.sin(np.pi * xes))
rel_c = np.linalg.norm(sol - u_cont) / np.linalg.norm(u_cont)
print(f"vs continuum solution: {rel_c:.2e} (O(h^2) = {h**2:.1e})")
assert rel_c < 10 * h ** 2

print("diffusion_poisson_2d OK")
