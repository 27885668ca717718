"""Ground state of the 1-D double well by imaginary-time evolution:
Crank-Nicolson with ALS and rank-adaptive TDVP2, against dense
diagonalization, on PyTorch (the twin of
examples/schrodinger_groundstate.py).

Run: python examples_torch/schrodinger_groundstate.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from ttnx_torch import (crank_nicholson_method, dot, function_to_qtt,
                        increase_ranks, laplacian, norm, qtto_to_matrix,
                        scale, ttv_to_diag_tto)
from ttnx_torch.config import script_device
from ttnx_torch.core.algebra import add_op, matvec, scale_op
from ttnx_torch.solvers.tdvp import tdvp2

dev = script_device()
lam, xa = 0.2, 2.0
d = 8
N = 2 ** d
a, b = -5.0, 5.0
h = (b - a) / (N - 1)
xes = np.linspace(a, b, N)

dxx = scale_op(-1.0 / h ** 2, laplacian(d, device=dev))  # = d2/dx2
Vop = ttv_to_diag_tto(function_to_qtt(
    lambda t: lam * ((a + (b - a) * t) ** 2 - xa ** 2) ** 2, d, device=dev))
H = add_op(scale_op(-0.5, dxx), Vop)
A = scale_op(-1.0, H)

w, V = np.linalg.eigh(qtto_to_matrix(H).cpu().numpy())
E0_dense = w[0]
print(f"dense ground-state energy: {E0_dense:.8f}")

energy = lambda psi: float(torch.real(  # noqa: E731
    dot(psi, matvec(H, psi)) / dot(psi, psi)))

gauss = function_to_qtt(lambda t: np.exp(-0.5 * (a + (b - a) * t) ** 2), d,
                        device=dev)
gauss = scale(1.0 / float(norm(gauss)), gauss)

# method 1: Crank-Nicolson + ALS (fixed rank -> rank-enrich the IC)
psi = increase_ranks(gauss, 12, noise=1e-3,
                     generator=torch.Generator().manual_seed(42))
psi = scale(1.0 / float(norm(psi)), psi)
tau = 0.02
for blk in range(8):
    psi = crank_nicholson_method(A, psi, psi, [tau] * 25, normalize=True,
                                 tt_solver="als")
    print(f"  CN/ALS t={tau * 25 * (blk + 1):4.1f}  E = {energy(psi):.8f}")
print(f"CN/ALS energy error: {energy(psi) - E0_dense:.2e}")
assert abs(energy(psi) - E0_dense) < 1e-4

# method 2: TDVP2 (rank-adaptive)
psi2 = gauss
psi2 = tdvp2(A, psi2, [tau] * 200, imaginary_time=True, normalize=True,
             max_bond=16, truncerr=1e-10)
print(f"TDVP2 energy error: {energy(psi2) - E0_dense:.2e} "
      f"(max rank {max(psi2.ranks)})")
assert abs(energy(psi2) - E0_dense) < 1e-4
