"""Three ways to solve kappa*Delta u = f on a QTT grid: variational gradient
descent, MALS, and a TT-valued Krylov solve, on PyTorch (the twin of
examples/variational_solver.py).

Run: python examples_torch/variational_solver.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import ttnx_torch as tx
from ttnx_torch import dot, matvec, norm, sub
from ttnx_torch.config import script_device

dev = script_device()
d = 6
kappa = 0.1
A = kappa * tx.toeplitz_to_qtto(2.0, -1.0, -1.0, d, device=dev)
f = tx.qtt_sin(d, lam=np.pi, device=dev)
x0 = tx.rand_tt(torch.Generator().manual_seed(0), f.dims, rks=f.ranks,
                normalise=True).to(dev)


def energy(u):
    # 0.5 <u, A u> - <f, u>; gradient = A u - f (A SPD)
    return (0.5 * torch.real(dot(u, matvec(A, u)))
            - torch.real(dot(f, u)))


x_gd, hist = tx.manifold_gradient_descent(energy, x0, steps=300, lr=0.4,
                                          max_bond=8)
res_gd = float(norm(sub(matvec(A, x_gd), f)) / norm(f))
print(f"gradient descent:   relative residual = {res_gd:.2e}")

x_mals = tx.mals_linsolve(A, f, x0, tol=1e-12, rmax=16)
res_mals = float(norm(sub(matvec(A, x_mals), f)) / norm(f))
print(f"mals_linsolve:      relative residual = {res_mals:.2e}")
assert res_mals < 1e-10, res_mals

x_kry = tx.krylov_linsolve(A, f, x0, krylov_solver="cg", maxiter=120,
                           krylovdim=10, rtol=1e-10, issymmetric=True,
                           isposdef=True)
res_kry = float(norm(sub(matvec(A, x_kry), f)) / norm(f))
print(f"krylov_linsolve:    relative residual = {res_kry:.2e}")
assert res_kry < 1e-5, res_kry

# unpreconditioned gradient descent on kappa*Delta stalls at the
# conditioning limit (cond ~ (2/pi h)^2 ~ 1.7e3); assert monotone descent
# only and report the energies
e_exact = float(energy(x_mals))
print(f"energies: gd {hist[-1]:.1f} vs exact {e_exact:.1f} "
      f"(steepest descent stalls on cond~2e3 — see comment)")
assert hist[-1] <= hist[0]
print("variational_solver OK")
