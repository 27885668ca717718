"""Variational implicit time stepping for viscous Burgers in QTT, on PyTorch
(the twin of examples/burgers_variational.py).

Each implicit-Euler step minimizes the squared residual

    J(u) = 0.5 * dx * dt * || (u - v)/dt + 0.5*Dx(u*u) + nu*Dxx u ||^2

over the TT cores of u. The cost is a function of a list of leaf cores, and
autograd delivers the exact gradient through the Hadamard square, the MPO
applications and the TT inner product; torch.optim.Adam steps the cores
(eager: one optimizer step is a sequence of launches, not one program).

Validation: dense Newton on the identical discretization (operator matrices
taken from the same QTT stencils via qtto_to_matrix).

Run: python examples_torch/burgers_variational.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import ttnx_torch as tx
from ttnx_torch.config import script_device

dev = script_device()
d = 6
L, T_final, nu = 1.0, 0.2, 0.05
n_steps = 10
N = 2 ** d
dx = L / N
dt = T_final / n_steps

Dx = (1.0 / dx) * tx.gradient(d, device=dev)          # forward difference
Dxx = (1.0 / dx ** 2) * tx.laplacian_DN(d, device=dev)  # -d^2/dx^2 (D-N)

u0 = tx.qtt_sin(d, lam=0.5, device=dev)     # sin(pi x / 2) on [0, 1]
max_bond = 8                                 # full feasible rank at d=6


def residual_tt(u: tx.TTVector, v: tx.TTVector) -> tx.TTVector:
    nl = 0.5 * (Dx @ tx.hadamard(u, u))
    return (1.0 / dt) * (u - v) + nl + nu * (Dxx @ u)


def cost(cores, v: tx.TTVector):
    r = residual_tt(tx.TTVector(cores), v)
    return 0.5 * dx * dt * torch.real(tx.dot(r, r))


# dense Newton reference on the same discretization
Dx_m = tx.qtto_to_matrix(Dx).cpu().numpy()
Dxx_m = tx.qtto_to_matrix(Dxx).cpu().numpy()


def dense_step(v: np.ndarray) -> np.ndarray:
    u = v.copy()
    for _ in range(30):
        F = (u - v) / dt + 0.5 * Dx_m @ (u * u) + nu * Dxx_m @ u
        Jm = np.eye(N) / dt + Dx_m * u[None, :] + nu * Dxx_m
        du = np.linalg.solve(Jm, -F)
        u = u + du
        if np.linalg.norm(du) < 1e-13:
            break
    return u


v = tx.increase_ranks(u0, max_bond, noise=1e-6,
                      generator=torch.Generator().manual_seed(0))
v_dense = tx.qtt_to_function(u0).cpu().numpy()

for k in range(n_steps):
    cores = [c.clone().requires_grad_() for c in v.cores]
    opt = torch.optim.Adam(cores, lr=2e-3)
    for _ in range(600):
        opt.zero_grad()
        val = cost(cores, v)
        val.backward()
        opt.step()
    v = tx.tt_round(tx.TTVector([c.detach() for c in cores]),
                    max_bond=max_bond)
    v_dense = dense_step(v_dense)
    rel = (np.linalg.norm(tx.qtt_to_function(v).cpu().numpy() - v_dense)
           / np.linalg.norm(v_dense))
    print(f"t={dt * (k + 1):5.3f}  J={float(val.detach()):.3e}  "
          f"rel err vs dense Newton {rel:.3e}")

assert rel < 2e-3, "variational QTT solution must track dense Newton"
# viscosity + outflow keep the solution bounded by the initial profile
assert np.max(np.abs(v_dense)) <= 1.0 + 1e-8
print("OK")
