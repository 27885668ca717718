"""Krylov exponential integrator + gradient-based optimization on TT states,
on PyTorch (the twin of examples/optimize_methods.py).

Run: python examples_torch/optimize_methods.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import scipy.linalg
import torch

import ttnx_torch as tx
from ttnx_torch import dot, ttv_to_tensor
from ttnx_torch.config import script_device

dev = script_device()


def dense(x):
    return ttv_to_tensor(x).reshape(-1).cpu().numpy()


d = 8
h = 1.0 / d ** 2
A = (h ** 2) * tx.toeplitz_to_qtto(-2.0, 1.0, 1.0, d, device=dev)
u0 = tx.qtt_sin(d, lam=np.pi, device=dev)

# 1) Krylov exponential integrator: exp(A) u0 vs dense expm action
sol, info = tx.expintegrator_tt(A, 1.0, u0, max_bond=16)
Ad = tx.qtto_to_matrix(A).cpu().numpy()
ref = scipy.linalg.expm(Ad) @ dense(u0)
got = dense(sol)
rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
print(f"expintegrator_tt vs dense expm: rel err = {rel:.2e}")
assert rel < 1e-8, rel


# 2) quadratic cost 0.5<x,x> - 0.5<u0,x>: minimum at x* = u0/2
def cost(x):
    return 0.5 * torch.real(dot(x, x)) - 0.5 * torch.real(dot(u0, x))


x0 = tx.rand_tt(torch.Generator().manual_seed(1), u0.dims, rks=u0.ranks,
                normalise=True).to(dev)
x_opt, history = tx.manifold_gradient_descent(cost, x0, steps=600, lr=0.5)
target = dense(0.5 * u0)
got = dense(x_opt)
rel = np.linalg.norm(got - target) / np.linalg.norm(target)
print(f"gradient descent on quadratic: rel err = {rel:.2e} "
      f"(final cost {history[-1]:.6f})")
# core-space descent on the multilinear TT map converges linearly —
# assert the energy gap instead of a tight state error
e_min = -0.125 * float(torch.real(dot(u0, u0)))
gap = (history[-1] - e_min) / abs(e_min)
print(f"energy gap above exact minimum: {gap:.2e}")
assert rel < 0.1 and gap < 5e-3, (rel, gap)
assert history[-1] <= history[0]

print("optimize_methods OK")
