"""Explicit and implicit Euler, Crank-Nicolson, RK4 and the Krylov
exponential integrator on a scaled diffusion generator, against the dense
exponential, on PyTorch (the twin of examples/time_steppers.py).

Run: python examples_torch/time_steppers.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import scipy.linalg
import torch

from ttnx_torch import (crank_nicholson_method, euler_method,
                        expintegrator_tt, implicit_euler_method, qtt_sin,
                        qtt_to_vector, qtto_to_matrix, rand_tt, rk4_method,
                        toeplitz_to_qtto)
from ttnx_torch.config import script_device
from ttnx_torch.core.algebra import scale_op

dev = script_device()
d = 8
N = 2 ** d
h = 1.0 / (N - 1)
# scaled diffusion generator (the reference uses A = h^2 * tridiag(-2,1,1))
A = scale_op(h ** 2, toeplitz_to_qtto(-2.0, 1.0, 1.0, d, device=dev))
u0 = qtt_sin(d, lam=np.pi, device=dev)
guess = rand_tt(torch.Generator().manual_seed(0), u0.dims,
                rks=u0.ranks).to(dev)

T, n_steps = 10.0, 50
steps = [T / n_steps] * n_steps
dense_A = qtto_to_matrix(A).cpu().numpy()
u_exact = scipy.linalg.expm(T * dense_A) @ qtt_to_vector(u0).cpu().numpy()


def rel_err(state):
    v = qtt_to_vector(state).cpu().numpy()
    return float(np.linalg.norm(v - u_exact) / np.linalg.norm(u_exact))


u_expl = euler_method(A, u0, steps, normalize=False)
u_impl = implicit_euler_method(A, u0, guess, steps, normalize=False,
                               tt_solver="als")
u_cn = crank_nicholson_method(A, u0, guess, steps, normalize=False,
                              tt_solver="mals")
u_rk4 = rk4_method(A, u0, steps, 25, normalize=False)
u_kry, info = expintegrator_tt(A, T, u0, krylov_dim=30, max_bond=16)

for name, state, tol in [
    ("explicit Euler", u_expl, 5e-3),
    ("implicit Euler", u_impl, 5e-3),
    ("Crank-Nicolson", u_cn, 1e-5),
    ("RK4", u_rk4, 1e-9),
    ("Krylov expintegrator", u_kry, 1e-9),
]:
    e = rel_err(state)
    print(f"{name:22s} rel err vs dense expm: {e:.3e}  "
          f"max rank {max(state.ranks)}")
    assert e < tol, f"{name} missed its accuracy class"

print(f"Krylov dim used: {info['krylov_dim']}, "
      f"error estimate {info['error_estimate']:.2e}")
print("all steppers agree with exp(T A) u0 at their order of accuracy")
