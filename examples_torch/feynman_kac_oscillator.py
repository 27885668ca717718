"""Feynman-Kac imaginary-time evolution of a 1-D harmonic oscillator from
a Gaussian, checked against the Mehler kernel and the Riccati energy, on
PyTorch (the twin of examples/feynman_kac_oscillator.py).

Run: python examples_torch/feynman_kac_oscillator.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from ttnx_torch import (crank_nicholson_method, dot, function_to_qtt,
                        laplacian, matvec, qtt_polynom, qtt_to_vector,
                        ttv_to_diag_tto)
from ttnx_torch.config import script_device
from ttnx_torch.core.algebra import add_op, scale_op

dev = script_device()
omega = 1.0   # oscillator frequency
alpha = 2.5   # initial Gaussian width (!= omega so the state relaxes)
d = 8
N = 2 ** d
a, b = -6.0, 6.0
h = (b - a) / (N - 1)
xes = np.linspace(a, b, N)

# A = 1/2 d2/dx2 - 1/2 w^2 x^2  (= -H_HO); H for the Rayleigh quotient
lap = scale_op(-1.0 / h ** 2, laplacian(d, device=dev))
V = ttv_to_diag_tto(qtt_polynom([0.0, 0.0, 0.5 * omega ** 2], d, a=a, b=b,
                                device=dev))
A = add_op(scale_op(0.5, lap), scale_op(-1.0, V))
H = add_op(scale_op(-0.5, lap), V)

u = function_to_qtt(
    lambda t: np.exp(-0.5 * alpha * (a + (b - a) * t) ** 2), d, device=dev)


def u_analytic(x, tau):
    """Mehler kernel acting on the initial Gaussian: still a Gaussian."""
    s, c = np.sinh(omega * tau), np.cosh(omega * tau)
    p = omega * c / (2 * s) + alpha / 2
    beta = omega * c / s - omega ** 2 / (2 * p * s ** 2)
    return np.sqrt(omega / (2 * s * p)) * np.exp(-0.5 * beta * x ** 2)


def beta_riccati(tau):
    t = np.tanh(omega * tau)
    return omega * (alpha + omega * t) / (omega + alpha * t)


def energy(state):
    return float(dot(state, matvec(H, state)) / dot(state, state))


tau_step, record_dt, T = 0.02, 0.2, 1.0
block = int(round(record_dt / tau_step))
n_blocks = int(round(T / record_dt))
print(f"tau=0.00  E={energy(u):.6f}  (Riccati init "
      f"{alpha/4 + omega**2/(4*alpha):.6f})")
for k in range(n_blocks):
    u = crank_nicholson_method(A, u, u, [tau_step] * block,
                               normalize=False, tt_solver="als")
    tau = record_dt * (k + 1)
    v = qtt_to_vector(u).cpu().numpy()
    errL2 = float(np.sqrt(np.sum((v - u_analytic(xes, tau)) ** 2) * h))
    beta = beta_riccati(tau)
    e_ric = beta / 4 + omega ** 2 / (4 * beta)
    print(f"tau={tau:4.2f}  E={energy(u):.6f}  Riccati={e_ric:.6f}  "
          f"L2 err vs Mehler: {errL2:.3e}  max rank: {max(u.ranks)}")

e_final = energy(u)
print(f"final energy {e_final:.6f} -> E0 = omega/2 = {0.5 * omega}")
assert abs(e_final - 0.5 * omega) < 0.05, "did not relax toward E0"
