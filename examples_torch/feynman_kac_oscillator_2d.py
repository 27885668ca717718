"""Feynman-Kac imaginary-time evolution of a coupled 2-D oscillator on a
serial QTT, checked against the normal-mode Riccati energy and the
ground-state correlation, on PyTorch (the twin of
examples/feynman_kac_oscillator_2d.py).

Run: python examples_torch/feynman_kac_oscillator_2d.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from ttnx_torch import (QTTVector, crank_nicholson_method, dot,
                        function_to_qtt, id_tto, increase_ranks, kron_tt,
                        kron_tto, laplacian, matvec, qtt_polynom,
                        qttv_to_array, ttv_to_diag_tto)
from ttnx_torch.config import script_device
from ttnx_torch.core.algebra import add_op, scale_op

dev = script_device()
a_, b_, c_ = 1.0, 2.0, 0.8           # K = [[a, c], [c, b]], positive definite
alpha = 2.0                           # isotropic initial Gaussian width
d = 7
N = 2 ** d
lo, hi = -5.0, 5.0
h = (hi - lo) / (N - 1)
xes = np.linspace(lo, hi, N)

dxx = scale_op(-1.0 / h ** 2, laplacian(d, device=dev))     # d^2/dx^2
idd = id_tto(d, device=dev)
X2 = ttv_to_diag_tto(qtt_polynom([0.0, 0.0, 1.0], d, a=lo, b=hi,
                                 device=dev))
X1 = ttv_to_diag_tto(qtt_polynom([0.0, 1.0], d, a=lo, b=hi, device=dev))
# A = 1/2 (dxx ox I + I ox dxx) - [a/2 x^2 + b/2 y^2 + c x y]
kinetic = scale_op(0.5, add_op(kron_tto(dxx, idd), kron_tto(idd, dxx)))
potential = add_op(
    add_op(scale_op(0.5 * a_, kron_tto(X2, idd)),
           scale_op(0.5 * b_, kron_tto(idd, X2))),
    scale_op(c_, kron_tto(X1, X1)))
A = add_op(kinetic, scale_op(-1.0, potential))
H = add_op(scale_op(-1.0, kinetic), potential)

K = np.array([[a_, c_], [c_, b_]])
lam, vecs = np.linalg.eigh(K)
Omega = np.sqrt(lam)
E0 = 0.5 * Omega.sum()
covGS = 0.5 * vecs @ np.diag(1.0 / Omega) @ vecs.T
rho_inf = covGS[0, 1] / np.sqrt(covGS[0, 0] * covGS[1, 1])


def beta_i(lam_i, tau):
    w = np.sqrt(lam_i)
    return w * (alpha + w * np.tanh(w * tau)) / (w + alpha * np.tanh(w * tau))


def E_riccati(tau):
    return sum(beta_i(lv, tau) / 4 + lv / (4 * beta_i(lv, tau)) for lv in lam)


def to_grid(v):
    return qttv_to_array(QTTVector(v.cores, 2, d, "serial")).cpu().numpy()


def energy(u):
    return float(torch.real(dot(u, matvec(H, u))) / torch.real(dot(u, u)))


g = function_to_qtt(
    lambda t: np.exp(-0.5 * alpha * (lo + (hi - lo) * t) ** 2), d,
    device=dev)
u = increase_ranks(kron_tt(g, g), 12, noise=1e-2,
                   generator=torch.Generator().manual_seed(42))

tau, record_dt, T = 0.05, 0.5, 3.0
block = int(round(record_dt / tau))
n_blocks = int(round(T / record_dt))
rho = 0.0
for kb in range(n_blocks):
    u = crank_nicholson_method(A, u, u, [tau] * block, normalize=False,
                               tt_solver="als")
    t_now = record_dt * (kb + 1)
    E = energy(u)
    P = to_grid(u) ** 2
    P = P / (P.sum() * h ** 2)
    mx = float(np.sum(xes * P.sum(axis=1)) * h ** 2)
    my = float(np.sum(xes * P.sum(axis=0)) * h ** 2)
    vx = float(np.sum((xes - mx) ** 2 * P.sum(axis=1)) * h ** 2)
    vy = float(np.sum((xes - my) ** 2 * P.sum(axis=0)) * h ** 2)
    cov = float(np.sum((xes[:, None] - mx) * P * (xes[None, :] - my))
                * h ** 2)
    rho = cov / np.sqrt(vx * vy)
    E_ref = E_riccati(t_now)
    print(f"tau={t_now:4.1f}  E={E:.6f}  Riccati={E_ref:.6f}  "
          f"rho={rho:+.4f}  rank={max(u.ranks)}")
    # CN is O(tau^2); the Rayleigh quotient tracks the normal-mode Riccati
    assert abs(E - E_ref) < 5e-3, (E, E_ref)

assert abs(energy(u) - E0) < 5e-3, (energy(u), E0)
assert abs(rho - rho_inf) < 0.02, (rho, rho_inf)
print(f"done; E -> {energy(u):.5f} (E0={E0:.5f}), "
      f"rho -> {rho:.4f} (analytic {rho_inf:.4f})")
