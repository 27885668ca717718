"""Vasicek zero-coupon bond prices from the discounted Feynman-Kac backward
equation, by Crank-Nicolson in QTT, against the closed form, on PyTorch
(the twin of examples/vasicek_bond.py).

Run: python examples_torch/vasicek_bond.py  (on cuda:0; add
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
theta, mu, sigma = 0.5, 0.05, 0.03
D = sigma ** 2 / 2
d = 8
N = 2 ** d
a, b = -0.1, 0.25  # rate grid (allows mildly negative rates)
h = (b - a) / (N - 1)
rs = np.linspace(a, b, N)

# discounted backward generator  L_FK = -theta*M*d_r + D*d_rr - X
d_r = (1.0 / (2 * h)) * (tx.shift(d, device=dev)
                         - (tx.id_tto(d, device=dev)
                            - tx.gradient(d, device=dev)))
d_rr = (-1.0 / h ** 2) * tx.laplacian(d, device=dev)
M = tx.ttv_to_diag_tto(tx.qtt_polynom([-mu, 1.0], d, a=a, b=b, device=dev))
X = tx.ttv_to_diag_tto(tx.qtt_polynom([0.0, 1.0], d, a=a, b=b, device=dev))
L_FK = (-theta) * (M @ d_r) + D * d_rr - X

# terminal payoff P(r, 0) = 1, rank-enriched so ALS can grow the profile
u0 = tx.increase_ranks(tx.function_to_qtt(lambda t: 1.0, d, device=dev), 6,
                       noise=1e-3,
                       generator=torch.Generator().manual_seed(42))


def B(tau):
    return (1 - np.exp(-theta * tau)) / theta


def A(tau):
    return ((B(tau) - tau) * (theta ** 2 * mu - sigma ** 2 / 2) / theta ** 2
            - sigma ** 2 * B(tau) ** 2 / (4 * theta))


def p_analytic(r, tau):
    return np.exp(A(tau) - B(tau) * r)


tau_step, record_dt, T = 0.05, 0.5, 2.0
blk = round(record_dt / tau_step)
nblk = round(T / record_dt)
interior = (rs >= -0.02) & (rs <= 0.18)
psi = u0
rel_errs = []
for k in range(1, nblk + 1):
    psi = tx.crank_nicholson_method(L_FK, psi, psi, [tau_step] * blk,
                                    normalize=False, tt_solver="als")
    tau = k * record_dt
    P = tx.qtt_to_function(psi).cpu().numpy()
    exact = p_analytic(rs[interior], tau)
    rel = float(np.max(np.abs(P[interior] - exact) / exact))
    rel_errs.append(rel)
    i_mu = int(np.argmin(np.abs(rs - mu)))
    print(f"tau={tau:4.1f}y  P(mu)={P[i_mu]:.6f} "
          f"(analytic {p_analytic(mu, tau):.6f})  max interior rel err "
          f"{rel:.3e}  max rank {max(psi.ranks)}")

assert max(rel_errs) < 5e-3, "QTT bond prices must track the closed form"
# bond price must be decreasing in the short rate at every maturity
Pfin = tx.qtt_to_function(psi).cpu().numpy()[interior]
assert np.all(np.diff(Pfin) < 0)
print("OK")
