"""2-D Ornstein-Uhlenbeck Fokker-Planck equation with a coupled drift: the
density builds the Lyapunov covariance and the correlation k/theta, on
PyTorch (the twin of examples/ornstein_2d_coupled.py).

Run: python examples_torch/ornstein_2d_coupled.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from ttnx_torch import (QTTVector, crank_nicholson_method, function_to_qtt,
                        gradient, id_tto, increase_ranks, kron_tt, kron_tto,
                        laplacian, matmul, qtt_polynom, qttv_to_array, shift,
                        ttv_to_diag_tto)
from ttnx_torch.config import script_device
from ttnx_torch.core.algebra import add_op, scale, scale_op

dev = script_device()
theta = 1.0
k = 0.6                      # drift coupling; rho_inf = k / theta = 0.6
mu_x, mu_y = 2.0, -2.0
sigma = 1.0
D = sigma ** 2 / 2
Theta = np.array([[theta, -k], [-k, theta]])
Sigma_inf = D * np.linalg.inv(Theta)   # analytic Lyapunov solution

d = 7
N = 2 ** d
a, b = -6.0, 6.0
h = (b - a) / (N - 1)
xes = np.linspace(a, b, N)

dx = scale_op(1.0 / (2 * h),
              add_op(shift(d, device=dev), scale_op(-1.0, add_op(
                  id_tto(d, device=dev),
                  scale_op(-1.0, gradient(d, device=dev))))))
dxx = scale_op(-1.0 / h ** 2, laplacian(d, device=dev))
idd = id_tto(d, device=dev)
Mx = ttv_to_diag_tto(qtt_polynom([-mu_x, 1.0], d, a=a, b=b, device=dev))
My = ttv_to_diag_tto(qtt_polynom([-mu_y, 1.0], d, a=a, b=b, device=dev))
# A = theta [(dx Mx) ox I + I ox (dx My)] - k [dx ox My + Mx ox dx]
#     + D [dxx ox I + I ox dxx]
A = add_op(
    add_op(
        scale_op(theta, add_op(kron_tto(matmul(dx, Mx), idd),
                               kron_tto(idd, matmul(dx, My)))),
        scale_op(-k, add_op(kron_tto(dx, My), kron_tto(Mx, dx)))),
    scale_op(D, add_op(kron_tto(dxx, idd), kron_tto(idd, dxx))))


def to_grid(v):
    return qttv_to_array(QTTVector(v.cores, 2, d, "serial")).cpu().numpy()


def mass(P):
    return float(np.sum(P) * h ** 2)


def moments(P):
    mx = float(np.sum(xes * P.sum(axis=1)) * h ** 2)
    my = float(np.sum(xes * P.sum(axis=0)) * h ** 2)
    vx = float(np.sum((xes - mx) ** 2 * P.sum(axis=1)) * h ** 2)
    vy = float(np.sum((xes - my) ** 2 * P.sum(axis=0)) * h ** 2)
    cov = float(np.sum((xes[:, None] - mx) * P * (xes[None, :] - my))
                * h ** 2)
    return mx, my, vx, vy, cov


# product-Gaussian IC (uncorrelated), rank-enriched so ALS can build the
# correlation the coupled drift creates
g = function_to_qtt(lambda t: np.exp(-((a + (b - a) * t) ** 2) / 2), d,
                    device=dev)
u0 = increase_ranks(kron_tt(g, g), 12, noise=1e-2,
                    generator=torch.Generator().manual_seed(42))
u0 = scale(1.0 / mass(to_grid(u0)), u0)

Si = np.linalg.inv(Sigma_inf)
nrm = 1.0 / (2 * np.pi * np.sqrt(np.linalg.det(Sigma_inf)))
dxv = xes[:, None] - mu_x
dyv = xes[None, :] - mu_y
P_inf = nrm * np.exp(-0.5 * (Si[0, 0] * dxv ** 2
                             + 2 * Si[0, 1] * dxv * dyv
                             + Si[1, 1] * dyv ** 2))

tau, record_dt, T = 0.05, 0.5, 4.0
block = int(round(record_dt / tau))
n_blocks = int(round(T / record_dt))
psi = u0
prev_err = np.inf
rho = 0.0
for kb in range(n_blocks):
    psi = crank_nicholson_method(A, psi, psi, [tau] * block,
                                 normalize=False, tt_solver="als")
    P = to_grid(psi)
    P = P / mass(P)
    mx, my, vx, vy, cov = moments(P)
    rho = cov / np.sqrt(vx * vy)
    errL1 = float(np.sum(np.abs(P - P_inf)) * h ** 2)
    print(f"t={record_dt * (kb + 1):4.1f}  L1 err: {errL1:.4e}  "
          f"rho: {rho:+.4f}  max rank: {max(psi.ranks)}")
    assert errL1 < prev_err + 1e-12, "density stopped converging"
    prev_err = errL1

# the coupling built the analytic correlation and covariance
assert abs(rho - k / theta) < 0.05, f"rho={rho} != {k / theta}"
P = to_grid(psi)
P = P / mass(P)
mx, my, vx, vy, cov = moments(P)
cov_num = np.array([[vx, cov], [cov, vy]])
assert np.allclose([mx, my], [mu_x, mu_y], atol=0.05)
assert np.max(np.abs(cov_num - Sigma_inf)) < 0.08, (cov_num, Sigma_inf)
print(f"done; correlation rho={rho:.3f} -> k/theta={k / theta}, "
      f"covariance matches the Lyapunov solution")
