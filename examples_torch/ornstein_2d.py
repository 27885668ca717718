"""2-D Ornstein-Uhlenbeck Fokker-Planck equation on a serial QTT: the
density relaxes monotonically to the product Gaussian, on PyTorch (the
twin of examples/ornstein_2d.py).

Run: python examples_torch/ornstein_2d.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from ttnx_torch import (QTTVector, crank_nicholson_method, function_to_qtt,
                        gradient, id_tto, kron_tt, kron_tto, laplacian,
                        matmul, qtt_polynom, qttv_to_array, shift,
                        ttv_to_diag_tto)
from ttnx_torch.config import script_device
from ttnx_torch.core.algebra import add_op, scale, scale_op

dev = script_device()
theta = 1.0
mu_x, mu_y = 2.0, -2.0
sigma = 1.0
D = sigma ** 2 / 2
d = 8
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
# A = theta [ (dx Mx) ox I + I ox (dx My) ] + D [ dxx ox I + I ox dxx ]
A = add_op(
    scale_op(theta, add_op(kron_tto(matmul(dx, Mx), idd),
                           kron_tto(idd, matmul(dx, My)))),
    scale_op(D, add_op(kron_tto(dxx, idd), kron_tto(idd, dxx))))


def to_grid(v):
    return qttv_to_array(QTTVector(v.cores, 2, d, "serial")).cpu().numpy()


def mass(P):
    return float(np.sum(P) * h ** 2)


g = function_to_qtt(lambda t: np.exp(-((a + (b - a) * t) ** 2) / 2), d,
                    device=dev)
u0 = kron_tt(g, g)
u0 = scale(1.0 / mass(to_grid(u0)), u0)

var_inf = D / theta
g1 = lambda x, m: np.exp(-((x - m) ** 2) / (2 * var_inf)) / np.sqrt(  # noqa
    2 * np.pi * var_inf)
P_inf = g1(xes[:, None], mu_x) * g1(xes[None, :], mu_y)

tau, record_dt, T = 0.02, 0.5, 2.0
block = int(round(record_dt / tau))
n_blocks = int(round(T / record_dt))
psi = u0
prev_err = np.inf
for k in range(n_blocks):
    psi = crank_nicholson_method(A, psi, psi, [tau] * block,
                                 normalize=False, tt_solver="als")
    P = to_grid(psi)
    P = P / mass(P)
    errL2 = float(np.sqrt(np.sum((P - P_inf) ** 2) * h ** 2))
    print(f"t={record_dt * (k + 1):4.1f}  L2 err to stationary: {errL2:.4e}"
          f"  max rank: {max(psi.ranks)}")
    assert errL2 < prev_err, "density stopped converging to the fixed point"
    prev_err = errL2
print("done; 2-D density drifting to the product Gaussian at "
      f"({mu_x}, {mu_y})")
