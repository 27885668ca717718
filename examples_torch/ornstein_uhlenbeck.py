"""1-D Ornstein-Uhlenbeck Fokker-Planck equation on a 2^12 QTT grid: the
density relaxes monotonically to N(mu, sigma^2/2theta), on PyTorch (the
twin of examples/ornstein_uhlenbeck.py).

Run: python examples_torch/ornstein_uhlenbeck.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from ttnx_torch import (crank_nicholson_method, function_to_qtt, gradient,
                        id_tto, laplacian, qtt_polynom, qtt_to_vector, shift,
                        ttv_to_diag_tto)
from ttnx_torch.config import script_device
from ttnx_torch.core.algebra import add_op, matmul, scale, scale_op

dev = script_device()
theta = 1.0   # mean-reversion rate
mu = 2.0      # long-term mean
sigma = 1.0   # volatility
D = sigma ** 2 / 2

d = 12
N = 2 ** d
a, b = -6.0, 8.0
h = (b - a) / (N - 1)
xes = np.linspace(a, b, N)

# d/dx: central difference from package shifts; d2/dx2 from the Laplacian
grad1 = scale_op(1.0 / (2 * h),
                 add_op(shift(d, device=dev), scale_op(-1.0, add_op(
                     id_tto(d, device=dev),
                     scale_op(-1.0, gradient(d, device=dev))))))
lap1 = scale_op(-1.0 / h ** 2, laplacian(d, device=dev))
M = ttv_to_diag_tto(qtt_polynom([-mu, 1.0], d, a=a, b=b, device=dev))
A = add_op(scale_op(theta, matmul(grad1, M)), scale_op(D, lap1))

# unit-mass Gaussian centred at 0 (sampled on the [0,1] -> [a,b] map)
mass = lambda v: float(np.sum(v) * h)  # noqa: E731
u0 = function_to_qtt(lambda t: np.exp(-((a + (b - a) * t) ** 2) / 2), d,
                     device=dev)
u0 = scale(1.0 / mass(qtt_to_vector(u0).cpu().numpy()), u0)

var_inf = D / theta
P_inf = np.exp(-((xes - mu) ** 2) / (2 * var_inf)) / np.sqrt(
    2 * np.pi * var_inf)

tau = 1e-2
T = 2.0
block = 20
n_blocks = int(T / (tau * block))
P = u0
err_hist = []
for k in range(n_blocks):
    P = crank_nicholson_method(A, P, P, [tau] * block, normalize=False,
                               tt_solver="als")
    v = qtt_to_vector(P).cpu().numpy()
    v = v / mass(v)
    errL2 = float(np.sqrt(np.sum((v - P_inf) ** 2) * h))
    err_hist.append(errL2)
    print(f"t={tau * block * (k + 1):5.2f}  L2 error to stationary: "
          f"{errL2:.4e}  max rank: {max(P.ranks)}")

assert all(b < a for a, b in zip(err_hist, err_hist[1:])), \
    "relaxation to the stationary density must be monotone"
assert err_hist[-1] < 0.2, err_hist[-1]
print("done; density should be converging to N(mu, sigma^2/2theta)")
