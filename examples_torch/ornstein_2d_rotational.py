"""2-D Ornstein-Uhlenbeck Fokker-Planck equation with a rotational drift:
the generator grows non-normal with omega while the isotropic Gaussian
stays the fixed point, on PyTorch (the twin of
examples/ornstein_2d_rotational.py).

Run: python examples_torch/ornstein_2d_rotational.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from ttnx_torch import (QTTVector, crank_nicholson_method, function_to_qtt,
                        gradient, id_tto, increase_ranks, kron_tt, kron_tto,
                        laplacian, matmul, qtt_polynom, qtto_to_matrix,
                        qttv_to_array, shift, ttv_to_diag_tto)
from ttnx_torch.config import script_device
from ttnx_torch.core.algebra import add_op, scale, scale_op

dev = script_device()
theta = 1.0
mu_x, mu_y = 2.0, -2.0
sigma = 1.0
D = sigma ** 2 / 2
var_inf = D / theta            # isotropic stationary variance
a, b = -6.0, 6.0


def generator(d, omega):
    N = 2 ** d
    h = (b - a) / (N - 1)
    dx = scale_op(1.0 / (2 * h),
                  add_op(shift(d, device=dev), scale_op(-1.0, add_op(
                      id_tto(d, device=dev),
                      scale_op(-1.0, gradient(d, device=dev))))))
    dxx = scale_op(-1.0 / h ** 2, laplacian(d, device=dev))
    idd = id_tto(d, device=dev)
    Mx = ttv_to_diag_tto(qtt_polynom([-mu_x, 1.0], d, a=a, b=b, device=dev))
    My = ttv_to_diag_tto(qtt_polynom([-mu_y, 1.0], d, a=a, b=b, device=dev))
    A = add_op(
        add_op(
            scale_op(theta, add_op(kron_tto(matmul(dx, Mx), idd),
                                   kron_tto(idd, matmul(dx, My)))),
            # antisymmetric rotational coupling omega (dx ox My - Mx ox dx)
            scale_op(omega, add_op(kron_tto(dx, My),
                                   scale_op(-1.0, kron_tto(Mx, dx))))),
        scale_op(D, add_op(kron_tto(dxx, idd), kron_tto(idd, dxx))))
    return A, h


# --- non-normality of the generator grows with omega (dense check, d=4) ----
d_spec = 4
nonnormal = []
for omega in (0.0, 1.0, 2.0):
    M = qtto_to_matrix(generator(d_spec, omega)[0]).cpu().numpy()
    nonnormal.append(float(np.linalg.norm(M - M.T)))
print("||A - A^T|| for omega = 0, 1, 2:",
      [f"{v:.2f}" for v in nonnormal])
assert nonnormal[0] < nonnormal[1] < nonnormal[2]

# --- evolution: the same isotropic fixed point for every omega -------------
d = 7
N = 2 ** d
xes = np.linspace(a, b, N)


def to_grid(v):
    return qttv_to_array(QTTVector(v.cores, 2, d, "serial")).cpu().numpy()


g1 = lambda x, m: np.exp(-((x - m) ** 2) / (2 * var_inf)) / np.sqrt(  # noqa
    2 * np.pi * var_inf)
P_inf = g1(xes[:, None], mu_x) * g1(xes[None, :], mu_y)

g = function_to_qtt(lambda t: np.exp(-((a + (b - a) * t) ** 2) / 2), d,
                    device=dev)
tau, T = 0.08, 4.8
n_steps = int(round(T / tau))
final_errs = {}
for omega in (0.0, 1.5):
    A, h = generator(d, omega)
    u = increase_ranks(kron_tt(g, g), 12, noise=1e-2,
                       generator=torch.Generator().manual_seed(7))
    u = scale(1.0 / (float(np.sum(to_grid(u))) * h ** 2), u)
    psi = crank_nicholson_method(A, u, u, [tau] * n_steps,
                                 normalize=False, tt_solver="als")
    P = to_grid(psi)
    P = P / (float(np.sum(P)) * h ** 2)
    errL1 = float(np.sum(np.abs(P - P_inf)) * h ** 2)
    mx = float(np.sum(xes * P.sum(axis=1)) * h ** 2)
    my = float(np.sum(xes * P.sum(axis=0)) * h ** 2)
    vx = float(np.sum((xes - mx) ** 2 * P.sum(axis=1)) * h ** 2)
    cov = float(np.sum((xes[:, None] - mx) * P
                       * (xes[None, :] - my)) * h ** 2)
    final_errs[omega] = errL1
    print(f"omega={omega}:  L1 err to isotropic Gaussian: {errL1:.4e}  "
          f"var_x: {vx:.4f} (target {var_inf})  cov: {cov:+.4f}")
    assert errL1 < 0.05, f"omega={omega} did not reach the fixed point"
    assert abs(vx - var_inf) < 0.05
    assert abs(cov) < 0.02, "rotational coupling must not induce correlation"
print("done; CN+ALS convergence is omega-robust and the rotation leaves the "
      "isotropic Gaussian invariant")
