"""A forced harmonic oscillator as a 4-state linear system: TT-RK4 on a
2-site MPO against dense RK4, on PyTorch (the twin of
examples/harmonic_oscillator_rk4.py).

Run: python examples_torch/harmonic_oscillator_rk4.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from ttnx_torch import rk4_method, tto_decomp, ttv_decomp, ttv_to_tensor
from ttnx_torch.config import script_device

dev = script_device()
omega0 = 1.5   # natural frequency
C = 2.0        # forcing amplitude coupling
nu = 1.7       # forcing frequency
x0, v0 = 5.0, 0.0
u0_dense = np.array([x0, v0, 0.0, 1.0])
A_dense = np.array([
    [0.0, 1.0, 0.0, 0.0],
    [-(omega0 ** 2), 0.0, C, 0.0],
    [0.0, 0.0, 0.0, nu],
    [0.0, 0.0, -nu, 0.0]])


def rk4_step(A, u, dt):
    k1 = A @ u
    k2 = A @ (u + dt / 2 * k1)
    k3 = A @ (u + dt / 2 * k2)
    k4 = A @ (u + dt * k3)
    return u + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


T, dt, max_bond = 50.0, 0.15, 15
# the 4x4 generator as a 2-site MPO, the 4-state as a 2-site TT
A = tto_decomp(A_dense.reshape(2, 2, 2, 2), device=dev)
psi = ttv_decomp(u0_dense.reshape(2, 2), device=dev)

t = np.arange(0.0, T + dt / 2, dt)
u_dense = u0_dense.copy()
x_dense = [u_dense[0]]
x_tt = [u0_dense[0]]
for _ in range(1, len(t)):
    u_dense = rk4_step(A_dense, u_dense, dt)
    psi = rk4_method(A, psi, [dt], max_bond, normalize=False)
    x_dense.append(u_dense[0])
    x_tt.append(float(ttv_to_tensor(psi).reshape(-1)[0]))

rel = np.linalg.norm(np.array(x_tt) - np.array(x_dense)) / np.linalg.norm(
    np.array(x_dense))
print(f"forced oscillator over T={T}: TT-RK4 vs dense-RK4 rel err {rel:.3e}")
assert rel < 1e-10
# the forced response must actually oscillate (not decay to zero)
assert np.max(np.abs(x_tt[len(t) // 2:])) > 1.0
print("harmonic_oscillator_rk4 OK")
