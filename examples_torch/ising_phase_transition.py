"""Transverse-field Ising phase transition: periodic-boundary Hamiltonian,
scan-tier DMRG ground states across a field sweep, and the absolute Z
magnetization as the order parameter, on PyTorch (the twin of
examples/ising_phase_transition.py).

H(g) = -(sum_i Z_i Z_{i+1} + Z_d Z_1) - g * sum_i X_i

The magnetization drops from ~1 (ferromagnet, g << 1) toward ~the
paramagnetic plateau past the g = 1 critical point.

Run: python examples_torch/ising_phase_transition.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import ttnx_torch as tx
from ttnx_torch.config import script_device
from ttnx_torch.solvers.dmrg_scan import dmrg_eigsolve_scan

dev = script_device()
d = 10
g_values = [0.0, 0.5, 1.0, 1.5, 2.0]


def pauli_product_tto(factors: dict, d: int) -> tx.TTOperator:
    """Rank-1 MPO placing the given Pauli matrix at each keyed site and
    identity elsewhere (the periodic closing bond)."""
    eye = np.eye(2)
    cores = []
    for site in range(d):
        m = tx.pauli_matrix(factors[site]) if site in factors else eye
        cores.append(torch.as_tensor(np.asarray(m).reshape(1, 2, 2, 1),
                                     dtype=torch.float64, device=dev))
    return tx.TTOperator(cores)


def periodic_tfi_tto(d: int, g: float) -> tx.TTOperator:
    zz_open = tx.pauli_pair_sum_tto("z", "z", d, device=dev)
    zz_boundary = pauli_product_tto({0: "z", d - 1: "z"}, d)
    return ((-1.0) * (zz_open + zz_boundary)
            + (-g) * tx.pauli_sum_tto("x", d, device=dev))


def abs_z_magnetization(state: tx.TTVector) -> float:
    """sum_b p_b * |m_b| with m_b the mean spin of basis state b — robust to
    the two-fold ground-state degeneracy at small g (a cat state has zero
    signed magnetization but unit absolute magnetization)."""
    amps = tx.ttv_to_tensor(state).reshape(-1).cpu().numpy()
    p = np.abs(amps) ** 2
    p /= p.sum()
    d = state.N
    bits = ((np.arange(p.size)[:, None] >> np.arange(d - 1, -1, -1)) & 1)
    m = np.abs((1.0 - 2.0 * bits).mean(axis=1))
    return float((p * m).sum())


x0 = tx.rand_tt(torch.Generator().manual_seed(0), (2,) * d, rmax=2,
                normalise=True, orthogonal=True).to(dev)

print(f"periodic transverse-field Ising, d={d}")
mags = []
for g in g_values:
    H = periodic_tfi_tto(d, g)
    E, psi = dmrg_eigsolve_scan(H, x0, tol=1e-10, rmax=12, n_sweeps=4,
                                lanczos_iters=30)
    m = abs_z_magnetization(psi)
    mags.append(m)
    print(f"  g={g:4.1f}  E0={float(E[-1]):+.10f}  |m|={m:.6f} "
          f"(max rank {max(psi.ranks)})")

assert mags[0] > 0.999, "g=0 ground state must be fully polarized"
assert mags[-1] < 0.45, "deep paramagnet must have small |m|"
assert all(a >= b - 1e-9 for a, b in zip(mags, mags[1:])), \
    "|m| must decrease monotonically with g"

# cross-check the g=1 critical-point energy against dense diagonalization
H1 = periodic_tfi_tto(d, 1.0)
E1, _ = dmrg_eigsolve_scan(H1, x0, tol=1e-12, rmax=20, n_sweeps=6,
                           lanczos_iters=40)
w = np.linalg.eigvalsh(tx.qtto_to_matrix(H1).cpu().numpy())
print(f"g=1.0: DMRG {float(E1[-1]):.10f} vs dense {w[0]:.10f}")
assert abs(float(E1[-1]) - w[0]) < 1e-7
print("OK")
