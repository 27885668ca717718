"""1-site (fixed rank) against 2-site (rank-adaptive) TDVP in imaginary
time, against the dense exponential, on PyTorch (the twin of
examples/tdvp_comparison.py).

Run: python examples_torch/tdvp_comparison.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import scipy.linalg

from ttnx_torch import (qtt_sin, qtt_to_vector, qtto_to_matrix, tdvp, tdvp2,
                        toeplitz_to_qtto)
from ttnx_torch.config import script_device

dev = script_device()
d = 6
N = 2 ** d
h = 1.0 / (N - 1)
A = (h ** 2) * toeplitz_to_qtto(-3.0, 5.0, 9.0, d, device=dev)
u0 = qtt_sin(d, lam=np.pi, device=dev)

dt = 1e-2
nsteps = 40
steps = [dt] * nsteps
sol1 = tdvp(A, u0, steps, imaginary_time=True, sweeps=2, normalize=True)
sol2 = tdvp2(A, u0, steps, imaginary_time=True, sweeps=1, normalize=True,
             max_bond=10)
v1 = qtt_to_vector(sol1).cpu().numpy()
v2 = qtt_to_vector(sol2).cpu().numpy()

# dense reference: normalized exp(T A) u0
M = qtto_to_matrix(A).cpu().numpy()
ref = scipy.linalg.expm(nsteps * dt * M) @ qtt_to_vector(u0).cpu().numpy()
ref /= np.linalg.norm(ref)


def aligned_err(v, ref):
    v = v / np.linalg.norm(v)
    sign = np.sign(v @ ref)
    return float(np.linalg.norm(sign * v - ref))


e1, e2 = aligned_err(v1, ref), aligned_err(v2, ref)
print(f"tdvp  (1-site, fixed rank) vs dense expm: {e1:.3e}")
print(f"tdvp2 (2-site, adaptive)   vs dense expm: {e2:.3e}")
# The gap is structural, not a tolerance: the exact flow leaves the rank-2
# manifold of u0, and 1-site TDVP cannot grow ranks through the
# near-zero singular directions (the classic TDVP rank-growth limitation),
# while the 2-site integrator adapts ranks and tracks expm to machine
# precision.
assert e2 < 1e-10, e2
assert e1 < 1e-3, e1
assert e2 < e1 / 100
print(f"tdvp2 adapted ranks: {sol2.ranks}")
print("tdvp_comparison OK")
