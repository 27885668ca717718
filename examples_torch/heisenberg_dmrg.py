"""Heisenberg XXX chain ground state by staged DMRG against dense
diagonalization, with the bond entanglement entropies, on PyTorch (the twin
of examples/heisenberg_dmrg.py).

Run: python examples_torch/heisenberg_dmrg.py  (on cuda:0; add
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
d = 10
H = tx.heisenberg_xyz_tto(d, jx=1.0, jy=1.0, jz=1.0, device=dev)
x0 = tx.rand_tt(torch.Generator().manual_seed(0), (2,) * d, rmax=2,
                normalise=True, orthogonal=True).to(dev)
E, psi, r_hist = tx.dmrg_eigsolve(H, x0, sweep_schedule=[2, 5],
                                  rmax_schedule=[8, 24], tol=1e-12)
E_last = float(E[-1])
print(f"DMRG ground-state energy: {E_last:.12f}  (max rank {max(psi.ranks)})")

w = np.linalg.eigvalsh(tx.qtto_to_matrix(H).cpu().numpy())
print(f"dense diagonalization:    {w[0]:.12f}")
print(f"energy error:             {abs(E_last - w[0]):.3e}")
assert abs(E_last - w[0]) < 1e-8, \
    "DMRG energy must match dense diagonalization"

entropy = tx.entanglement_entropy(psi)
print("entanglement entropy per bond:", np.round(entropy, 4))
