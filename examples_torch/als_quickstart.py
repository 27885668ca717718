"""README quick-start: solve A x = b with ALS at fixed ranks, on PyTorch
(the twin of examples/als_quickstart.py).

Run: python examples_torch/als_quickstart.py  (on cuda:0; add
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
d = 6
A = tx.id_tto(d, device=dev)
b = tx.qtt_sin(d, device=dev)
x0 = tx.rand_tt(torch.Generator().manual_seed(0), (2,) * d, rmax=4,
                normalise=True).to(dev)

x = tx.als_linsolve(A, b, x0, sweep_count=4)

sol = tx.qtt_to_vector(x).cpu().numpy()
ref = tx.qtt_to_vector(b).cpu().numpy()
rel = np.linalg.norm(sol - ref) / np.linalg.norm(ref)
print(f"relative error: {rel:.3e}")           # ~1e-16
assert rel < 1e-12

# the same solve through the scan tier (the env-chain and local-solve
# kernels on the card)
from ttnx_torch.solvers.als_scan import als_linsolve_scan

x2 = als_linsolve_scan(A, b, x0, sweep_count=4)
rel2 = (np.linalg.norm(tx.qtt_to_vector(x2).cpu().numpy() - ref)
        / np.linalg.norm(ref))
print(f"scan-path relative error: {rel2:.3e}")
assert rel2 < 1e-12
