"""Chebyshev polynomials T_0..T_4 as QTTs on the shifted Chebyshev-Lobatto
grid, on PyTorch (the twin of examples/chebyshev_polynomials.py).

Run: python examples_torch/chebyshev_polynomials.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

import ttnx_torch as tx
from ttnx_torch.config import script_device

dev = script_device()
d = 8
# qtt_chebyshev(n, d) encodes T_n sampled on the shifted Chebyshev-Lobatto
# grid on [0,1]
nodes, _ = tx.gauss_chebyshev_lobatto(2 ** d, shifted=True)
theta = np.arccos(np.clip(2 * np.asarray(nodes) - 1, -1, 1))
for n in range(5):
    q = tx.qtt_chebyshev(n, d, device=dev)
    got = tx.matricize(q, d).cpu().numpy()
    ref = np.cos(n * theta)
    err = np.max(np.abs(got - ref))
    print(f"T_{n}: rank={max(q.ranks)} max err={err:.2e}")
    assert err < 1e-10, (n, err)

print("chebyshev_polynomials OK")
