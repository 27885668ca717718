"""MaxVol vs DMRG vs Greedy TT-cross on sin(x_1 + ... + x_6), on PyTorch
(the twin of examples/cross_algorithms.py).

Run: python examples_torch/cross_algorithms.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from ttnx_torch import DMRG, Greedy, MaxVol, tt_cross, ttv_to_tensor
from ttnx_torch.config import script_device

dev = script_device()
n, d = 8, 6
domain = [np.linspace(0.0, np.pi, n) for _ in range(d)]
f = lambda X: np.sin(np.sum(X, axis=1))  # noqa: E731

grids = np.meshgrid(*domain, indexing="ij")
exact = np.sin(sum(grids))

algs = {
    "MaxVol": (MaxVol(tol=1e-12), dict(ranks=4)),
    "DMRG": (DMRG(tol=1e-8, maxiter=25), dict(ranks=4)),
    "Greedy": (Greedy(tol=1e-12, maxiter=100), {}),
}
for name, (alg, kw) in algs.items():
    tt = tt_cross(f, domain, alg, device=dev, **kw)
    approx = ttv_to_tensor(tt).cpu().numpy()
    rel = np.linalg.norm(approx - exact) / np.linalg.norm(exact)
    print(f"{name:7s} ranks {tt.ranks}  rel err {rel:.3e}")
    assert rel < 1e-10, (name, rel)
    assert max(tt.ranks) <= 4

# spot checks at random indices
rng = np.random.default_rng(0)
tt = tt_cross(f, domain, MaxVol(tol=1e-12), ranks=4, device=dev)
approx = ttv_to_tensor(tt).cpu().numpy()
for _ in range(5):
    idx = tuple(rng.integers(0, n, d))
    coords = [domain[k][idx[k]] for k in range(d)]
    assert abs(approx[idx] - np.sin(sum(coords))) < 1e-10
print("cross_algorithms OK")
