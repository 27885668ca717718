"""DMRG quick start: an SPD linear solve and a staged XXZ eigensolve with a
rank schedule, on PyTorch (the twin of examples/dmrg_quickstart.py).

Run: python examples_torch/dmrg_quickstart.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import ttnx_torch as tx
from ttnx_torch import dmrg_eigsolve, dmrg_linsolve, rand_tt, xxz_tto
from ttnx_torch.config import script_device
from ttnx_torch.core.algebra import add_op, matmul, matvec, norm, sub

dev = script_device()


def gen(seed):
    return torch.Generator().manual_seed(seed)


d = 3

# --- linear solve with an SPD operator A = B^T B + I -----------------------
B = tx.rand_tto(gen(1), (2,) * d, rmax=2).to(dev)
A = add_op(matmul(B.transpose(), B), tx.id_tto(d, device=dev))
b = rand_tt(gen(2), (2,) * d, rmax=2).to(dev)
x0 = rand_tt(gen(3), (2,) * d, rmax=2).to(dev)
x = dmrg_linsolve(A, b, x0, n_sites=2, tol=1e-12)
res = float(norm(sub(matvec(A, x), b)) / norm(b))
print(f"DMRG linsolve residual: {res:.3e}")
assert res < 1e-10

# --- staged eigensolve: sweep_schedule + rmax_schedule ----------------------
d = 6
H = xxz_tto(d, delta=0.7, h=0.3, device=dev)
x0 = rand_tt(gen(0), (2,) * d, rmax=2, normalise=True).to(dev)
E, gs, r_hist = dmrg_eigsolve(H, x0, n_sites=2, tol=1e-12,
                              sweep_schedule=[2, 4], rmax_schedule=[4, 10])
dense = tx.tto_to_tensor(H).reshape(2 ** d, 2 ** d).cpu().numpy()
e_exact = np.linalg.eigvalsh(0.5 * (dense + dense.T)).min()
print(f"XXZ d={d}: DMRG E0={float(E[-1]):.10f}  dense E0={e_exact:.10f}  "
      f"rank history {r_hist}")
assert abs(float(E[-1]) - e_exact) < 1e-8
# the staged schedule grows ranks: history ends at the widest stage
assert max(r_hist) == 10 or max(r_hist) >= 8
print("dmrg_quickstart OK")
