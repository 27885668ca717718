"""Laplace equation on the unit square with one sine boundary, by MALS and
DMRG on a serial QTT, against sin(pi x) sinh(pi (1-y)) / sinh(pi), on
PyTorch (the twin of examples/laplace_pde.py).

Run: python examples_torch/laplace_pde.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from ttnx_torch import (QTTVector, dmrg_linsolve, id_tto, kron_tt, kron_tto,
                        mals_linsolve, qtt_basis_vector, qtt_sin,
                        qttv_to_array, rand_tt, toeplitz_to_qtto)
from ttnx_torch.config import script_device
from ttnx_torch.core.algebra import add_op, scale, scale_op

dev = script_device()
d = 7                       # 2^d interior points per dimension
N = 2 ** d
h = 1.0 / (N + 1)           # interior spacing, zero Dirichlet ghost points
xes = h * np.arange(1, N + 1)

# interior-only 2-D Laplacian: the u=0 ghost values drop out of the stencil
lap1d = toeplitz_to_qtto(-2.0, 1.0, 1.0, d, device=dev)
idd = id_tto(d, device=dev)
A = scale_op(1.0 / h ** 2,
             add_op(kron_tto(lap1d, idd), kron_tto(idd, lap1d)))

# bottom boundary u(x, 0) = sin(pi x) contributes -sin(pi x_i)/h^2 at y = h
b = scale(-1.0 / h ** 2,
          kron_tt(qtt_sin(d, a=h, b=1 - h, lam=1.0, device=dev),
                  qtt_basis_vector(d, 0, device=dev)))

x0 = rand_tt(torch.Generator().manual_seed(0), b.dims, rks=b.ranks).to(dev)
x_mals = mals_linsolve(A, b, x0)
x_dmrg = dmrg_linsolve(A, b, x0, sweep_schedule=[10], rmax_schedule=[40],
                       tol=1e-12)

u_exact = (np.sin(np.pi * xes)[:, None]
           * np.sinh(np.pi * (1 - xes))[None, :] / np.sinh(np.pi))
for name, sol in [("MALS (1 sweep)", x_mals), ("DMRG", x_dmrg)]:
    grid = qttv_to_array(QTTVector(sol.cores, 2, d, "serial")).cpu().numpy()
    err = float(np.max(np.abs(grid - u_exact)))
    print(f"{name:15s} max rank {max(sol.ranks):3d}  "
          f"Linf err vs exact: {err:.3e}")
    # second-order 5-point stencil: discretization floor ~ h^2
    assert err < 20 * h ** 2, f"{name} did not solve the Laplace system"
print("done; both solvers reproduce sin(pi x) sinh(pi (1-y)) / sinh(pi)")
