"""Continuous batching of independent QTT solves over a device mesh, on
PyTorch (the twin of examples/batched_parameter_sweep.py): a PDE parameter
sweep where every rank of the process group solves its share of
(I + dt*kappa/h^2*Laplacian) u = b systems.

The mesh is ``make_mesh(dp, tp, device=)`` on a ``torch.distributed``
group. Run as one process, the script starts a one-rank group itself (NCCL
on the card, gloo on the CPU); a caller that already started a group keeps
it, and every rank then makes the same calls.

Run: python examples_torch/batched_parameter_sweep.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch
import torch.distributed as dist

import ttnx_torch as tx
from ttnx_torch.config import script_device
from ttnx_torch.parallel.batch import batched_als_linsolve, make_mesh

dev = script_device()
d = 8
n = 2 ** d
h_grid = 1.0 / (n + 1)
dt = 1e-6
kappas = np.linspace(0.5, 4.0, 8)  # one diffusion coefficient per problem

u0 = tx.qtt_sin(d, a=h_grid, b=1 - h_grid, device=dev)
lap = tx.toeplitz_to_qtto(2.0, -1.0, -1.0, d, device=dev)

# one operator, many right-hand sides (different initial modes)
A = tx.id_tto(d, device=dev) + (dt * float(kappas[0]) / h_grid ** 2) * lap

gen = torch.Generator().manual_seed(0)
bs = [tx.qtt_sin(d, a=h_grid, b=1 - h_grid, lam=k + 1, device=dev)
      for k in range(8)]
x0s = [tx.rand_tt(gen, (2,) * d, rmax=6, normalise=True).to(dev)
       for k in range(8)]

own_group = not dist.is_initialized()
if own_group:
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
try:
    n_ranks = dist.get_world_size()
    mesh = make_mesh(dp=n_ranks, tp=1, device=dev)
    print(f"mesh: {tuple(mesh.shape)} ({n_ranks} ranks)")
    outs = batched_als_linsolve(mesh, A, bs, x0s, sweep_count=4)
finally:
    if own_group:
        dist.destroy_process_group()

worst = 0.0
for k, out in enumerate(outs):
    res = float(tx.norm(tx.sub(tx.matvec(A, out), bs[k]))
                / tx.norm(bs[k]))
    worst = max(worst, res)
    print(f"problem {k} (mode {k + 1}): residual {res:.2e} "
          f"ranks {out.ranks}")
assert worst < 1e-6, worst
