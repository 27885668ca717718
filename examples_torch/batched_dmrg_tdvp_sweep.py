"""Batched DMRG + TDVP parameter sweeps, on PyTorch (the twin of
examples/batched_dmrg_tdvp_sweep.py).

One batched call solves a whole field sweep of Heisenberg XXZ ground
states and evolves a batch of heat states with per-problem step sizes (the
JAX package's ``jax.vmap`` is a loop over the batch axis here). Physics
asserted across the whole sweep axis: DMRG energies vs dense
diagonalization, TDVP decay vs the analytic eigenmode solution.

Run: python examples_torch/batched_dmrg_tdvp_sweep.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import ttnx_torch as tx
from ttnx_torch.config import script_device
from ttnx_torch.core.decomp import tto_to_tensor, ttv_to_tensor
from ttnx_torch.parallel.batch import (batched_dmrg_eig_sweeps,
                                       batched_tdvp1_steps)
from ttnx_torch.solvers.als_scan import pack_op, pack_tt, rank_masks, unpack_tt

dev = script_device()
d = 8
rmax = 16

# --- DMRG field sweep: H(lam) = XXZ + lam * Sz ------------------------------
lams = np.linspace(0.0, 1.5, 6)
ops = [tx.heisenberg_xyz_tto(d, jx=1.0, jy=1.0, jz=0.7, lam=lam, field="z",
                             device=dev)
       for lam in lams]
A_batch = torch.stack([pack_op(H, max(H.ranks)) for H in ops])

gen = torch.Generator().manual_seed(0)
xs, ms = [], []
for _ in lams:
    x = tx.rand_tt(gen, (2,) * d, rmax=4, normalise=True,
                   orthogonal=True).to(dev)
    xs.append(pack_tt(x, rmax))
    ms.append(rank_masks(x.ranks, rmax, device=dev))
x_batch, m_batch = torch.stack(xs), torch.stack(ms)

tol = 1e-10
xb, mb, Eb = batched_dmrg_eig_sweeps(A_batch, x_batch, m_batch, tol, tol,
                                     n_sweeps=5)
E_sweep = Eb[:, -1].cpu().numpy()
E_exact = np.array([
    np.linalg.eigvalsh(tto_to_tensor(H).reshape(2 ** d, 2 ** d)
                       .cpu().numpy())[0] for H in ops])
err = np.abs(E_sweep - E_exact)
print("lam       E_dmrg        E_exact       |err|")
for lam, Ed, Ee, e in zip(lams, E_sweep, E_exact, err):
    print(f"{lam:4.2f}  {Ed:12.8f}  {Ee:12.8f}  {e:.2e}")
assert np.all(err < 1e-7), err
# the field term must actually move the physics across the sweep
assert E_exact[0] > E_exact[-1] + 1.0

# --- TDVP sweep: one heat generator, a batch of step sizes ------------------
hg = 1.0 / (2 ** d + 1)
A = (-1.0 / hg ** 2) * tx.toeplitz_to_qtto(2.0, -1.0, -1.0, d, device=dev)
u0 = tx.qtt_sin(d, a=hg, b=1 - hg, device=dev)
A_stack = pack_op(A, max(A.ranks))
rks = tx.r_and_d_to_rks(u0.ranks, (2,) * d, rmax=8)
# TDVP step contract: state packed in site-0 canonical form
x = pack_tt(tx.orthogonalize(u0, 0), 8)
m = rank_masks(rks, 8, device=dev)
hs = torch.tensor([1e-5, 2e-5, 4e-5, 8e-5], dtype=torch.float64, device=dev)
n_steps = 4
out = batched_tdvp1_steps(A_stack, x.expand((4,) + x.shape),
                          m.expand((4,) + m.shape), hs,
                          n_steps=n_steps, imag_real=True)
mu1 = (2 - 2 * np.cos(np.pi * hg)) / hg ** 2
u0_dense = ttv_to_tensor(u0).reshape(-1).cpu().numpy()
rels = []
for i, h in enumerate(hs.cpu().numpy()):
    got = ttv_to_tensor(unpack_tt(out[i], rks)).reshape(-1).cpu().numpy()
    expect = u0_dense * np.exp(-mu1 * n_steps * h)
    rels.append(np.linalg.norm(got - expect) / np.linalg.norm(expect))
print("tdvp batch rel errs:", ["%.1e" % r for r in rels])
assert max(rels) < 1e-8, rels
print("OK")
