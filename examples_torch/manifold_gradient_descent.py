"""Riemannian-style gradient descent on the TT manifold, on PyTorch (the
twin of examples/manifold_gradient_descent.py).

Minimize the quadratic cost 0.5 ||x - target||^2 by retraction steps
x <- retract(x, -grad) and check convergence to the target, plus the same
descent through torch.optim on a list of leaf cores.

Run: python examples_torch/manifold_gradient_descent.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from ttnx_torch import TTVector, dot, norm, qtt_sin, ttv_to_tensor, zeros_tt
from ttnx_torch.config import script_device
from ttnx_torch.core.algebra import scale, sub
from ttnx_torch.utils.manifold import (distance, manifold_norm, retract,
                                       ttvector_manifold)

dev = script_device()
d = 6
target = qtt_sin(d, device=dev)
M = ttvector_manifold(target)
x = zeros_tt((2,) * d, target.ranks, device=dev)

# gradient of 0.5||x - target||^2 is (x - target); constant step 1.0 solves
# the quadratic in one retraction, further steps polish
for it in range(5):
    g = sub(x, target)
    gn = float(manifold_norm(x, g))
    x = retract(x, scale(-1.0, g))
    if gn < 1e-5:
        break
rel = float(distance(x, target)) / float(manifold_norm(target, target))
print(f"manifold descent: {it + 1} iters, rel err (TT metric) {rel:.3e}")
# the TT-metric distance of a tiny difference saturates at ~sqrt(eps)*||t||
# by cancellation; the densified comparison shows the true accuracy
vx = ttv_to_tensor(x).reshape(-1).cpu().numpy()
vt = ttv_to_tensor(target).reshape(-1).cpu().numpy()
dense_rel = np.linalg.norm(vx - vt) / np.linalg.norm(vt)
print(f"manifold descent: dense rel err {dense_rel:.3e}")
assert rel < 1e-6 and dense_rel < 1e-12

# torch.optim path: the optimizer steps a list of leaf cores directly.
# Gradients live in CORE space (multilinear parametrization) — per-core
# updates, never TT-vector addition of the gradient.


def cost(cores):
    diff = sub(TTVector(cores), target)
    return 0.5 * torch.real(dot(diff, diff))


cores = [c.clone().requires_grad_()
         for c in qtt_sin(d, lam=2 * np.pi, device=dev).cores]  # off-target
opt = torch.optim.Adam(cores, lr=0.1)
best_v, best_cores = np.inf, [c.detach().clone() for c in cores]
for it in range(500):
    opt.zero_grad()
    v = cost(cores)
    v.backward()
    if float(v.detach()) < best_v:
        best_v, best_cores = float(v.detach()), [c.detach().clone()
                                                 for c in cores]
    opt.step()
final = float(norm(sub(TTVector(best_cores), target)))
rel_final = final / float(norm(target))
print(f"torch.optim Adam on cores: 500 iters, best rel ||x - target|| = "
      f"{rel_final:.3e}")
assert rel_final < 1e-4
print("manifold_gradient_descent OK")
