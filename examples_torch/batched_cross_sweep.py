"""Batched TT-cross parameter sweep on the device, on PyTorch (the twin of
examples/batched_cross_sweep.py).

The device cross runs the fixed-rank MaxVol sweep with a leading batch
axis (``batch=``, the twin of ``jax.vmap`` over an integrand parameter):
one call crosses the Wishart Laplace-transform integrand at 16 scale
parameters, each problem with its own starting sets.

Run: python examples_torch/batched_cross_sweep.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from ttnx_torch.config import script_device
from ttnx_torch.cross.device import evaluate_tt_indices, maxvol_cross_device

dev = script_device()
d = 5
nu = d + 2
p = nu / 2
Sigma = np.array([
    [1.0, 0.3, 0.2, 0.1, 0.18],
    [0.3, 1.2, 0.25, 0.15, 0.22],
    [0.2, 0.25, 0.9, 0.2, 0.28],
    [0.1, 0.15, 0.2, 1.1, 0.19],
    [0.18, 0.22, 0.28, 0.19, 1.05],
])
sigma = torch.as_tensor(2 * Sigma, device=dev)
grid = torch.linspace(0.0, 2.0, 8, dtype=torch.float64, device=dev)
eye = torch.eye(d, dtype=torch.float64, device=dev)

# Wishart Laplace-transform integrand with a scale parameter theta:
# f_theta(x) = det(I + theta * sigma .* x)^(-p)


def f_idx(theta, indices):
    """``theta (B,)``, int64 ``indices (B, m, d)`` -> values ``(B, m)``."""
    coords = grid[indices]                                   # (B, m, d)
    M = eye + theta[:, None, None, None] * sigma * coords[..., None, :]
    return torch.linalg.det(M) ** (-p)


thetas = torch.linspace(0.5, 2.0, 16, dtype=torch.float64, device=dev)
run = maxvol_cross_device(lambda idx: f_idx(thetas, idx), [8] * d, rank=8,
                          n_iters=3, n_val=500, batch=len(thetas))
gen = torch.Generator(device=dev).manual_seed(0)
cores_b, eps_b = run(gen)
print(f"batched cross over {len(thetas)} thetas: "
      f"final val-eps max {float(eps_b[:, -1].max()):.2e}")

# spot-check each theta against direct integrand evaluation
rng = np.random.default_rng(7)
idx = torch.as_tensor(np.stack([rng.integers(0, 8, 300) for _ in range(d)],
                               axis=1), device=dev)
worst = 0.0
for k in range(len(thetas)):
    cores_k = [c[k] for c in cores_b]
    yhat = evaluate_tt_indices(cores_k, idx).cpu().numpy()
    ys = f_idx(thetas[k:k + 1], idx[None])[0].cpu().numpy()
    rel = np.linalg.norm(ys - yhat) / np.linalg.norm(ys)
    worst = max(worst, rel)
    if k % 4 == 0:
        print(f"  theta={float(thetas[k]):.2f}  rel_l2={rel:.2e}")
print(f"worst rel_l2 over the sweep: {worst:.2e}")
assert worst < 1e-4, worst
