"""Analytic QTT encodings (exp, sin, cos, polynomials, Chebyshev) checked
pointwise against numpy, on PyTorch (the twin of
examples/analytic_encodings.py).

Run: python examples_torch/analytic_encodings.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from ttnx_torch import (qtt_chebyshev, qtt_cos, qtt_exp, qtt_polynom,
                        qtt_sin, qtt_to_function)
from ttnx_torch.config import script_device

dev = script_device()
d = 8
x = np.linspace(0, 1, 2 ** d)

cases = [
    ("exp(x)", qtt_exp(d, device=dev), np.exp(x)),
    ("sin(pi^2 x)", qtt_sin(d, lam=np.pi, device=dev),
     np.sin(np.pi ** 2 * x)),
    ("cos(pi^2 x)", qtt_cos(d, lam=np.pi, device=dev),
     np.cos(np.pi ** 2 * x)),
    ("quartic", qtt_polynom([0.0, 2.0, 3.0, -8.0, -5.0], d, device=dev),
     2 * x + 3 * x ** 2 - 8 * x ** 3 - 5 * x ** 4),
]
# Chebyshev polynomials T_0..T_4 on the Chebyshev-Lobatto grid of [0,1]
nodes = 0.5 * (1 + np.cos(np.pi * np.arange(2 ** d) / (2 ** d - 1)))
for k in range(5):
    cases.append((f"T_{k}", qtt_chebyshev(k, d, device=dev),
                  np.cos(k * np.arccos(2 * nodes - 1))))

for name, state, exact in cases:
    vals = qtt_to_function(state).cpu().numpy()
    err = float(np.max(np.abs(vals - exact)))
    print(f"{name:12s} ranks {state.ranks}  Linf err: {err:.3e}")
    assert err < 1e-10, f"{name} encoding mismatch"

print("all analytic encodings exact to 1e-10")
