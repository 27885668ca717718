"""TT quadrature by cross: polynomial, separable, rank-2 6-D and 10-/20-D
Gaussian integrals against their closed forms, on PyTorch (the twin of
examples/quadrature_cross.py).

Run: python examples_torch/quadrature_cross.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from ttnx_torch.config import script_device
from ttnx_torch.cross import MaxVol, tt_integrate

dev = script_device()

print("1. int_0^1 x^2 dx = 1/3")
r1 = float(tt_integrate(lambda x: x[:, 0] ** 2, 1, device=dev))
print(f"   result {r1:.12f}  exact {1 / 3:.12f}")
assert abs(r1 - 1 / 3) < 1e-10

print("2. int_0^1 int_0^1 x y dx dy = 1/4")
r2 = float(tt_integrate(lambda x: x[:, 0] * x[:, 1], 2, device=dev))
print(f"   result {r2:.12f}  exact 0.25")
assert abs(r2 - 0.25) < 1e-10

print("3. int_[0,1]^6 sin(sum x) dx  (rank-2 integrand)")
r3 = float(tt_integrate(lambda x: np.sin(np.sum(x, axis=1)), 6,
                        alg=MaxVol(tol=1e-8), device=dev))
exact3 = float(np.imag((np.exp(1j) - 1) ** 6 / 1j ** 6))
print(f"   result {r3:.10f}  exact {exact3:.10f}")
assert abs(r3 - exact3) < 1e-8

print("4. int_[-5,5]^d exp(-||x||^2) dx = pi^(d/2)")
for d in [10, 20]:
    f = lambda x: np.exp(-np.sum(x ** 2, axis=1))  # noqa: E731
    r = float(tt_integrate(f, lower=[-5.0] * d, upper=[5.0] * d,
                           alg=MaxVol(tol=1e-8), device=dev))
    exact = np.pi ** (d / 2)
    rel = abs(r - exact) / exact
    print(f"   d={d:2d}  rel err {rel:.3e}")
    assert rel < 1e-8

print("all quadratures match their closed forms")
