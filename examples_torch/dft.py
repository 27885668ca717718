"""Quantics Fourier transform of a band-limited signal: the QTT DFT
recovers its 12 coefficients, on PyTorch (the twin of examples/dft.py).

Run: python examples_torch/dft.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

import ttnx_torch as tx
from ttnx_torch.config import script_device

dev = script_device()
d = 10
N = 2 ** d
K = 50
rng = np.random.default_rng(1234)
r = 12
coeffs = rng.standard_normal(r) + 1j * rng.standard_normal(r)


def f(x):
    ks = np.arange(r)
    x = np.atleast_1d(x)
    return (coeffs[None, :]
            * np.exp(2j * np.pi * ks[None, :] * x[:, None])).sum(1)


F = tx.fourier_qtto(d, K=K, sign=-1.0, normalize=True, device=dev)
x_qtt = tx.function_to_qtt_uniform(f, d, device=dev)
y_qtt = tx.tt_compress(F @ x_qtt, 100)

spec = tx.qtt_to_vector(y_qtt).cpu().numpy()
scale = np.sqrt(N)

in_band = (np.linalg.norm(spec[:r] - scale * coeffs)
           / (scale * np.linalg.norm(coeffs)))
out_band = np.linalg.norm(spec[r:]) / np.linalg.norm(spec)
print(f"in-band recovery error:  {in_band:.3e}")
print(f"out-of-band energy:      {out_band:.3e}")
assert in_band < 1e-8
assert out_band < 1e-10
print("recovered coefficients:", np.round(spec[:r] / scale, 6))
