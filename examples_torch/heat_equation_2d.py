"""2-D heat equation on a serial QTT by 2-site TDVP in imaginary time,
against the analytic decay of its eigenmode, on PyTorch (the twin of
examples/heat_equation_2d.py).

Run: python examples_torch/heat_equation_2d.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from ttnx_torch import (QTTOperator, QTTVector, dot, id_tto, kron_tt,
                        kron_tto, qtt_sin, qttv_to_array, toeplitz_to_qtto)
from ttnx_torch.config import script_device
from ttnx_torch.solvers.tdvp import tdvp2

dev = script_device()
d = 5
N = 2 ** d
h = 1.0 / (N + 1)
kappa = 0.1

lap1d = toeplitz_to_qtto(-2.0, 1.0, 1.0, d, device=dev)
idd = id_tto(d, device=dev)
A_raw = (kappa / h ** 2) * (kron_tto(lap1d, idd) + kron_tto(idd, lap1d))
A = QTTOperator(A_raw, 2, d, "serial")
u0_raw = kron_tt(qtt_sin(d, a=h, b=1 - h, device=dev),
                 qtt_sin(d, a=h, b=1 - h, device=dev))
u0 = QTTVector(u0_raw, 2, d, "serial")

lam = float(torch.real(dot(u0_raw, A_raw @ u0_raw) / dot(u0_raw, u0_raw)))
print(f"eigenmode rate lambda = {lam:.4f}")

steps = [1e-3] * 10
sol = tdvp2(A.tt(), u0.tt(), steps, imaginary_time=True, normalize=False,
            max_bond=8, truncerr=1e-12)
out = qttv_to_array(QTTVector(sol, 2, d, "serial")).cpu().numpy()
target = np.exp(lam * sum(steps)) * qttv_to_array(u0).cpu().numpy()
rel = np.linalg.norm(out - target) / np.linalg.norm(target)
print(f"relative error vs analytic decay: {rel:.3e}")
assert rel < 1e-6
