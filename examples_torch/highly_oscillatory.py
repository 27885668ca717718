"""A highly oscillatory function by Lagrange interpolation QTTs, full and
rank-revealing, then compressed, on PyTorch (the twin of
examples/highly_oscillatory.py).

Run: python examples_torch/highly_oscillatory.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

import ttnx_torch as tx
from ttnx_torch.config import script_device

dev = script_device()
f = lambda x: np.cos(1.0 / (x ** 3 + 0.01)) + np.sin(np.pi * x)  # noqa: E731
num_cores = 10
N = 150

qtt = tx.interpolating_qtt(f, num_cores, N, device=dev)
qtt_rr = tx.lagrange_rank_revealing(f, num_cores, N, rel_tol=1e-10,
                                    device=dev)

xs = np.arange(2 ** num_cores) / 2 ** num_cores
ref = f(xs)


def rel_err(q):
    return (np.linalg.norm(tx.matricize(q, num_cores).cpu().numpy() - ref)
            / np.linalg.norm(ref))


err_full = rel_err(qtt)
err_rr = rel_err(qtt_rr)
print(f"interpolating_qtt:       rank {max(qtt.ranks)}, rel err "
      f"{err_full:.2e}")
print(f"lagrange_rank_revealing: ranks {tuple(qtt_rr.ranks)}, rel err "
      f"{err_rr:.2e}")
assert err_full < 1e-6 and err_rr < 1e-6
assert max(qtt_rr.ranks) < max(qtt.ranks) / 3  # rank revealing compresses

# compression path of the reference example: cap at max_bond=10
Q = tx.tt_compress(qtt_rr, max_bond=10, truncerr=1e-8)
err_q = rel_err(Q)
print(f"compressed (max_bond=10): ranks {tuple(Q.ranks)}, rel err "
      f"{err_q:.2e}")
assert max(Q.ranks) <= 10
print("highly_oscillatory OK")
