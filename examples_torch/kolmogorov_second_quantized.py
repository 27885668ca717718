"""Second-quantized Kolmogorov generator of three coupled modes: ladder
operators on a QTT grid, their algebra verified, and the norm decay of one
excitation under Crank-Nicolson, on PyTorch (the twin of
examples/kolmogorov_second_quantized.py).

Run: python examples_torch/kolmogorov_second_quantized.py  (on cuda:0; add
TTNX_TORCH_CPU=1 to run on the CPU)
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import torch

import ttnx_torch as tx
from ttnx_torch import (crank_nicholson_method, dot, function_to_qtt,
                        gradient, id_tto, kron_tto, matmul, matvec, norm,
                        qtt_polynom, qtto_to_matrix, shift, tt_compress,
                        ttv_to_diag_tto)
from ttnx_torch.config import script_device
from ttnx_torch.core.algebra import add_op, kron_tt, scale, scale_op, sub

dev = script_device()
bits = 6
N = 2 ** bits
lo, hi = -4.0, 4.0
h = (hi - lo) / (N - 1)
q = 1.0
max_bond = 8
truncerr = 1e-8

X = ttv_to_diag_tto(qtt_polynom([0.0, 1.0], bits, a=lo, b=hi,
                                device=dev))  # diag(x)
D = scale_op(1.0 / (2 * h),
             add_op(shift(bits, device=dev), scale_op(-1.0, add_op(
                 id_tto(bits, device=dev),
                 scale_op(-1.0, gradient(bits, device=dev))))))
a_op = scale_op(1.0 / np.sqrt(2), add_op(X, D))
adag = scale_op(1.0 / np.sqrt(2), add_op(X, scale_op(-1.0, D)))
I1 = id_tto(bits, device=dev)


def mode(op, which):
    ops = [I1, I1, I1]
    ops[which] = op
    return kron_tto(kron_tto(ops[0], ops[1]), ops[2])


a1, a2, a3 = (mode(a_op, k) for k in range(3))
ad1, ad2, ad3 = (mode(adag, k) for k in range(3))

A = add_op(add_op(matmul(ad1, a1), matmul(ad2, a2)), matmul(ad3, a3))


def mm3(x, y, z):
    return matmul(matmul(x, y), z)


C = scale_op(np.sqrt(q / 2), add_op(
    add_op(
        add_op(mm3(ad2, ad3, a1), scale_op(-1.0, mm3(ad1, a3, a2))),
        add_op(mm3(ad1, ad3, a2), scale_op(-1.0, mm3(ad2, a3, a1)))),
    scale_op(-2.0, add_op(mm3(ad1, ad2, a3),
                          scale_op(-1.0, mm3(ad3, a2, a1))))))
G = add_op(scale_op(-1.0, A), C)
print(f"generator built: {3 * bits} sites, max MPO rank {max(G.ranks)}")

# --- exact operator-algebra identities (dense, single mode) -----------------
Am = qtto_to_matrix(a_op).cpu().numpy()
Adm = qtto_to_matrix(adag).cpu().numpy()
Dm = qtto_to_matrix(D).cpu().numpy()
nm = qtto_to_matrix(matmul(adag, a_op)).cpu().numpy()
opn = np.linalg.norm
assert opn(Adm - Am.T) / opn(Am) < 1e-10          # a^dag = a^H (real grid)
assert opn(Dm + Dm.T) / opn(Dm) < 1e-10           # D^T = -D
assert opn(nm - nm.T) / opn(nm) < 1e-10           # n = a^dag a Hermitian
assert np.linalg.eigvalsh(0.5 * (nm + nm.T)).min() > -1e-10  # n >= 0


# A Hermitian (dissipative), C anti-Hermitian (transport), cross-mode
# ladder operators commute — checked on random TT vectors
def rv(k):
    z = tx.rand_tt(torch.Generator().manual_seed(k), (2,) * (3 * bits),
                   rmax=4).to(dev)
    return scale(1.0 / float(norm(z)), z)


x, y = rv(1), rv(2)
sym_err = abs(complex(dot(x, matvec(A, y))) - complex(dot(matvec(A, x), y)))
assert sym_err / (float(norm(matvec(A, x))) * float(norm(y))) < 1e-8
skew = abs(complex(dot(x, matvec(C, x))))
assert skew / (float(norm(x)) * float(norm(matvec(C, x)))) < 1e-8
comm = sub(matvec(a1, matvec(ad2, x)), matvec(ad2, matvec(a1, x)))
assert float(norm(comm)) / float(norm(matvec(a1, matvec(ad2, x)))) < 1e-8
print("operator algebra: a^dag = a^H, D skew, n PSD, A = A^H, C = -C^H,"
      " [a1, a2^dag] = 0  (all verified)")

# --- evolution: excited mode 1, ground modes 2/3 ---------------------------
gauss = function_to_qtt(
    lambda t: np.exp(-0.5 * (lo + (hi - lo) * t) ** 2), bits, device=dev)
ground = tt_compress(scale(1.0 / float(norm(gauss)), gauss), max_bond,
                     truncerr=truncerr)
excited = tt_compress(scale(np.sqrt(q / 2), matvec(adag, ground)), max_bond,
                      truncerr=truncerr)
psi0 = tt_compress(kron_tt(kron_tt(excited, ground), ground), max_bond,
                   truncerr=truncerr)

tau, T = 0.001, 0.01
n_steps = int(round(T / tau))
psi = psi0
masses = [float(norm(psi))]
for _ in range(n_steps):
    psi = crank_nicholson_method(G, psi, psi, [tau], normalize=False,
                                 tt_solver="als", max_bond=max_bond,
                                 sweep_count=4)
    psi = tt_compress(psi, max_bond, truncerr=truncerr)
    masses.append(float(norm(psi)))
print("norm history:", " ".join(f"{m:.5f}" for m in masses))
# the dissipative -A strictly contracts the norm; C is norm-neutral
assert all(m2 < m1 for m1, m2 in zip(masses, masses[1:]))
# one excitation decays at rate ~1: ||psi(t)|| ~ ||psi0|| e^{-t} up to the
# grid-truncation of the ladder algebra
decay = masses[-1] / masses[0]
assert abs(decay - np.exp(-T)) < 5e-3, (decay, np.exp(-T))
print(f"done; norm decay over T={T}: {decay:.5f} vs e^-T={np.exp(-T):.5f}, "
      f"final rank {max(psi.ranks)}")
