"""QTT operator constructors: the Toeplitz stencil and the spin-chain
Hamiltonians.

Cores are small structured constants assembled with numpy and moved once
to the device the caller names: ``device`` is a required keyword of
every constructor (there is no default device). Layout: ``(r_left,
n_out, n_in, r_right)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ttnx_torch.core.tt import TTOperator

__all__ = ["toeplitz_to_qtto", "pauli_matrix", "pauli_sum_tto",
           "pauli_pair_sum_tto", "H_mu", "H_munu", "heisenberg_xyz_tto",
           "ising_tto", "xxz_tto", "xxx_tto", "xy_tto"]

_ID = np.eye(2)
_J = np.array([[0.0, 1.0], [0.0, 0.0]])  # superdiagonal shift block
_JT = _J.T


def _op(blocks, dtype, *, device) -> TTOperator:
    """Build a TTOperator from per-site nested lists of 2x2 physical blocks
    (or ``0``); entry ``(a, b)`` connects left bond a to right bond b."""
    np_dtype = np.complex128 if dtype.is_complex else np.float64
    cores = []
    for block in blocks:
        rl, rr = len(block), len(block[0])
        core = np.zeros((rl, 2, 2, rr), dtype=np_dtype)
        for a in range(rl):
            for b in range(rr):
                blk = block[a][b]
                if isinstance(blk, (int, float)) and blk == 0:
                    continue
                core[a, :, :, b] = blk
        cores.append(torch.as_tensor(core, dtype=dtype, device=device))
    return TTOperator(cores)


def toeplitz_to_qtto(alpha, beta, gamma, d: int, *, dtype=torch.float64,
                     device) -> TTOperator:
    """Rank-3 exact QTT of the tridiagonal Toeplitz matrix
    ``alpha*I + beta*sub + gamma*super``."""
    first = [[_ID, _JT, _J]]
    mid = [[_ID, _JT, _J], [0, _J, 0], [0, 0, _JT]]
    last = [[alpha * _ID + beta * _J + gamma * _JT], [gamma * _J],
            [beta * _JT]]
    if d == 1:
        return _op([[[alpha * _ID + beta * _J + gamma * _JT]]], dtype,
                   device=device)
    return _op([first] + [mid] * (d - 2) + [last], dtype, device=device)


# ---------------------------------------------------------------------------
# Spin chains. Each constructor returns float64 cores, or complex128 where a
# Pauli Y enters outside a YY pair.
# ---------------------------------------------------------------------------


def _pauli_axis(mu) -> str:
    axis = str(mu).lower().lstrip(":")
    if axis in ("x", "y", "z"):
        return axis
    raise ValueError("Pauli axis must be 'x', 'y', or 'z'")


def pauli_matrix(mu) -> np.ndarray:
    """The 2x2 Pauli matrix of axis ``mu`` (numpy; Y is complex)."""
    axis = _pauli_axis(mu)
    if axis == "x":
        return np.array([[0.0, 1.0], [1.0, 0.0]])
    if axis == "y":
        return np.array([[0.0, -1j], [1j, 0.0]], dtype=np.complex128)
    return np.array([[1.0, 0.0], [0.0, -1.0]])


def _pauli_pair_factors(mu, nu):
    """YY pairs use the real-arithmetic form ``-Y_real ⊗ Y_real`` with
    ``Y = i Y_real``."""
    a, b = _pauli_axis(mu), _pauli_axis(nu)
    if a == "y" and b == "y":
        y_real = np.array([[0.0, -1.0], [1.0, 0.0]])
        return -y_real, y_real
    return pauli_matrix(a), pauli_matrix(b)


def _torch_dtype(*arrays_or_scalars):
    dt = np.result_type(*arrays_or_scalars, np.float64)
    return torch.complex128 if np.issubdtype(dt, np.complexfloating) \
        else torch.float64


def pauli_sum_tto(mu, d: int, *, device) -> TTOperator:
    """Rank-2 MPO of ``sum_i P_mu^(i)``."""
    if d < 1:
        raise ValueError("number of spin sites must be at least 1")
    P = pauli_matrix(mu)
    dtype = _torch_dtype(P)
    if d == 1:
        return _op([[[P]]], dtype, device=device)
    eye = np.eye(2)
    first = [[P, eye]]
    mid = [[eye, 0], [P, eye]]
    last = [[eye], [P]]
    return _op([first] + [mid] * (d - 2) + [last], dtype, device=device)


def pauli_pair_sum_tto(mu, nu, d: int, *, device) -> TTOperator:
    """Rank-3 nearest-neighbour MPO of ``sum_i P_mu^(i) P_nu^(i+1)``."""
    if d < 2:
        raise ValueError("nearest-neighbor Pauli pair sum needs at least 2 "
                         "sites")
    Pmu, Pnu = _pauli_pair_factors(mu, nu)
    eye = np.eye(2)
    first = [[0, Pmu, eye]]
    mid = [[eye, 0, 0], [Pnu, 0, 0], [0, Pmu, eye]]
    last = [[eye], [Pnu], [0]]
    return _op([first] + [mid] * (d - 2) + [last], _torch_dtype(Pmu, Pnu),
               device=device)


def H_mu(mu, d: int, *, device) -> TTOperator:
    return pauli_sum_tto(mu, d, device=device)


def H_munu(mu, nu, d: int, *, device) -> TTOperator:
    return pauli_pair_sum_tto(mu, nu, d, device=device)


def heisenberg_xyz_tto(d: int, jx=1.0, jy=1.0, jz=1.0, lam=0.0, field="x",
                       *, device) -> TTOperator:
    """Open-boundary Heisenberg XYZ Hamiltonian as a direct rank-5 MPO
    ``H = jx H_xx + jy H_yy + jz H_zz + lam H_field``."""
    if d < 2:
        raise ValueError("Heisenberg XYZ chain needs at least 2 spin sites")
    Px1, Px2 = _pauli_pair_factors("x", "x")
    Py1, Py2 = _pauli_pair_factors("y", "y")
    Pz1, Pz2 = _pauli_pair_factors("z", "z")
    Pf = pauli_matrix(field) if lam != 0 else np.zeros((2, 2))
    dtype = _torch_dtype(Px1, Py1, Pz1, Pf, jx, jy, jz, lam)
    eye = np.eye(2)
    first = [[lam * Pf, jx * Px1, jy * Py1, jz * Pz1, eye]]
    mid = [
        [eye, 0, 0, 0, 0],
        [Px2, 0, 0, 0, 0],
        [Py2, 0, 0, 0, 0],
        [Pz2, 0, 0, 0, 0],
        [lam * Pf, jx * Px1, jy * Py1, jz * Pz1, eye],
    ]
    last = [[eye], [Px2], [Py2], [Pz2], [lam * Pf]]
    return _op([first] + [mid] * (d - 2) + [last], dtype, device=device)


def ising_tto(d: int, J=1.0, h=0.0, interaction="z", field="x", *,
              device) -> TTOperator:
    axis = _pauli_axis(interaction)
    jx = J if axis == "x" else 0.0
    jy = J if axis == "y" else 0.0
    jz = J if axis == "z" else 0.0
    return heisenberg_xyz_tto(d, jx=jx, jy=jy, jz=jz, lam=h, field=field,
                              device=device)


def xxz_tto(d: int, J=1.0, delta=1.0, h=0.0, field="z", *,
            device) -> TTOperator:
    return heisenberg_xyz_tto(d, jx=J, jy=J, jz=J * delta, lam=h, field=field,
                              device=device)


def xxx_tto(d: int, J=1.0, h=0.0, field="z", *, device) -> TTOperator:
    return heisenberg_xyz_tto(d, jx=J, jy=J, jz=J, lam=h, field=field,
                              device=device)


def xy_tto(d: int, jx=1.0, jy=1.0, h=0.0, field="z", *,
           device) -> TTOperator:
    return heisenberg_xyz_tto(d, jx=jx, jy=jy, jz=0.0, lam=h, field=field,
                              device=device)
