"""QTT operator constructors: Toeplitz stencils, the Laplacian
boundary-condition family, prolongations, spin-chain Hamiltonians and the
multi-dimensional QTT Laplacian.

Cores are small structured constants assembled with numpy and moved once
to the device the caller names: ``device`` is a required keyword of
every constructor (there is no default device). Layout: ``(r_left,
n_out, n_in, r_right)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ttnx_torch.core.algebra import add_op, kron_tto, scale_op
from ttnx_torch.core.tt import TTOperator, id_tto
from ttnx_torch.ops.qtt import QTTOperator, reorder_op

__all__ = ["toeplitz_to_qtto", "shift", "gradient", "laplacian",
           "laplacian_DN", "laplacian_ND", "laplacian_NN", "laplacian_P",
           "inv_laplacian_DN", "qtto_prolongation",
           "qtto_constant_prolongation", "qtto_linear_prolongation",
           "pauli_matrix", "pauli_sum_tto", "pauli_pair_sum_tto", "H_mu",
           "H_munu", "heisenberg_xyz_tto", "ising_tto", "xxz_tto", "xxx_tto",
           "xy_tto", "qtt_laplacian"]

_ID = np.eye(2)
_J = np.array([[0.0, 1.0], [0.0, 0.0]])  # superdiagonal shift block
_JT = _J.T
_I1 = np.array([[1.0, 0.0], [0.0, 0.0]])
_I2 = np.array([[0.0, 0.0], [0.0, 1.0]])
_E = np.ones((2, 2))
_F64 = torch.float64


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


def shift(d: int, *, device) -> TTOperator:
    """The superdiagonal shift ``toeplitz(0, 1, 0)``."""
    return toeplitz_to_qtto(0, 1, 0, d, device=device)


def gradient(d: int, *, device) -> TTOperator:
    """Gradient stencil ``toeplitz(1, 0, -1)``."""
    return toeplitz_to_qtto(1, 0, -1, d, device=device)


def laplacian(d: int, *, device) -> TTOperator:
    """Dirichlet–Dirichlet Laplacian ``toeplitz(2, -1, -1)``."""
    return toeplitz_to_qtto(2, -1, -1, d, device=device)


def _bc_laplacian(d: int, corner, device) -> TTOperator:
    """Rank-4 Laplacian whose fourth bond carries the boundary block
    ``corner`` (``_I2``: Dirichlet–Neumann, ``_I1``: Neumann–Dirichlet)."""
    if d < 4:
        raise ValueError("Dimension must be at least 4")
    first = [[_ID, _JT, _J, corner]]
    mid = [[_ID, _JT, _J, 0], [0, _J, 0, 0], [0, 0, _JT, 0],
           [0, 0, 0, corner]]
    last = [[2 * _ID - _J - _JT], [-_J], [-_JT], [-corner]]
    return _op([first] + [mid] * (d - 2) + [last], _F64, device=device)


def laplacian_DN(d: int, *, device) -> TTOperator:
    """Dirichlet–Neumann Laplacian, rank 4."""
    return _bc_laplacian(d, _I2, device)


def laplacian_ND(d: int, *, device) -> TTOperator:
    """Neumann–Dirichlet Laplacian, rank 4."""
    return _bc_laplacian(d, _I1, device)


def laplacian_NN(d: int, *, device) -> TTOperator:
    """Neumann–Neumann Laplacian, rank 5 with rank-1 boundaries."""
    if d < 4:
        raise ValueError("Dimension must be at least 4")
    first = [[_ID, _JT, _J, _I2, _I1]]
    mid = [
        [_ID, _JT, _J, 0, 0],
        [0, _J, 0, 0, 0],
        [0, 0, _JT, 0, 0],
        [0, 0, 0, _I2, 0],
        [0, 0, 0, 0, -_I1],
    ]
    last = [[2 * _ID - _J - _JT], [-_J], [-_JT], [-_I2], [-_I1]]
    return _op([first] + [mid] * (d - 2) + [last], _F64, device=device)


def laplacian_P(d: int, *, device) -> TTOperator:
    """Periodic Laplacian, rank 5."""
    if d < 4:
        raise ValueError("Dimension must be at least 4")
    first = [[_ID, _JT, _J, _J, _JT]]
    mid = [
        [_ID, _JT, _J, 0, 0],
        [0, _J, 0, 0, 0],
        [0, 0, _JT, 0, 0],
        [0, 0, 0, _J, 0],
        [0, 0, 0, 0, _JT],
    ]
    last = [[2 * _ID - _J - _JT], [-_J], [-_JT], [-_J], [-_JT]]
    return _op([first] + [mid] * (d - 2) + [last], _F64, device=device)


def inv_laplacian_DN(d: int, *, device) -> TTOperator:
    """Exact inverse of the Dirichlet–Neumann Laplacian, rank 4."""
    if d < 2:
        raise ValueError("Dimension must be at least 2")
    first = [[_ID, _I2, _J, _JT]]
    mid = [
        [_ID, _I2, _J, _JT],
        [0, 2 * _E, 0, 0],
        [0, _I2 + _JT, _E, 0],
        [0, _I2 + _J, 0, _E],
    ]
    last = [[_E + _I2], [2 * _E], [_E + _I2 + _JT], [_E + _I2 + _J]]
    return _op([first] + [mid] * (d - 2) + [last], _F64, device=device)


def qtto_prolongation(d: int, *, device) -> TTOperator:
    """Multigrid prolongation, rank 2; its last core is filled entry by
    entry."""
    if d < 2:
        raise ValueError("Dimension must be at least 2")
    first = [[0.5 * _ID, 0.5 * _JT]]
    mid = [[_ID, _JT], [0, _J]]
    last = np.zeros((2, 2, 2, 1))
    last[0, 0, 0, 0] = 1.0
    last[0, 1, 0, 0] = 2.0
    last[0, 0, 1, 0] = 1.0
    head = _op([first] + [mid] * (d - 2), _F64, device=device)
    return TTOperator(list(head.cores)
                      + [torch.as_tensor(last, device=device)])


def qtto_constant_prolongation(d: int, *, device) -> TTOperator:
    """Constant prolongation from d to d+1 binary sites: identity cores and
    a ones-core with a singleton input dim."""
    if d < 1:
        raise ValueError("Dimension must be at least 1")
    cores = list(id_tto(d, device=device).cores)
    cores.append(torch.ones((1, 2, 1, 1), dtype=_F64, device=device))
    return TTOperator(cores)


def qtto_linear_prolongation(d: int, *, device) -> TTOperator:
    """Linear prolongation from d to d+1 binary sites: the identity branch
    and the ``0.5 (I + shift)`` branch side by side, closed by a
    rectangular selector core (bit 0: identity, bit 1: average). Built on
    the host, then moved to ``device``."""
    if d < 1:
        raise ValueError("Dimension must be at least 1")
    host = torch.device("cpu")
    ident = id_tto(d, device=host)
    if d == 1:
        average = TTOperator([torch.tensor([[1.0, 1.0], [0.0, 1.0]],
                                           dtype=_F64).mul(0.5)
                              .reshape(1, 2, 2, 1)])
    else:
        average = add_op(scale_op(0.5, ident), scale_op(0.5, shift(
            d, device=host)))
    ir, ar = ident.ranks, average.ranks
    cores = []
    for k in range(d):
        rl = 1 if k == 0 else ir[k] + ar[k]
        core = np.zeros((rl, 2, 2, ir[k + 1] + ar[k + 1]))
        ic, ac = ident.cores[k].numpy(), average.cores[k].numpy()
        if k == 0:
            core[0:1, :, :, : ir[1]] = ic
            core[0:1, :, :, ir[1]:] = ac
        else:
            core[: ir[k], :, :, : ir[k + 1]] = ic
            core[ir[k]:, :, :, ir[k + 1]:] = ac
        cores.append(core)
    last = np.zeros((ir[d] + ar[d], 2, 1, 1))
    last[: ir[d], 0, 0, 0] = 1.0  # identity branch -> even points (bit 0)
    last[ir[d]:, 1, 0, 0] = 1.0  # average branch -> odd points (bit 1)
    cores.append(last)
    return TTOperator([torch.as_tensor(c, device=device) for c in cores])


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


# ---------------------------------------------------------------------------
# Multi-dimensional QTT Laplacian
# ---------------------------------------------------------------------------

# aliases of the reference's exported names (``∇`` and ``Δ⁻¹_DN`` are not
# Python identifiers: use ``gradient`` and ``inv_laplacian_DN``)
Δ = laplacian
Δ_DN = laplacian_DN
Δ_ND = laplacian_ND
Δ_NN = laplacian_NN
Δ_P = laplacian_P

_BC_BUILDERS = {"DD": laplacian, "DN": laplacian_DN, "ND": laplacian_ND,
                "NN": laplacian_NN}


def qtt_laplacian(n_dims: int, bits_per_dim: int,
                  ordering: str = "interleaved", a: float = 0.0,
                  b: float = 1.0, bc: str = "DN", *, device) -> QTTOperator:
    """n-D Laplacian as a Kronecker sum of 1-D operators of boundary
    condition ``bc`` with ``1/h^2`` scaling, as a ``QTTOperator`` (the NN
    operator's rank-1 boundaries let ``bc='NN'`` work for ``n_dims > 1``).
    Built on the host, the interleaved order by the SVD swaps of
    ``reorder_op``, whose default threshold 0 keeps every singular value
    (ranks up to 5120 at ``n_dims = 2``, ``bits_per_dim = 10``), then moved
    to ``device``."""
    if ordering not in ("interleaved", "serial"):
        raise ValueError("ordering must be 'interleaved' or 'serial'")
    if n_dims < 1:
        raise ValueError("n_dims must be at least 1")
    if bc not in _BC_BUILDERS:
        raise ValueError("bc must be 'DD', 'DN', 'ND', or 'NN'")
    d = bits_per_dim
    h = (b - a) / (2 ** d - 1)
    scl = 1.0 / h ** 2
    host = torch.device("cpu")
    lap_1d = _BC_BUILDERS[bc](d, device=host)
    eye_1d = id_tto(d, device=host)
    if n_dims == 1:
        return QTTOperator(scale_op(scl, lap_1d), 1, d, ordering).to(device)

    def term(k: int) -> TTOperator:
        out = lap_1d if k == 0 else eye_1d
        for dim in range(1, n_dims):
            out = kron_tto(out, lap_1d if dim == k else eye_1d)
        return out

    result = scale_op(scl, term(0))
    for k in range(1, n_dims):
        result = add_op(result, scale_op(scl, term(k)))
    out = QTTOperator(result, n_dims, d, "serial")
    if ordering == "interleaved":
        out = reorder_op(out, "interleaved")
    return out.to(device)
