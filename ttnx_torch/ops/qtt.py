"""Quantics-TT tooling: grids, analytic function encodings, TT <-> QTT core
splitting, and the multi-dimensional QTT wrappers with serial and
interleaved site orderings.

Big-endian bits: site 0 carries the most significant bit, so a C-order
``reshape(-1)`` of the dense tensor is the uniform-grid vector. Every
constructor samples or assembles its cores with numpy on the host and
places them on ``device``, a required keyword (there is no default
device).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from ttnx_torch.core import algebra
from ttnx_torch.core.canonical import (entanglement_entropy, orthogonalize,
                                       tt_compress)
from ttnx_torch.core.decomp import tto_to_tensor, ttv_decomp, ttv_to_tensor
from ttnx_torch.core.linalg import thin_svd
from ttnx_torch.core.tt import TTOperator, TTVector, increase_ranks

__all__ = [
    "gauss_chebyshev_lobatto",
    "index_to_point",
    "tuple_to_index",
    "function_to_tensor",
    "tensor_to_grid",
    "function_to_qtt",
    "function_to_qtt_uniform",
    "qtt_to_function",
    "qtt_to_vector",
    "qtt_polynom",
    "qtt_cos",
    "qtt_sin",
    "qtt_exp",
    "qtt_chebyshev",
    "qtt_basis_vector",
    "qtt_trapezoidal",
    "qtto_to_matrix",
    "to_qtt",
    "to_ttv",
    "QTTVector",
    "QTTOperator",
    "check_compat",
    "reorder",
    "reorder_vec",
    "reorder_op",
    "function_to_qttv",
    "qttv_to_array",
]


# ---------------------------------------------------------------------------
# Grids and index maps
# ---------------------------------------------------------------------------


def gauss_chebyshev_lobatto(n: int, shifted: bool = True):
    """Chebyshev–Lobatto nodes and weights (numpy), on [0, 1] when
    ``shifted``."""
    j = np.arange(n)
    x = np.cos(np.pi * j / (n - 1))
    w = np.pi / (n - 1) * np.ones(n)
    w[0] /= 2
    w[-1] /= 2
    if shifted:
        x = (x + 1) / 2
        w = w / 2
    return x, w


def tuple_to_index(bits: Sequence[int]) -> int:
    """Big-endian bits to the 0-based grid index."""
    d = len(bits)
    return sum(int(b) << (d - 1 - i) for i, b in enumerate(bits))


def index_to_point(bits: Sequence[int]) -> float:
    """Big-endian bits to ``x`` on the uniform grid of [0, 1] with spacing
    ``1 / (2^d - 1)``."""
    return tuple_to_index(bits) / (2 ** len(bits) - 1)


def _sample_grid(f: Callable, xs: np.ndarray) -> np.ndarray:
    """``f`` on a 1-D grid, vectorized when ``f`` takes arrays."""
    try:
        out = np.asarray(f(xs))
        if out.shape == xs.shape:
            return out
    except Exception:
        pass
    return np.asarray([f(float(x)) for x in xs])


def _bit_tensor(f: Callable, d: int) -> np.ndarray:
    n = 2 ** d
    return _sample_grid(f, np.arange(n) / (n - 1)).reshape((2,) * d)


def function_to_tensor(f: Callable, d: int, a: float = 0.0, b: float = 1.0,
                       *, device) -> torch.Tensor:
    """``f`` sampled on the 2^d-point uniform grid of [0, 1] as the bit
    tensor ``(2,) * d``. ``a`` and ``b`` are inert, as in the reference,
    which samples [0, 1] too."""
    del a, b
    return torch.as_tensor(_bit_tensor(f, d), device=device)


def tensor_to_grid(tensor) -> torch.Tensor:
    """Bit tensor -> grid vector: a C-order reshape (a numpy array becomes
    a CPU tensor)."""
    return torch.as_tensor(tensor).reshape(-1)


def function_to_qtt(f: Callable, d: int, a: float = 0.0, b: float = 1.0,
                    tol: float = 1e-12, *, device) -> TTVector:
    """TT-SVD of :func:`function_to_tensor` (``a``, ``b`` inert)."""
    del a, b
    return ttv_decomp(_bit_tensor(f, d), tol=tol, device=device)


def function_to_qtt_uniform(f: Callable, d: int, tol: float = 1e-12, *,
                            device) -> TTVector:
    """Left-endpoint sampling ``x_n = n / 2^d`` with LITTLE-endian bits
    (site 0 = least significant bit): the one little-endian encoding, the
    input the bit-reversing quantics DFT
    (:func:`ttnx_torch.ops.fourier.fourier_qtto`) expects."""
    n = 2 ** d
    vals = _sample_grid(f, np.arange(n) / n)
    little = vals.reshape((2,) * d).transpose(tuple(range(d - 1, -1, -1)))
    return ttv_decomp(little, tol=tol, device=device)


def qtt_to_vector(qtt: TTVector) -> torch.Tensor:
    """QTT -> grid vector (progressive contraction)."""
    return ttv_to_tensor(qtt).reshape(-1)


def qtt_to_function(qtt: TTVector) -> torch.Tensor:
    return qtt_to_vector(qtt)


# ---------------------------------------------------------------------------
# Analytic QTT encodings (exact low-rank cores)
# ---------------------------------------------------------------------------


def _qtt_rank_struct(d: int, r: int) -> list[np.ndarray]:
    """Zero cores of the (1, r, ..., r, 1) rank profile."""
    rks = [1] + [r] * (d - 1) + [1]
    return [np.zeros((rks[k], 2, rks[k + 1])) for k in range(d)]


def _on(cores, device, dtype=torch.float64) -> TTVector:
    return TTVector([torch.as_tensor(c, dtype=dtype, device=device)
                     for c in cores])


def qtt_polynom(coef: Sequence[float], d: int, a: float = 0.0,
                b: float = 1.0, *, device) -> TTVector:
    """Exact rank-p QTT of the polynomial ``sum_k coef[k] x^k`` on the
    uniform grid of [a, b] (binomial cascade cores)."""
    p = len(coef)
    h = (b - a) / (2 ** d - 1)
    cores = _qtt_rank_struct(d, p)

    def phi(x, s):
        return sum(coef[k] * x ** (k - s) * math.comb(k, s)
                   for k in range(s, p))

    cores[0][0, 0, :] = [phi(a, k) for k in range(p)]
    cores[0][0, 1, :] = [phi(a + h * 2 ** (d - 1), k) for k in range(p)]
    for k in range(1, d - 1):
        tk = h * 2 ** (d - 1 - k)
        for j in range(p):
            cores[k][j, 0, j] = 1.0
            for i in range(j, p):
                cores[k][i, 1, j] = math.comb(i, i - j) * tk ** (i - j)
    cores[d - 1][0, 0, 0] = 1.0
    cores[d - 1][:, 1, 0] = [h ** k for k in range(p)]
    return _on(cores, device)


def _qtt_trig(d: int, a: float, b: float, lam: float, first_row, last_col,
              dtype, device) -> TTVector:
    """Rank-2 rotation cores shared by sin and cos."""
    h = (b - a) / (2 ** d - 1)
    cores = _qtt_rank_struct(d, 2)

    def rot(t):
        c, s = math.cos(lam * math.pi * t), math.sin(lam * math.pi * t)
        return np.array([[c, -s], [s, c]])

    cores[0][0, 0, :] = first_row(a)
    cores[0][0, 1, :] = first_row(a + h * 2 ** (d - 1))
    for k in range(1, d - 1):
        tk = h * 2 ** (d - 1 - k)
        cores[k][:, 0, :] = np.eye(2)
        cores[k][:, 1, :] = rot(tk)
    cores[d - 1][0, 0, 0] = 1.0
    cores[d - 1][:, 1, 0] = last_col(h)
    return _on(cores, device, dtype)


def qtt_sin(d: int, a: float = 0.0, b: float = 1.0, lam: float = 1.0, *,
            dtype=torch.float64, device) -> TTVector:
    """Exact rank-2 QTT of ``sin(lam*pi*x)`` on the uniform grid of [a, b],
    on ``device`` (a required keyword)."""
    return _qtt_trig(
        d, a, b, lam,
        first_row=lambda t: [math.sin(lam * math.pi * t),
                             math.cos(lam * math.pi * t)],
        last_col=lambda t: [math.cos(lam * math.pi * t),
                            math.sin(lam * math.pi * t)],
        dtype=dtype, device=device)


def qtt_cos(d: int, a: float = 0.0, b: float = 1.0, lam: float = 1.0, *,
            dtype=torch.float64, device) -> TTVector:
    """Exact rank-2 QTT of ``cos(lam*pi*x)`` on the uniform grid of
    [a, b]."""
    return _qtt_trig(
        d, a, b, lam,
        first_row=lambda t: [math.cos(lam * math.pi * t),
                             -math.sin(lam * math.pi * t)],
        last_col=lambda t: [math.cos(lam * math.pi * t),
                            math.sin(lam * math.pi * t)],
        dtype=dtype, device=device)


def qtt_exp(d: int, a: float = 0.0, b: float = 1.0, alpha: float = 1.0,
            beta: float = 0.0, *, device) -> TTVector:
    """Exact rank-1 QTT of ``exp(alpha*x + beta)`` on the uniform grid of
    [a, b]."""
    h = (b - a) / (2 ** d - 1)
    cores = _qtt_rank_struct(d, 1)
    cores[0][0, 0, 0] = math.exp(alpha * a + beta)
    cores[0][0, 1, 0] = math.exp(alpha * (a + h * 2 ** (d - 1)) + beta)
    for k in range(1, d - 1):
        cores[k][0, 0, 0] = 1.0
        cores[k][0, 1, 0] = math.exp(alpha * h * 2 ** (d - 1 - k))
    cores[d - 1][0, 0, 0] = 1.0
    cores[d - 1][0, 1, 0] = math.exp(alpha * h)
    return _on(cores, device)


def qtt_chebyshev(n: int, d: int, *, device) -> TTVector:
    """Exact rank-2 QTT of the Chebyshev polynomial T_n on the shifted
    Chebyshev–Lobatto nodes."""
    cores = _qtt_rank_struct(d, 2)
    x_nodes, _ = gauss_chebyshev_lobatto(2 ** d, shifted=True)
    theta = np.arccos(np.clip(2 * x_nodes - 1, -1.0, 1.0))

    def rot(t):
        return np.array([[math.cos(n * t), -math.sin(n * t)],
                         [math.sin(n * t), math.cos(n * t)]])

    cores[0][0, 0, :] = [math.cos(n * theta[0]), -math.sin(n * theta[0])]
    idx = 2 ** (d - 1)
    cores[0][0, 1, :] = [math.cos(n * theta[idx]), -math.sin(n * theta[idx])]
    for k in range(1, d - 1):
        cores[k][:, 0, :] = np.eye(2)
        cores[k][:, 1, :] = rot(theta[2 ** (d - 1 - k)])
    cores[d - 1][:, 0, 0] = [1.0, 0.0]
    cores[d - 1][:, 1, 0] = [math.cos(n * theta[1]), math.sin(n * theta[1])]
    return _on(cores, device)


def qtt_basis_vector(d: int, pos: int, val: float = 1.0, *,
                     device) -> TTVector:
    """Rank-1 QTT of ``val * e_pos`` (0-based position)."""
    cores = _qtt_rank_struct(d, 1)
    for k in range(d):
        bit = (pos >> (d - 1 - k)) & 1
        cores[k][0, bit, 0] = val if k == 0 else 1.0
    return _on(cores, device)


def qtt_trapezoidal(d: int, a: float = 0.0, b: float = 1.0, *,
                    device) -> TTVector:
    """Quadrature weights as a rank-1 QTT: all ones scaled by the grid
    spacing ``h``, as the reference builds it."""
    cores = _qtt_rank_struct(d, 1)
    for c in cores:
        c[0, :, 0] = 1.0
    return algebra.scale((b - a) / (2 ** d - 1), _on(cores, device))


def qtto_to_matrix(A: TTOperator) -> torch.Tensor:
    """MPO -> dense matrix with big-endian row and column bits."""
    return tto_to_tensor(A).reshape(int(np.prod(A.out_dims)),
                                    int(np.prod(A.in_dims)))


# ---------------------------------------------------------------------------
# TT <-> QTT core splitting
# ---------------------------------------------------------------------------


def _svd_keep(m, threshold: float):
    """``(u, s, vt, keep)``: thin SVD of ``m`` and how many singular values
    exceed ``threshold`` times the largest (all when ``threshold`` is 0,
    at least one)."""
    u, s, vt = thin_svd(m)
    s_host = s.cpu().numpy()
    keep = s_host.size
    if threshold > 0:
        keep = max(1, int(np.sum(s_host > threshold * s_host[0])))
    return u, s, vt, keep


def to_qtt(tt: TTVector, split_dims: Sequence[Sequence[int]],
           threshold: float = 0.0) -> TTVector:
    """Split each core's physical dimension into the factors
    ``split_dims[i]`` by SVD, big-endian (first factor coarsest);
    ``threshold`` is relative to the largest singular value."""
    if len(split_dims) != tt.N:
        raise ValueError("split_dims must have one entry per TT core")
    for i in range(tt.N):
        if int(np.prod(split_dims[i])) != tt.dims[i]:
            raise ValueError(f"prod(split_dims[{i}]) must equal {tt.dims[i]}")
    out_cores = []
    for i in range(tt.N):
        core = tt.cores[i]
        rank_prev, remaining, rank_next = core.shape
        for split_size in list(split_dims[i])[:-1]:
            remaining //= split_size
            m = core.reshape(rank_prev * split_size, remaining * rank_next)
            u, s, vt, keep = _svd_keep(m, threshold)
            out_cores.append(u[:, :keep].reshape(rank_prev, split_size, keep))
            core = (s[:keep, None].to(vt.dtype) * vt[:keep, :]).reshape(
                keep, remaining, rank_next)
            rank_prev = keep
        out_cores.append(core)
    return TTVector(out_cores)


def to_ttv(qtt: TTVector, merge_numbers: Sequence[int]) -> TTVector:
    """Contract runs of ``merge_numbers[j]`` consecutive cores into one
    core of the product dimension, big-endian."""
    if sum(merge_numbers) != qtt.N:
        raise ValueError(
            f"merge_numbers must sum to {qtt.N} (the number of QTT cores)")
    out_cores = []
    k = 0
    for count in merge_numbers:
        core = qtt.cores[k]
        for nxt in qtt.cores[k + 1:k + count]:
            rl, n1, _ = core.shape
            _, n2, rr = nxt.shape
            core = torch.einsum("amb,bnc->amnc", core, nxt).reshape(
                rl, n1 * n2, rr)
        out_cores.append(core)
        k += count
    return TTVector(out_cores)


# ---------------------------------------------------------------------------
# Multi-dimensional QTT wrappers
# ---------------------------------------------------------------------------


def _check_qtt_meta(N, dims, n_dims, bits_per_dim, ordering):
    if n_dims * bits_per_dim != N:
        raise ValueError(
            f"n_dims * bits_per_dim must equal N "
            f"(got {n_dims}*{bits_per_dim}={n_dims * bits_per_dim} != {N})")
    if any(n != 2 for n in dims):
        raise ValueError(f"All physical dimensions must be 2 for QTT "
                         f"(got {dims})")
    if ordering not in ("interleaved", "serial"):
        raise ValueError(
            f"ordering must be 'interleaved' or 'serial' (got {ordering})")


class _QTTMeta:
    """Metadata half of the QTT wrappers: ``n_dims`` spatial dimensions of
    ``bits_per_dim`` bits each, sites in ``'serial'`` or ``'interleaved'``
    order. Every copy keeps the metadata."""

    __slots__ = ()
    _plain: type

    def _set_meta(self, n_dims, bits_per_dim, ordering):
        _check_qtt_meta(len(self.cores), self.dims, n_dims, bits_per_dim,
                        ordering)
        self.n_dims = int(n_dims)
        self.bits_per_dim = int(bits_per_dim)
        self.ordering = ordering

    def tt(self):
        """The plain TT (metadata stripped)."""
        return self._plain(self.cores, self.ot)

    def _rewrap(self, tt):
        return type(self)(tt, self.n_dims, self.bits_per_dim, self.ordering)

    def astype(self, dtype):
        return self._rewrap(self.tt().astype(dtype))

    def to(self, device):
        return self._rewrap(self.tt().to(device))

    def conj(self):
        return self._rewrap(self.tt().conj())

    def copy(self):
        return self._rewrap(self.tt())

    def with_ot(self, ot):
        return self._rewrap(self.tt().with_ot(ot))

    def __repr__(self):
        return (f"{type(self).__name__}(dtype={self.dtype}, {self.n_dims}d x "
                f"{self.bits_per_dim} bits, {self.ordering}, "
                f"ranks={self.ranks})")


class QTTVector(_QTTMeta, TTVector):
    """A QTT state with multi-dimensional metadata; arithmetic between
    compatible QTT states keeps it."""

    __slots__ = ("n_dims", "bits_per_dim", "ordering")
    _plain = TTVector

    def __init__(self, tt: TTVector | Sequence, n_dims: int,
                 bits_per_dim: int, ordering: str, ot=None):
        if isinstance(tt, TTVector):
            tt, ot = tt.cores, tt.ot
        super().__init__(tt, ot)
        self._set_meta(n_dims, bits_per_dim, ordering)

    def __add__(self, other):
        if isinstance(other, QTTVector):
            check_compat(self, other)
            return self._rewrap(algebra.add(self.tt(), other.tt()))
        return algebra.add(self.tt(), other)

    def __sub__(self, other):
        if isinstance(other, QTTVector):
            check_compat(self, other)
            return self._rewrap(algebra.sub(self.tt(), other.tt()))
        return algebra.sub(self.tt(), other)

    def __mul__(self, a):
        return self._rewrap(algebra.scale(a, self.tt()))

    __rmul__ = __mul__

    def __truediv__(self, a):
        return self._rewrap(algebra.scale(1.0 / a, self.tt()))

    def __neg__(self):
        return self._rewrap(algebra.scale(-1.0, self.tt()))

    def hadamard(self, other):
        check_compat(self, other)
        o = other.tt() if isinstance(other, QTTVector) else other
        return self._rewrap(algebra.hadamard(self.tt(), o))

    def orthogonalize(self, i: int = 0):
        return self._rewrap(orthogonalize(self.tt(), i))

    def compress(self, max_bond: int, **kwargs):
        return self._rewrap(tt_compress(self.tt(), max_bond, **kwargs))

    def increase_ranks(self, max_bond: int, **kwargs):
        return self._rewrap(increase_ranks(self.tt(), max_bond, **kwargs))

    def entanglement_entropy(self, base=None):
        return entanglement_entropy(self.tt(),
                                    math.e if base is None else base)


class QTTOperator(_QTTMeta, TTOperator):
    """A QTT operator with multi-dimensional metadata."""

    __slots__ = ("n_dims", "bits_per_dim", "ordering")
    _plain = TTOperator

    def __init__(self, tt: TTOperator | Sequence, n_dims: int,
                 bits_per_dim: int, ordering: str, ot=None):
        if isinstance(tt, TTOperator):
            tt, ot = tt.cores, tt.ot
        super().__init__(tt, ot)
        self._set_meta(n_dims, bits_per_dim, ordering)

    def __add__(self, other):
        if isinstance(other, QTTOperator):
            check_compat(self, other)
            return self._rewrap(algebra.add_op(self.tt(), other.tt()))
        return algebra.add_op(self.tt(), other)

    def __sub__(self, other):
        if isinstance(other, QTTOperator):
            check_compat(self, other)
            return self._rewrap(algebra.sub_op(self.tt(), other.tt()))
        return algebra.sub_op(self.tt(), other)

    def __mul__(self, a):
        if isinstance(a, (TTVector, TTOperator)):
            return self.__matmul__(a)
        return self._rewrap(algebra.scale_op(a, self.tt()))

    def __rmul__(self, a):
        return self._rewrap(algebra.scale_op(a, self.tt()))

    def __matmul__(self, other):
        if isinstance(other, QTTVector):
            check_compat(self, other)
            return other._rewrap(algebra.matvec(self.tt(), other.tt()))
        if isinstance(other, TTVector):
            return algebra.matvec(self.tt(), other)
        if isinstance(other, QTTOperator):
            check_compat(self, other)
            return self._rewrap(algebra.matmul(self.tt(), other.tt()))
        if isinstance(other, TTOperator):
            return algebra.matmul(self.tt(), other)
        raise TypeError(f"cannot contract QTTOperator with {type(other)}")


def check_compat(a, b) -> None:
    """Raise unless two QTT objects share their metadata; plain TT objects
    are always compatible."""
    if not (isinstance(a, _QTTMeta) and isinstance(b, _QTTMeta)):
        return
    if a.n_dims != b.n_dims:
        raise ValueError(f"QTT n_dims mismatch: {a.n_dims} != {b.n_dims}")
    if a.bits_per_dim != b.bits_per_dim:
        raise ValueError(f"QTT bits_per_dim mismatch: {a.bits_per_dim} != "
                         f"{b.bits_per_dim}")
    if a.ordering != b.ordering:
        raise ValueError(f"QTT ordering mismatch: {a.ordering} != "
                         f"{b.ordering}")


# ---------------------------------------------------------------------------
# Ordering conversion (serial <-> interleaved) by adjacent site swaps
# ---------------------------------------------------------------------------


def _swap_adjacent_sites(a, b, threshold: float = 0.0):
    """Swap the physical indices of adjacent vector cores: contract, then
    re-split the transposed pair by SVD."""
    rl, d1, _ = a.shape
    _, d2, rr = b.shape
    m = torch.einsum("lam,mbr->lbar", a, b).reshape(rl * d2, d1 * rr)
    u, s, vt, keep = _svd_keep(m, threshold)
    return (u[:, :keep].reshape(rl, d2, keep),
            (s[:keep, None].to(vt.dtype) * vt[:keep, :]).reshape(
                keep, d1, rr))


def _swap_adjacent_sites_op(a, b, threshold: float = 0.0):
    """The operator-core swap."""
    rl, d1, _, _ = a.shape
    _, d2, _, rr = b.shape
    m = torch.einsum("aijm,mklb->aklijb", a, b).reshape(rl * d2 * d2,
                                                        d1 * d1 * rr)
    u, s, vt, keep = _svd_keep(m, threshold)
    return (u[:, :keep].reshape(rl, d2, d2, keep),
            (s[:keep, None].to(vt.dtype) * vt[:keep, :]).reshape(
                keep, d1, d1, rr))


def _bubble_sort_swaps(perm: Sequence[int]) -> list[int]:
    """Adjacent-swap positions that bubble-sort ``perm`` ascending."""
    p = list(perm)
    swaps = []
    for _ in range(len(p)):
        for j in range(len(p) - 1):
            if p[j] > p[j + 1]:
                p[j], p[j + 1] = p[j + 1], p[j]
                swaps.append(j)
    return swaps


def _ordering_perm(n_dims: int, bits_per_dim: int, src: str,
                   dst: str) -> list[int]:
    """``perm[site]`` = the site's position in ordering ``dst``."""
    perm = [0] * (n_dims * bits_per_dim)
    for dim in range(n_dims):
        for b in range(bits_per_dim):
            if src == "serial" and dst == "interleaved":
                perm[dim * bits_per_dim + b] = b * n_dims + dim
            else:
                perm[b * n_dims + dim] = dim * bits_per_dim + b
    return perm


def _reorder(q, new_ordering, threshold, swap):
    if new_ordering not in ("interleaved", "serial"):
        raise ValueError("ordering must be 'interleaved' or 'serial'")
    if q.ordering == new_ordering:
        return q.copy()
    perm = _ordering_perm(q.n_dims, q.bits_per_dim, q.ordering,
                          new_ordering)
    cores = list(q.cores)
    for k in _bubble_sort_swaps(perm):
        cores[k], cores[k + 1] = swap(cores[k], cores[k + 1], threshold)
    return type(q)(q._plain(cores), q.n_dims, q.bits_per_dim, new_ordering)


def reorder_vec(q: QTTVector, new_ordering: str,
                threshold: float = 0.0) -> QTTVector:
    """Serial <-> interleaved conversion by a bubble-sorted network of
    adjacent-site swaps."""
    return _reorder(q, new_ordering, threshold, _swap_adjacent_sites)


def reorder_op(A: QTTOperator, new_ordering: str,
               threshold: float = 0.0) -> QTTOperator:
    """The operator reorder."""
    return _reorder(A, new_ordering, threshold, _swap_adjacent_sites_op)


def reorder(q, new_ordering: str, threshold: float = 0.0):
    """Reorder a QTTVector or a QTTOperator."""
    if isinstance(q, QTTVector):
        return reorder_vec(q, new_ordering, threshold)
    if isinstance(q, QTTOperator):
        return reorder_op(q, new_ordering, threshold)
    raise TypeError("reorder expects a QTTVector or QTTOperator")


# ---------------------------------------------------------------------------
# Multi-dimensional sampling and readout
# ---------------------------------------------------------------------------


def _serial_to_ordering_axes(n_dims: int, bits_per_dim: int) -> list[int]:
    """``axes[t]`` = the serial axis at interleaved position ``t``."""
    return [dim * bits_per_dim + level for level in range(bits_per_dim)
            for dim in range(n_dims)]


def function_to_qttv(f: Callable, n_dims: int, bits_per_dim: int,
                     ordering: str = "interleaved", a: float = 0.0,
                     b: float = 1.0, tol: float = 1e-12, *,
                     device) -> QTTVector:
    """Sample an n-D function on the uniform grid of [a, b]^n_dims and
    TT-SVD it into a ``QTTVector``. ``f`` receives a coordinate array of
    shape ``(m, n_dims)`` (vectorized) or, failing that, one length-n_dims
    vector at a time."""
    n_pts = 2 ** bits_per_dim
    h = (b - a) / (n_pts - 1)
    mesh = np.meshgrid(*([a + h * np.arange(n_pts)] * n_dims),
                       indexing="ij")
    coords = np.stack([m.reshape(-1) for m in mesh], axis=-1)
    try:
        vals = np.asarray(f(coords))
        if vals.shape != (coords.shape[0],):
            raise ValueError
    except Exception:
        vals = np.asarray([f(c) for c in coords])
    serial_bits = vals.reshape((2,) * (n_dims * bits_per_dim))
    if ordering == "interleaved":
        tensor = np.transpose(serial_bits,
                              _serial_to_ordering_axes(n_dims, bits_per_dim))
    elif ordering == "serial":
        tensor = serial_bits
    else:
        raise ValueError("ordering must be 'interleaved' or 'serial'")
    return QTTVector(ttv_decomp(tensor, tol=tol, device=device), n_dims,
                     bits_per_dim, ordering)


def qttv_to_array(q: QTTVector) -> torch.Tensor:
    """Contract the chain to the ``n_dims``-dimensional grid array."""
    full = ttv_to_tensor(q.tt())
    if q.ordering == "interleaved":
        axes = _serial_to_ordering_axes(q.n_dims, q.bits_per_dim)
        full = full.permute(*np.argsort(axes).tolist())
    return full.reshape((2 ** q.bits_per_dim,) * q.n_dims)
