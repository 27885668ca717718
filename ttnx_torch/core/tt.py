"""TT/MPS containers, factories and rank utilities (PyTorch).

* ``TTVector`` cores are ``(r_left, n, r_right)`` tensors; ``TTOperator``
  cores are ``(r_left, n_out, n_in, r_right)``. Ranks and dims derive from
  the core shapes. Orthogonality flags ``ot`` (``-1`` right-canonical,
  ``0`` center/none, ``+1`` left-canonical) ride along as plain metadata.
* Bits are big-endian (site 0 = most significant bit), so a C-order
  ``reshape(-1)`` of the dense tensor is the grid vector.
* Every factory takes its device explicitly; random cores come from an
  explicit ``torch.Generator`` (the device of the generator is the device
  of the cores).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "TTVector",
    "TTOperator",
    "zeros_tt",
    "ones_tt",
    "rand_tt",
    "rand_tt_like",
    "zeros_tto",
    "rand_tto",
    "id_tto",
    "r_and_d_to_rks",
    "increase_ranks",
    "concatenate",
    "visualize",
]


def _as_tuple(x):
    if isinstance(x, (int, np.integer)):
        return (int(x),)
    return tuple(int(v) for v in x)


class _TTBase:
    __slots__ = ("cores", "ot")

    def __init__(self, cores: Sequence[torch.Tensor],
                 ot: Sequence[int] | None = None):
        self.cores = tuple(cores)
        self.ot = (tuple(int(o) for o in ot) if ot is not None
                   else (0,) * len(self.cores))

    @property
    def N(self) -> int:
        return len(self.cores)

    @property
    def dtype(self) -> torch.dtype:
        return self.cores[0].dtype

    @property
    def device(self) -> torch.device:
        return self.cores[0].device

    @property
    def is_complex(self) -> bool:
        return self.dtype.is_complex

    def astype(self, dtype):
        return type(self)([c.to(dtype) for c in self.cores], self.ot)

    def to(self, device):
        """Copy to ``device`` (explicit; nothing moves implicitly)."""
        return type(self)([c.to(device) for c in self.cores], self.ot)

    def conj(self):
        return type(self)([c.conj().resolve_conj() for c in self.cores],
                          self.ot)

    def copy(self):
        return type(self)(self.cores, self.ot)

    def with_ot(self, ot: Sequence[int]):
        return type(self)(self.cores, ot)


class TTVector(_TTBase):
    """A tensor in TT (tensor-train / MPS) format.

    ``cores[k]`` has shape ``(r_k, n_k, r_{k+1})`` with ``r_0 = r_N = 1``.
    """

    __slots__ = ()

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(int(c.shape[1]) for c in self.cores)

    @property
    def ranks(self) -> tuple[int, ...]:
        return (tuple(int(c.shape[0]) for c in self.cores)
                + (int(self.cores[-1].shape[2]),))

    def __add__(self, other):
        from ttnx_torch.core import algebra

        return algebra.add(self, other)

    def __sub__(self, other):
        from ttnx_torch.core import algebra

        return algebra.sub(self, other)

    def __mul__(self, a):
        from ttnx_torch.core import algebra

        return algebra.scale(a, self)

    __rmul__ = __mul__

    def __truediv__(self, a):
        from ttnx_torch.core import algebra

        return algebra.scale(1.0 / a, self)

    def __neg__(self):
        from ttnx_torch.core import algebra

        return algebra.scale(-1.0, self)

    def __matmul__(self, other):
        from ttnx_torch.core import algebra

        if isinstance(other, TTVector):
            return algebra.dot(self, other)
        raise TypeError(f"cannot contract TTVector with {type(other)}")

    def __repr__(self):
        return (f"TTVector(dtype={self.dtype}, sites={self.N}, "
                f"dims={self.dims}, ranks={self.ranks}, "
                f"ot={_ot_description(self.ot)})")


class TTOperator(_TTBase):
    """A linear operator in TT (MPO) format.

    ``cores[k]`` has shape ``(r_k, n_out_k, n_in_k, r_{k+1})``.
    """

    __slots__ = ()

    @property
    def out_dims(self) -> tuple[int, ...]:
        return tuple(int(c.shape[1]) for c in self.cores)

    @property
    def in_dims(self) -> tuple[int, ...]:
        return tuple(int(c.shape[2]) for c in self.cores)

    @property
    def dims(self) -> tuple[int, ...]:
        return self.out_dims

    @property
    def ranks(self) -> tuple[int, ...]:
        return (tuple(int(c.shape[0]) for c in self.cores)
                + (int(self.cores[-1].shape[3]),))

    def transpose(self) -> "TTOperator":
        """Operator transpose (swap output and input physical legs)."""
        return TTOperator([c.transpose(1, 2) for c in self.cores], self.ot)

    @property
    def T(self) -> "TTOperator":
        return self.transpose()

    def adjoint(self) -> "TTOperator":
        return TTOperator([c.transpose(1, 2).conj().resolve_conj()
                           for c in self.cores], self.ot)

    @property
    def H(self) -> "TTOperator":
        return self.adjoint()

    def __add__(self, other):
        from ttnx_torch.core import algebra

        return algebra.add_op(self, other)

    def __sub__(self, other):
        from ttnx_torch.core import algebra

        return algebra.sub_op(self, other)

    def __mul__(self, a):
        from ttnx_torch.core import algebra

        if isinstance(a, (TTVector, TTOperator)):
            return self.__matmul__(a)
        return algebra.scale_op(a, self)

    def __rmul__(self, a):
        from ttnx_torch.core import algebra

        return algebra.scale_op(a, self)

    def __neg__(self):
        from ttnx_torch.core import algebra

        return algebra.scale_op(-1.0, self)

    def __matmul__(self, other):
        from ttnx_torch.core import algebra

        if isinstance(other, TTVector):
            return algebra.matvec(self, other)
        if isinstance(other, TTOperator):
            return algebra.matmul(self, other)
        raise TypeError(f"cannot contract TTOperator with {type(other)}")

    def __call__(self, x: TTVector) -> TTVector:
        from ttnx_torch.core import algebra

        return algebra.matvec(self, x)

    def __repr__(self):
        return (f"TTOperator(dtype={self.dtype}, sites={self.N}, "
                f"dims={self.dims}, ranks={self.ranks}, "
                f"ot={_ot_description(self.ot)})")


def _ot_description(ot) -> str:
    """Human-readable canonical-form summary of the per-site ot flags."""
    ot = tuple(int(o) for o in ot)
    if all(o == 0 for o in ot):
        return "none"
    if all(o == 1 for o in ot):
        return "left-canonical"
    if all(o == -1 for o in ot):
        return "right-canonical"
    zeros_at = [i for i, o in enumerate(ot) if o == 0]
    if len(zeros_at) == 1:
        c = zeros_at[0]
        if all(o == 1 for o in ot[:c]) and all(o == -1 for o in ot[c + 1:]):
            return f"center @ site {c}"
    return str(list(ot))


# ---------------------------------------------------------------------------
# Rank feasibility
# ---------------------------------------------------------------------------


def r_and_d_to_rks(rks, dims, rmax: int = 1024) -> tuple[int, ...]:
    """Clamp a rank vector to the feasible TT ranks of a tensor with ``dims``:
    ``r_k <= min(prod(dims[:k]), prod(dims[k:]), rmax)``."""
    dims = _as_tuple(dims)
    rks = [int(r) for r in rks]
    assert len(rks) == len(dims) + 1, "rks must have length len(dims)+1"
    out = []
    for k in range(len(rks)):
        left = int(np.prod(dims[:k], dtype=object)) if k > 0 else 1
        right = int(np.prod(dims[k:], dtype=object)) if k < len(dims) else 1
        out.append(int(min(rks[k], left, right, rmax)))
    return tuple(out)


def _full_rks(dims, rmax: int) -> tuple[int, ...]:
    dims = _as_tuple(dims)
    return r_and_d_to_rks([rmax] * (len(dims) + 1), dims, rmax=rmax)


# ---------------------------------------------------------------------------
# Factories
# ---------------------------------------------------------------------------


def zeros_tt(dims, rks=None, *, rmax: int | None = None,
             dtype=torch.float64, device="cpu", ot=None) -> TTVector:
    """All-zero TT vector with explicit ranks ``rks`` or a uniform cap
    ``rmax``."""
    dims = _as_tuple(dims)
    if rks is None:
        rks = _full_rks(dims, 1 if rmax is None else rmax)
    else:
        rks = tuple(int(r) for r in rks)
        assert len(rks) == len(dims) + 1
    cores = [torch.zeros((rks[k], dims[k], rks[k + 1]), dtype=dtype,
                         device=device) for k in range(len(dims))]
    return TTVector(cores, ot)


def ones_tt(dims, dtype=torch.float64, device="cpu") -> TTVector:
    """Rank-1 TT of all ones."""
    dims = _as_tuple(dims)
    return TTVector([torch.ones((1, n, 1), dtype=dtype, device=device)
                     for n in dims])


def _normal(generator, shape, dtype):
    device = generator.device
    if dtype.is_complex:
        real_dt = torch.empty((), dtype=dtype).real.dtype
        re = torch.randn(shape, generator=generator, dtype=real_dt,
                         device=device)
        im = torch.randn(shape, generator=generator, dtype=real_dt,
                         device=device)
        return torch.complex(re, im)
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def rand_tt(generator: torch.Generator, dims, rks=None, *,
            rmax: int | None = None, normalise=False, orthogonal=False,
            dtype=torch.float64) -> TTVector:
    """Random-Gaussian TT vector on ``generator.device``. Complex cores
    have independent standard-normal real and imaginary parts."""
    dims = _as_tuple(dims)
    if rks is None:
        rks = _full_rks(dims, 4 if rmax is None else rmax)
    else:
        rks = r_and_d_to_rks(rks, dims, rmax=10**9)
    cores = []
    for k in range(len(dims)):
        shape = (rks[k], dims[k], rks[k + 1])
        c = _normal(generator, shape, dtype)
        if normalise:
            c = c / math.sqrt(dims[k] * rks[k + 1])
            if orthogonal:
                q, _ = torch.linalg.qr(c.reshape(rks[k] * dims[k], rks[k + 1]))
                c = q.reshape(rks[k], dims[k], -1)
        cores.append(c)
    return TTVector(cores)


def rand_tt_like(generator: torch.Generator, x: TTVector,
                 eps: float = 1e-5) -> TTVector:
    """Perturb ``x`` with real Gaussian noise of scale ``eps``."""
    cores = []
    for c in x.cores:
        real_dt = c.real.dtype
        noise = torch.randn(c.shape, generator=generator, dtype=real_dt,
                            device=generator.device).to(c.device)
        cores.append(c + eps * noise.to(c.dtype))
    return TTVector(cores)


def zeros_tto(dims, rks=None, *, rmax: int | None = None,
              dtype=torch.float64, device="cpu") -> TTOperator:
    """All-zero TT operator."""
    dims = _as_tuple(dims)
    if rks is None:
        sq = tuple(n * n for n in dims)
        cap = 1 if rmax is None else rmax
        rks = r_and_d_to_rks([cap] * (len(dims) + 1), sq, rmax=cap)
    else:
        rks = tuple(int(r) for r in rks)
    cores = [torch.zeros((rks[k], dims[k], dims[k], rks[k + 1]), dtype=dtype,
                         device=device) for k in range(len(dims))]
    return TTOperator(cores)


def rand_tto(generator: torch.Generator, dims, rmax: int,
             dtype=torch.float64) -> TTOperator:
    """Random TT operator with feasibility-clamped ranks on
    ``generator.device``."""
    dims = _as_tuple(dims)
    d = len(dims)
    rks = [1]
    for i in range(1, d):
        left = int(np.prod(dims[:i], dtype=object))
        right = int(np.prod(dims[i:], dtype=object))
        rks.append(min(left, right, rmax))
    rks.append(1)
    cores = [_normal(generator, (rks[k], dims[k], dims[k], rks[k + 1]), dtype)
             for k in range(d)]
    return TTOperator(cores)


def id_tto(d: int, n_dim: int = 2, dtype=torch.float64,
           device="cpu") -> TTOperator:
    """Rank-1 identity MPO."""
    eye = torch.eye(n_dim, dtype=dtype, device=device).reshape(
        1, n_dim, n_dim, 1)
    return TTOperator([eye] * d)


# ---------------------------------------------------------------------------
# Rank enrichment
# ---------------------------------------------------------------------------


def _rand_orthogonal(generator, n: int, m: int, dtype, device) -> torch.Tensor:
    big = max(n, m)
    u = torch.rand((big, big), generator=generator,
                   dtype=torch.empty((), dtype=dtype).real.dtype,
                   device=generator.device).to(device=device, dtype=dtype)
    q, _ = torch.linalg.qr(u)
    return q[:n, :m]


def increase_ranks(x: TTVector, max_bond: int, *, rks=None,
                   noise: float = 0.0,
                   generator: torch.Generator | None = None) -> TTVector:
    """Pad cores to larger bond dims, optionally filling the new slices with
    noise-scaled random-orthogonal blocks. With ``noise == 0`` this is exact
    zero-padding; ``generator`` is required when ``noise > 0``."""
    d = x.N
    dims = x.dims
    old = x.ranks
    if max_bond <= max(old):
        raise ValueError("New bond dimension too low")
    if rks is None:
        rks = [1] + [max_bond] * (d - 1) + [1]
    rks = r_and_d_to_rks(rks, dims, rmax=max_bond)
    if noise != 0.0 and generator is None:
        raise ValueError("increase_ranks with noise>0 needs an explicit "
                         "torch.Generator")
    cores = []
    for i in range(d):
        c = x.cores[i]
        rl_old, n, rr_old = c.shape
        rl, rr = rks[i], rks[i + 1]
        out = torch.zeros((rl, n, rr), dtype=c.dtype, device=c.device)
        out[:rl_old, :, :rr_old] = c
        if noise != 0.0:
            if rl == rl_old and rr > rr_old:
                q = _rand_orthogonal(generator, n * rl, rr - rr_old, c.dtype,
                                     c.device)
                out[:, :, rr_old:] = noise * q.reshape(rl, n, rr - rr_old)
            elif rr == rr_old and rl > rl_old:
                q = _rand_orthogonal(generator, rl - rl_old, n * rr, c.dtype,
                                     c.device)
                out[rl_old:, :, :] = noise * q.reshape(rl - rl_old, n, rr)
            elif rr > rr_old and rl > rl_old:
                q = _rand_orthogonal(generator, (rl - rl_old) * n,
                                     rr - rr_old, c.dtype, c.device)
                out[rl_old:, :, rr_old:] = noise * q.reshape(
                    rl - rl_old, n, rr - rr_old)
        cores.append(out)
    return TTVector(cores)


# ---------------------------------------------------------------------------
# Structure utilities
# ---------------------------------------------------------------------------


def concatenate(a, b):
    """Glue two TT chains end-to-end (boundary ranks must match)."""
    if isinstance(a, TTVector) and isinstance(b, TTVector):
        cls = TTVector
    elif isinstance(a, TTOperator) and isinstance(b, TTOperator):
        cls = TTOperator
    else:
        raise TypeError("concatenate expects two TTVectors or two TTOperators")
    if a.ranks[-1] != b.ranks[0]:
        raise ValueError("The final rank of the first TT must equal the "
                         "initial rank of the second.")
    return cls(a.cores + b.cores, a.ot + b.ot)


def visualize(tt) -> str:
    """ASCII bond diagram; returns the string (and prints it)."""
    dims = tt.dims
    ranks = tt.ranks
    rwidth = max(max(len(str(r)) for r in ranks), 2)
    line1 = str(ranks[0]).rjust(rwidth)
    line2 = " " * len(line1)
    line3 = " " * len(line1)
    for i in range(len(dims)):
        seg = "-- • --" + str(ranks[i + 1]).rjust(rwidth)
        line1 += seg
        pos = len(line1) - rwidth - 4
        line2 += " " * (pos - len(line2)) + "|"
        dstr = str(dims[i])
        line3 += " " * (pos - len(line3) - len(dstr) // 2) + dstr
    out = "\n".join([line1, line2, line3])
    print(out)
    return out
