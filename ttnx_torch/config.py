"""Explicit configuration objects: every solver option is a field of a
frozen dataclass, passed as ``config=`` (no globals).

Twin of ``ttnx.config``; :func:`matmul_precision` sets PyTorch's TF32
flags where the reference sets JAX's default matmul precision.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import asdict, dataclass

import torch

__all__ = ["ALSConfig", "MALSConfig", "DMRGConfig", "TDVPConfig",
           "KrylovConfig", "to_kwargs", "matmul_precision"]


@dataclass(frozen=True)
class ALSConfig:
    """Options for :func:`ttnx_torch.solvers.als.als_linsolve`."""

    sweep_count: int = 2
    return_info: bool = False


@dataclass(frozen=True)
class MALSConfig:
    tol: float = 1e-12
    rmax: int | None = None
    return_info: bool = False


@dataclass(frozen=True)
class DMRGConfig:
    n_sites: int = 2
    tol: float = 1e-12
    sweep_schedule: tuple = (2,)
    rmax_schedule: tuple | None = None
    it_solver: bool = True
    linsolv_maxiter: int = 200
    itslv_thresh: int = 256


@dataclass(frozen=True)
class TDVPConfig:
    normalize: bool = True
    sweeps: int = 1
    carry_env: bool = True
    imaginary_time: bool = False
    max_bond: int | None = None
    truncerr: float = 0.0


@dataclass(frozen=True)
class KrylovConfig:
    max_bond: int = 0
    krylov_solver: str = "auto"
    krylovdim: int = 8
    maxiter: int = 20
    rtol: float = 1e-8
    atol: float = 1e-12


def to_kwargs(cfg) -> dict:
    """Dataclass config -> keyword arguments, dropping Nones for schedule
    fields that solvers default themselves."""
    out = {}
    for k, v in asdict(cfg).items():
        if v is None:
            continue
        out[k] = list(v) if isinstance(v, tuple) else v
    return out


@contextmanager
def matmul_precision(level: str = "highest"):
    """Scoped matmul precision ('default' | 'high' | 'highest'):
    ``'highest'`` turns TF32 off for float32 matmuls, the other levels
    allow it; the previous setting comes back on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = level != "highest"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
