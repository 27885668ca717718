"""numpy <-> ttnx_torch bridge.

Hands one problem, held as plain numpy arrays, to the package (and back),
so a caller can feed identical inputs to another implementation. Takes and
returns plain numpy only.
"""

from __future__ import annotations

import numpy as np
import torch

from ttnx_torch.core.tt import TTOperator, TTVector
from ttnx_torch.ops.qtt import QTTOperator, QTTVector

__all__ = ["ttvector_from_numpy", "ttoperator_from_numpy",
           "qttvector_from_numpy", "qttoperator_from_numpy",
           "stack_from_numpy", "to_numpy"]


def _tensor(a, device, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def ttvector_from_numpy(cores, ot=None, *, device,
                        dtype=None) -> TTVector:
    """TTVector from a sequence of ``(r_left, n, r_right)`` arrays."""
    return TTVector([_tensor(c, device, dtype) for c in cores], ot)


def ttoperator_from_numpy(cores, ot=None, *, device,
                          dtype=None) -> TTOperator:
    """TTOperator from a sequence of ``(r_left, n_out, n_in, r_right)``
    arrays."""
    return TTOperator([_tensor(c, device, dtype) for c in cores], ot)


def qttvector_from_numpy(cores, n_dims: int, bits_per_dim: int,
                         ordering: str, ot=None, *, device,
                         dtype=None) -> QTTVector:
    """QTTVector from ``(r_left, 2, r_right)`` arrays and its metadata."""
    return QTTVector(ttvector_from_numpy(cores, ot, device=device,
                                         dtype=dtype),
                     n_dims, bits_per_dim, ordering)


def qttoperator_from_numpy(cores, n_dims: int, bits_per_dim: int,
                           ordering: str, ot=None, *, device,
                           dtype=None) -> QTTOperator:
    """QTTOperator from ``(r_left, 2, 2, r_right)`` arrays and its
    metadata."""
    return QTTOperator(ttoperator_from_numpy(cores, ot, device=device,
                                             dtype=dtype),
                       n_dims, bits_per_dim, ordering)


def stack_from_numpy(arr, *, device, dtype=None) -> torch.Tensor:
    """Any array (a padded stack, masks, an env) as a tensor on ``device``."""
    return _tensor(arr, device, dtype)


def to_numpy(x):
    """A tensor as an array; a TTVector/TTOperator as a list of core
    arrays; tuples and lists element by element."""
    if isinstance(x, (TTVector, TTOperator)):
        return [c.detach().cpu().numpy() for c in x.cores]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    raise TypeError(f"to_numpy: unsupported {type(x)}")
