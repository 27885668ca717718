"""numpy <-> ttnx_torch bridge, and the importers of external cores.

Hands one problem, held as plain numpy arrays, to the package (and back),
so a caller can feed identical inputs to another implementation. Takes and
returns plain numpy only. :func:`to_ttvector`, :func:`from_reference_layout`
and :func:`to_reference_layout` are the twins of ``ttnx.utils.convert``:
cores in another package's ``(left, phys, right)`` layout, or in the Julia
reference's ``(phys, left, right)`` one.
"""

from __future__ import annotations

import numpy as np
import torch

from ttnx_torch.core.tt import TTOperator, TTVector
from ttnx_torch.ops.qtt import QTTOperator, QTTVector

__all__ = ["ttvector_from_numpy", "ttoperator_from_numpy",
           "qttvector_from_numpy", "qttoperator_from_numpy",
           "stack_from_numpy", "to_numpy", "to_ttvector",
           "from_reference_layout", "to_reference_layout"]


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


def to_ttvector(cores, *, device) -> TTVector:
    """Wrap external cores in ``(left, phys, right)`` layout (the
    TensorCrossInterpolation / torchtt / ttpy convention; arrays or
    tensors) as a ``TTVector`` on ``device``, checking the bond chain
    (reference to_ttvector)."""
    out = [torch.as_tensor(c, device=device) for c in cores]
    for k, c in enumerate(out):
        if c.dim() != 3:
            raise ValueError(f"core {k} must be rank-3, got shape {tuple(c.shape)}")
        if k > 0 and out[k - 1].shape[2] != c.shape[0]:
            raise ValueError(
                f"bond mismatch between cores {k - 1} and {k}: "
                f"{out[k - 1].shape[2]} != {c.shape[0]}")
    if out[0].shape[0] != 1 or out[-1].shape[2] != 1:
        raise ValueError("boundary ranks must be 1")
    return TTVector(out)


def from_reference_layout(cores, *, device) -> TTVector:
    """Import cores stored in the Julia reference's ``(phys, left, right)``
    layout (/root/reference/src/tt_tools.jl:23-29)."""
    return to_ttvector([torch.as_tensor(c, device=device).permute(1, 0, 2)
                        for c in cores], device=device)


def to_reference_layout(x: TTVector) -> list:
    """Export cores in the reference's ``(phys, left, right)`` layout."""
    return [c.permute(1, 0, 2) for c in x.cores]
