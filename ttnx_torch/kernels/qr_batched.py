"""The gauge QR of the batched ALS: a thin QR of every matrix of a batch.

:func:`qr_batched` factors a stack of small matrices in one launch of a
hand-written Hopper kernel (``csrc/qr_batched.cu``: one CTA a matrix,
resident in shared memory) for a CUDA tensor, and takes
:func:`qr_batched_plain` (``torch.linalg.qr``) for a CPU tensor. It replaces
no TPU kernel: the JAX package leaves this QR to XLA's batched
``jnp.linalg.qr``, while on the card ``torch.linalg.qr`` forms Q with one
cuSOLVER ``orgqr`` chain a matrix.

Two layouts, chosen by ``rows``:

* ``rows=False``: ``V (B, m, k)`` gives ``Q (B, m, k)`` and ``R (B, k, k)``
  with ``Q R = V`` (the forward half-sweep's ``V.reshape(B, R n, R)``).
* ``rows=True``: ``V (B, k, m)`` gives ``Qt (B, k, m)`` and ``Rt (B, k,
  k)``, the transposes of the factors of ``V.transpose(1, 2)`` (the
  backward half-sweep's ``V.reshape(B, R, n R)``); the kernel reads the
  stack as it is, with no transpose copy.

The kernel follows LAPACK's ``xgeqrf``/``xorgqr`` conventions, so its
factors equal ``torch.linalg.qr``'s to rounding, column by column, also on
zero rows and columns. It takes float32 and float64 at ``1 <= k <= m <=``
:data:`MAX_ROWS`; a CUDA tensor of any other shape or dtype raises.
"""

from __future__ import annotations

import torch

from ttnx_torch.kernels import _build
from ttnx_torch.kernels.dispatch import counted, require_real, use_kernel

__all__ = ["qr_batched", "qr_batched_plain", "kernel_shape", "MAX_ROWS"]

MAX_ROWS = 128  # m of the kernel: a column is four rows a lane of a warp


def qr_batched_plain(V: torch.Tensor, *, rows: bool = False):
    """Plain version: ``torch.linalg.qr`` in :func:`qr_batched`'s layouts
    (every dtype; the ``rows=True`` factors are transposed views)."""
    if rows:
        q, r = torch.linalg.qr(V.transpose(1, 2))
        return q.transpose(1, 2), r.transpose(1, 2)
    return torch.linalg.qr(V)


def kernel_shape(V: torch.Tensor, rows: bool = False) -> tuple[int, int,
                                                                 int]:
    """``(B, m, k)`` of a stack the kernel takes; raises ``TypeError`` for
    a dtype and ``ValueError`` for a shape it does not take."""
    require_real("qr_batched", V)
    if V.dim() != 3:
        raise ValueError(f"qr_batched: V must be a (B, m, k) or, with "
                         f"rows=True, (B, k, m) stack, got {tuple(V.shape)}")
    B = V.shape[0]
    m, k = (V.shape[2], V.shape[1]) if rows else (V.shape[1], V.shape[2])
    if B < 1 or not 1 <= k <= m <= MAX_ROWS:
        raise ValueError(f"qr_batched: the kernel takes B >= 1 matrices of "
                         f"m rows and k columns, 1 <= k <= m <= {MAX_ROWS}; "
                         f"got {tuple(V.shape)} with rows={rows}")
    return B, m, k


@counted
def qr_batched(V: torch.Tensor, *, rows: bool = False):
    """Thin QR of each matrix of ``V``: the Hopper kernel for a CUDA tensor
    (real f32/f64, ``1 <= k <= m <= 128``), the plain version for a CPU
    tensor. Returns ``(Q, R)`` for ``rows=False`` and ``(Q^T, R^T)`` of
    ``V.transpose(1, 2)`` for ``rows=True``."""
    if not use_kernel(V):
        return qr_batched_plain(V, rows=rows), None
    B, m, k = kernel_shape(V, rows)
    V = V.contiguous()
    q = torch.empty_like(V)
    r = torch.empty((B, k, k), dtype=V.dtype, device=V.device)
    _build.call("qr_batched", V.dtype, V.data_ptr(), q.data_ptr(),
                r.data_ptr(), B, m, k, int(rows))
    return (q, r), "kernel"
