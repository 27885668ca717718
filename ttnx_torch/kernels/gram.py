"""Kernel B1: the right-Gram chain of Gram-chain TT rounding.

Gram-based rounding needs the right Gram matrices of the applied chain::

    G_d = e_0 e_0^T                      (right boundary bond, true rank 1)
    G_k = sum_i  y_k[:, i, :] @ G_{k+1} @ y_k[:, i, :]^H     k = d-1 .. 1

The backward sweep is pure matrix products. :func:`gram_chain_fused` runs
it through a hand-written Hopper kernel for a CUDA tensor and through
:func:`gram_chain_plain` for a CPU tensor. The kernel is chosen by dtype
and shape before the launch, never on a failure (:func:`gram_route`; the
wrapper keeps the route of its last launch in its ``route`` attribute):
``"grid"`` — f32 at n = 2 and R = 64, 128 or 256 (the heat CN step's
stacks): one persistent cooperative launch walks the whole chain with
every site spread over the card (``csrc/gram_chain_grid.cu``);
``"staged"`` — two launches a site (``csrc/gram_chain.cu``) for f64 and
every other shape, e.g. the convection step's R = 96.
"""

from __future__ import annotations

import torch

from ttnx_torch.kernels import _build
from ttnx_torch.kernels.dispatch import counted, require_real, use_kernel

__all__ = ["gram_chain_fused", "gram_chain_plain", "gram_route",
           "GRID_RANKS"]

GRID_RANKS = (64, 128, 256)  # R of route grid (n = 2, f32)


def gram_route(dtype, d: int, R: int, n: int) -> str:
    """The kernel of B1 for a chain ``(d, R, n, R)``: ``"grid"`` or
    ``"staged"``."""
    if dtype == torch.float32 and n == 2 and R in GRID_RANKS and d >= 1:
        return "grid"
    return "staged"


def gram_chain_plain(y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``Gs (d, R, R)`` with ``Gs[k] = G_{k+1}``.
    Works for every dtype (complex conjugates the second factor)."""
    d, R, n, _ = y.shape
    Gs = torch.empty((d, R, R), dtype=y.dtype, device=y.device)
    G = torch.zeros((R, R), dtype=y.dtype, device=y.device)
    G[0, 0] = 1.0
    Gs[d - 1] = G
    for k in range(d - 1, 0, -1):
        t = torch.einsum("aib,bc->aic", y[k], G)
        G = torch.einsum("aic,xic->ax", t, y[k].conj())
        Gs[k - 1] = G
    return Gs


@counted
def gram_chain_fused(y: torch.Tensor) -> torch.Tensor:
    """Right-Gram stack of a padded chain ``y (d, R, n, R)``: the Hopper
    kernel for a CUDA tensor (real f32/f64), the plain version for a CPU
    tensor. Returns ``Gs (d, R, R)`` with ``Gs[k] = G_{k+1}``."""
    if not use_kernel(y):
        return gram_chain_plain(y)
    require_real("gram_chain_fused", y)
    if y.dim() != 4 or y.shape[1] != y.shape[3]:
        raise ValueError(f"gram_chain_fused: y must be (d, R, n, R), got "
                         f"{tuple(y.shape)}")
    y = y.contiguous()
    d, R, n, _ = y.shape
    out = torch.empty((d, R, R), dtype=y.dtype, device=y.device)
    scratch = torch.empty((n, R, R), dtype=y.dtype, device=y.device)
    route = gram_route(y.dtype, d, R, n)
    if route == "grid":
        if y.data_ptr() % 16:  # the kernel reads y in 16-byte copies
            raise ValueError("gram_chain_fused: route grid needs y 16-byte "
                             "aligned (a view at an offset of 4k floats)")
        _build.call("gram_chain_grid", y.dtype, y.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), d, R, n)
    else:
        _build.call("gram_chain", y.dtype, y.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), d, R, n)
    gram_chain_fused.launches += 1
    gram_chain_fused.route = route
    return out


gram_chain_fused.route = None
