"""Kernels B11, B12, B13: the batched core contractions.

* :func:`two_site_merge` (B13): ``C[p] = A[p] @ B[p]`` for ``A (B, m, k)``,
  ``B (B, k, n)``, returned in float32 for every input type.
* :func:`matmul_chain` (B12): ``iters`` rounds of ``x <- x @ w``, each
  product accumulated in float32 and cast to ``x``'s type — the measured
  ceiling of the contraction benchmark.
* :func:`merge_resplit_chain` (B11): ``iters`` rounds of ``c = acc @ b``
  (cast to ``b``'s type) and ``acc = c @ w`` (cast to ``a``'s type) for
  ``a (B, r n, r)``, ``b (B, r, n r)``, ``w (B, n r, r)`` — the chained
  merge and re-split behind the headline contraction metric.

Each wrapper launches its Hopper kernel (``csrc/contraction.cu``, one
launch a call) for CUDA tensors and runs its plain PyTorch version for CPU
tensors. The kernels take bfloat16 and float32, one type for all operands;
the plain versions compute every product in float32 on the exact
products of the operands and round where the kernels do. The TPU kernels'
``block_b`` and ``unroll`` only set their VMEM tiling and have no
counterpart here. The callers pass orthonormal ``b``, ``w`` so the
normalization-free chains stay bounded.

Each wrapper picks its kernel by dtype and shape, never on a failure
(:func:`chain_route`, :func:`matmul_chain_route`, :func:`merge_route`):

* B11 ``"wgmma"`` — bf16 with ``r <= 64`` and ``n <= 512`` (the iterate
  in registers, wgmma); ``"wmma"`` — other bf16 shapes; ``"f32"`` — IEEE
  f32 on the CUDA cores.
* B12 ``"wgmma"`` — bf16 with ``k <= 128`` (the same design: the iterate
  in registers, one wgmma m64n128k16 a k-step); ``"wmma"`` — larger bf16;
  ``"f32"``.
* B13 ``"mma"`` — bf16 whose operands and staging rows fit one block's
  shared memory (cp.async, mma.sync, whole-row stores); ``"wmma"`` —
  larger bf16; ``"f32"``.
"""

from __future__ import annotations

import torch

from ttnx_torch.kernels import _build
from ttnx_torch.kernels.dispatch import counted, require_mm_type, use_kernel

__all__ = ["two_site_merge", "two_site_merge_plain", "matmul_chain",
           "matmul_chain_plain", "merge_resplit_chain",
           "merge_resplit_chain_plain", "chain_route", "matmul_chain_route",
           "merge_route"]

SMEM_BLOCK = 232448  # shared memory one block can use on the H100
CHAIN_WGMMA_MAX_R, CHAIN_WGMMA_MAX_N = 64, 512
MATMUL_WGMMA_MAX_K = 128  # 64 accumulators + 32 operand registers a thread


def _up16(x: int) -> int:
    return (x + 15) // 16 * 16


def chain_route(dtype, r: int, n: int) -> str:
    """The kernel of :func:`merge_resplit_chain` for ``a (B, m, r)``, ``b
    (B, r, n)``: ``"wgmma"``, ``"wmma"`` or ``"f32"``."""
    if dtype == torch.float32:
        return "f32"
    if r <= CHAIN_WGMMA_MAX_R and n <= CHAIN_WGMMA_MAX_N:
        return "wgmma"
    return "wmma"


def matmul_chain_route(dtype, m: int, k: int) -> str:
    """The kernel of :func:`matmul_chain` for ``x (B, m, k)``, ``w (B, k,
    k)``: ``"wgmma"``, ``"wmma"`` or ``"f32"``; ``m`` is any (rows go in
    strips of 64)."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if k <= MATMUL_WGMMA_MAX_K else "wmma"


def merge_route(dtype, m: int, k: int, n: int) -> str:
    """The kernel of :func:`two_site_merge` for ``(B, m, k) @ (B, k, n)``:
    ``"mma"`` where A and B (bf16, padded to 16, rows skewed by 8 values)
    and the 8 warps' 16 x 72 f32 staging rows fit one block, else
    ``"wmma"``; ``"f32"``."""
    if dtype == torch.float32:
        return "f32"
    operands = _up16(m) * (_up16(k) + 8) + _up16(k) * (_up16(n) + 8)
    staging = 8 * 16 * 72
    return "mma" if 2 * operands + 4 * staging <= SMEM_BLOCK else "wmma"


def _bmm32(x, y):
    """``x @ y`` batched, accumulated in float32 (no TF32)."""
    return torch.bmm(x.float(), y.float())


def _check(name, shapes_ok, *tensors):
    require_mm_type(name, *tensors)
    if not shapes_ok:
        raise ValueError(f"{name}: operand shapes "
                         f"{[tuple(t.shape) for t in tensors]} do not chain")


def two_site_merge_plain(a, b):
    """Plain PyTorch version of :func:`two_site_merge`."""
    return _bmm32(a, b)


@counted
def two_site_merge(a, b):
    """Batched ``A (B, m, k) @ B (B, k, n)`` in float32."""
    B, m, k = a.shape
    _check("two_site_merge", b.dim() == 3 and b.shape[:2] == (B, k), a, b)
    if not use_kernel(a, b):
        return two_site_merge_plain(a, b), None
    n = b.shape[2]
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((B, m, n), dtype=torch.float32, device=a.device)
    route = merge_route(a.dtype, m, k, n)
    _build.call("two_site_merge_mma" if route == "mma"
                else "two_site_merge", a.dtype, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), B, m, k, n)
    return out, route


def matmul_chain_plain(x, w, iters: int = 8):
    """Plain PyTorch version of :func:`matmul_chain`."""
    for _ in range(iters):
        x = _bmm32(x, w).to(x.dtype)
    return x


@counted
def matmul_chain(x, w, iters: int = 8):
    """``iters`` rounds of ``x <- x @ w`` for ``x (B, m, k)``, ``w (B, k,
    k)``; returns ``x``'s type."""
    B, m, k = x.shape
    _check("matmul_chain", w.shape == (B, k, k), x, w)
    if not use_kernel(x, w):
        return matmul_chain_plain(x, w, iters), None
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    route = matmul_chain_route(x.dtype, m, k)
    _build.call("matmul_chain_wgmma" if route == "wgmma" else "matmul_chain",
                x.dtype, x.data_ptr(), w.data_ptr(), out.data_ptr(), B, m, k,
                int(iters))
    return out, route


def merge_resplit_chain_plain(a, b, w, iters: int = 8):
    """Plain PyTorch version of :func:`merge_resplit_chain`."""
    acc = a
    for _ in range(iters):
        c = _bmm32(acc, b).to(b.dtype)
        acc = _bmm32(c, w).to(a.dtype)
    return acc


@counted
def merge_resplit_chain(a, b, w, iters: int = 8):
    """``iters`` rounds of merge (``@ b``) and re-split (``@ w``) for ``a
    (B, m, r)``, ``b (B, r, n)``, ``w (B, n, r)``; returns ``a``'s type."""
    B, m, r = a.shape
    n = b.shape[2] if b.dim() == 3 else -1
    _check("merge_resplit_chain",
           b.shape == (B, r, n) and w.shape == (B, n, r), a, b, w)
    if not use_kernel(a, b, w):
        return merge_resplit_chain_plain(a, b, w, iters), None
    a, b, w = a.contiguous(), b.contiguous(), w.contiguous()
    out = torch.empty_like(a)
    route = chain_route(a.dtype, r, n)
    _build.call("merge_resplit_chain_wgmma" if route == "wgmma"
                else "merge_resplit_chain", a.dtype, a.data_ptr(),
                b.data_ptr(), w.data_ptr(), out.data_ptr(), B, m, r, n,
                int(iters))
    return out, route
