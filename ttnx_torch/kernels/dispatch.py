"""Kernel-or-plain gate and launch counters.

Every kernel wrapper in :mod:`ttnx_torch.kernels` decides from the device of
its inputs alone: a tensor on the CPU takes the kernel's plain PyTorch
version, a CUDA tensor launches the hand-written Hopper kernel or raises.
There is no fallback from a CUDA tensor to the plain version — a missing
``nvcc`` or a refused launch is an error, never a silent slow path.

Each wrapper carries a plain integer ``launches`` attribute that it bumps
once per kernel launch, so a run can show that its main path went through
the kernels (``chip_smoke.py`` resets and reads them around the CN step).
"""

from __future__ import annotations

import torch

__all__ = ["use_kernel", "counted", "launch_counts", "reset_launch_counts",
           "require_real", "require_mm_type", "can_fuse_local_cg"]

_COUNTED = []


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the inputs lie on a CUDA device (launch the kernel), False
    when they lie on the CPU (take the plain version). Mixed or other
    devices raise."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all lie on one CUDA device or all "
                     f"on the CPU, got devices {sorted(types)}")


def _require_types(name, allowed, tensors) -> None:
    for t in tensors:
        if t.dtype not in allowed:
            raise TypeError(f"{name}: the CUDA kernel takes "
                            f"{' or '.join(map(str, allowed))}, got {t.dtype}")
        if t.dtype != tensors[0].dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and "
                            f"{tensors[0].dtype}")


def require_real(name: str, *tensors: torch.Tensor) -> None:
    """The linear-algebra kernels take float32 and float64 only."""
    _require_types(name, (torch.float32, torch.float64), tensors)


def require_mm_type(name: str, *tensors: torch.Tensor) -> None:
    """The contraction kernels take bfloat16 and float32, one type for all
    operands: the TPU kernels' types (they have no float64)."""
    _require_types(name, (torch.bfloat16, torch.float32), tensors)


def counted(fn):
    """Give a kernel wrapper its ``launches`` counter and register it."""
    fn.launches = 0
    _COUNTED.append(fn)
    return fn


def launch_counts() -> dict[str, int]:
    """``{wrapper name: launches}`` for every registered kernel wrapper."""
    return {fn.__name__: fn.launches for fn in _COUNTED}


def reset_launch_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0


def can_fuse_local_cg(dtype, M: int) -> bool:
    """Dense-K CG (kernel B3) and BiCGStab (kernel B10) for real dtypes at
    ``M <= 1024``; larger real CG systems take the matrix-free CG (kernel
    B4), complex ones and larger BiCGStab systems the einsum 'cg' and
    'bicgstab' paths — the same split as the JAX package."""
    return not dtype.is_complex and M <= 1024
