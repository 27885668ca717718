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
           "require_real", "can_fuse_local_cg"]

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


def require_real(name: str, *tensors: torch.Tensor) -> None:
    """The Hopper kernels take float32 and float64 only."""
    for t in tensors:
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: the CUDA kernel takes float32 or "
                            f"float64, got {t.dtype}")
        if t.dtype != tensors[0].dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and "
                            f"{tensors[0].dtype}")


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
    """Dense-K CG (kernel B3) for real dtypes at ``M <= 1024``; larger real
    systems take the matrix-free CG (kernel B4), complex ones the einsum
    'cg' path — the same split as the JAX package."""
    return not dtype.is_complex and M <= 1024
