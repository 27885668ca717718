"""Kernel-or-plain gate and launch counters.

Every kernel wrapper in :mod:`ttnx_torch.kernels` decides from the device of
its inputs alone: a tensor on the CPU takes the kernel's plain PyTorch
version, a CUDA tensor launches the hand-written Hopper kernel or raises.
There is no fallback from a CUDA tensor to the plain version — a missing
``nvcc`` or a refused launch is an error, never a silent slow path.

:func:`counted` is the one record of a launch. The wrapped body returns
``(out, route)``: the route of the one kernel it launched (``"kernel"`` for
a wrapper with one kernel), or ``None`` when it took the plain version.
:func:`counted` files the launch under that route and returns ``out``, so
:func:`route_counts` shows which kernels a run went through and a shape
that left a fast route as a count (``chip_smoke.py`` resets and reads it
around the CN step), and :func:`launch_counts` sums it by wrapper.

:func:`counted` also puts two checks around every wrapper, on both routes
and both devices. A kernel has no backward (the JAX package defines no
``custom_vjp`` for its kernels either), so a tensor input that requires
grad while grad is enabled raises ``RuntimeError`` before any route is
picked: the plain version never stands in, and whether a gradient exists
never depends on the device. While ``utils.validation.debug_nans`` is on,
the wrapper's outputs are checked for NaN, since a ``ctypes`` launch is
invisible to the torch function mode that traps the other ops.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch

__all__ = ["use_kernel", "counted", "launch_counts", "route_counts",
           "reset_launch_counts",
           "require_real", "require_mm_type", "can_fuse_local_cg",
           "refuse_grad", "check_nan", "NAN_TRAP"]

# wrapper name -> {route: launches}, every wrapper from its registration
_ROUTES = {}

# the state of ``utils.validation.debug_nans`` (one trap per process, as
# ``jax_debug_nans`` is one flag)
NAN_TRAP = SimpleNamespace(on=False)


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


def _tensors(values):
    return [v for v in values if isinstance(v, torch.Tensor)]


def refuse_grad(name: str, tensors) -> None:
    """Raise when grad is enabled and any of ``tensors`` requires grad: the
    kernel behind ``name`` has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an input requires "
            f"grad; call it under torch.no_grad() or on detached inputs")


def check_nan(name: str, out) -> None:
    """Raise ``FloatingPointError`` when a floating or complex tensor of
    ``out`` (a tensor or a tuple/list of them) holds a NaN."""
    for t in _tensors(out if isinstance(out, (tuple, list)) else (out,)):
        if ((t.is_floating_point() or t.is_complex())
                and bool(torch.isnan(t).any())):
            raise FloatingPointError(f"debug_nans: NaN in the output of "
                                     f"{name}")


def counted(fn):
    """Register kernel wrapper ``fn``, whose body returns ``(out, route)``,
    and give it the gradient gate on all of its tensor arguments, the
    launch record and the NaN trap on its outputs; the gated wrapper
    returns ``out``."""
    name = fn.__name__
    routes = _ROUTES.setdefault(name, {})

    @functools.wraps(fn)
    def gated(*args, **kwargs):
        refuse_grad(name, _tensors(args) + _tensors(kwargs.values()))
        out, route = fn(*args, **kwargs)
        if route is not None:
            routes[route] = routes.get(route, 0) + 1
        if NAN_TRAP.on:
            check_nan(name, out)
        return out

    return gated


def launch_counts() -> dict[str, int]:
    """``{wrapper name: launches}`` for every kernel wrapper, counted since
    the last reset."""
    return {name: sum(r.values()) for name, r in _ROUTES.items()}


def route_counts() -> dict[str, dict[str, int]]:
    """``{wrapper name: {route: launches}}`` for every kernel wrapper,
    counted since the last reset."""
    return {name: dict(r) for name, r in _ROUTES.items()}


def reset_launch_counts() -> None:
    for r in _ROUTES.values():
        r.clear()


def can_fuse_local_cg(dtype, M: int) -> bool:
    """Dense-K CG (kernel B3) and BiCGStab (kernel B10) for real dtypes at
    ``M <= 1024``; larger real CG systems take the matrix-free CG (kernel
    B4), complex ones and larger BiCGStab systems the einsum 'cg' and
    'bicgstab' paths — the same split as the JAX package."""
    return not dtype.is_complex and M <= 1024
