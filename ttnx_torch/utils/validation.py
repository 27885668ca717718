"""Shape assertions, finiteness guards and the NaN trap for TT objects.

Twin of ``ttnx.utils.validation``. :func:`debug_nans` stands in for JAX's
``jax_debug_nans`` flag, which torch lacks: a torch function mode checks
the result of every torch function, the kernel wrappers check their own
outputs (their ``ctypes`` launches are invisible to the mode), and
autograd's anomaly mode checks the backward pass.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
from torch.overrides import TorchFunctionMode

from ttnx_torch.core.tt import TTOperator, TTVector
from ttnx_torch.kernels import dispatch

__all__ = ["assert_valid_tt", "assert_valid_tto", "assert_finite",
           "debug_nans"]


def assert_valid_tt(x: TTVector) -> None:
    """Check the bond-chain consistency invariants of a TT vector."""
    if x.N == 0:
        raise ValueError("empty TT")
    if x.cores[0].shape[0] != 1:
        raise ValueError(f"left boundary rank must be 1, got {x.cores[0].shape[0]}")
    if x.cores[-1].shape[2] != 1:
        raise ValueError(
            f"right boundary rank must be 1, got {x.cores[-1].shape[2]}")
    for k in range(x.N - 1):
        if x.cores[k].shape[2] != x.cores[k + 1].shape[0]:
            raise ValueError(
                f"bond mismatch at {k}: {x.cores[k].shape[2]} != "
                f"{x.cores[k + 1].shape[0]}")
    if len(x.ot) != x.N:
        raise ValueError("orthogonality flags length mismatch")


def assert_valid_tto(A: TTOperator) -> None:
    """Check the bond-chain consistency invariants of a TT operator."""
    if A.N == 0:
        raise ValueError("empty TT operator")
    if A.cores[0].shape[0] != 1 or A.cores[-1].shape[3] != 1:
        raise ValueError("boundary ranks must be 1")
    for k in range(A.N - 1):
        if A.cores[k].shape[3] != A.cores[k + 1].shape[0]:
            raise ValueError(
                f"bond mismatch at {k}: {A.cores[k].shape[3]} != "
                f"{A.cores[k + 1].shape[0]}")


def assert_finite(tt, name: str = "TT") -> None:
    """Finiteness check of all cores (one host read a core)."""
    for k, c in enumerate(tt.cores):
        if not bool(torch.isfinite(c).all()):
            raise FloatingPointError(f"{name} core {k} contains non-finite values")


# their memory is uninitialized, and may hold NaN before it is written
_UNINITIALIZED = {torch.empty, torch.empty_like, torch.empty_strided,
                  torch.Tensor.new_empty, torch.Tensor.new_empty_strided}


class _NanTrapMode(TorchFunctionMode):
    """Checks every floating or complex tensor that a torch function returns
    (or writes in place through ``__setitem__``) for NaN while the trap is
    on; NaN only, as ``jax_debug_nans``."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if dispatch.NAN_TRAP.on and func not in _UNINITIALIZED:
            written = args[0] if func is torch.Tensor.__setitem__ else out
            dispatch.check_nan(getattr(func, "__name__", repr(func)),
                               written)
        return out


@contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN trap, forward and backward: inside the block a torch
    function or a kernel wrapper that returns a NaN raises
    ``FloatingPointError`` naming itself, and autograd's anomaly mode
    checks the backward pass. ``enable=False`` turns the trap off for the
    block. Blocks nest; each restores the previous state on exit."""
    prev = dispatch.NAN_TRAP.on
    dispatch.NAN_TRAP.on = enable
    try:
        with torch.autograd.set_detect_anomaly(enable):
            if enable and not prev:
                with _NanTrapMode():
                    yield
            else:
                yield
    finally:
        dispatch.NAN_TRAP.on = prev
