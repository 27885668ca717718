"""Shape assertions and finiteness guards for TT objects.

Twin of ``ttnx.utils.validation`` without ``debug_nans``, which toggles
JAX's NaN trap: torch has no forward-pass trap to match it (ROADMAP A.7).
"""

from __future__ import annotations

import torch

from ttnx_torch.core.tt import TTOperator, TTVector

__all__ = ["assert_valid_tt", "assert_valid_tto", "assert_finite"]


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
