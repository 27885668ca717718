"""Failure detection and solve-level recovery.

Twin of ``ttnx.utils.resilience`` on the port's algebra: the reference's
only fallback is Greedy-cross -> DMRG-cross; this generalizes divergence
detection and retry to every solver. Random perturbations come from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ttnx_torch.core.algebra import matvec, norm, sub
from ttnx_torch.core.tt import TTVector, increase_ranks, rand_tt_like

__all__ = ["SolveFailure", "check_solution", "with_retry",
           "resilient_linsolve"]


@dataclass
class SolveFailure(Exception):
    """Raised when a solve diverges or produces non-finite output."""

    reason: str
    residual: float | None = None

    def __str__(self):
        extra = f" (residual={self.residual:.3e})" if self.residual else ""
        return f"solve failed: {self.reason}{extra}"


def check_solution(A, b, x: TTVector, max_residual: float = 1.0) -> float:
    """Validate a linear-system solution: finite cores and relative residual
    below ``max_residual``. Returns the residual or raises SolveFailure."""
    for k, c in enumerate(x.cores):
        if not bool(torch.isfinite(c).all()):
            raise SolveFailure(f"non-finite values in core {k}")
    res = float(norm(sub(matvec(A, x), b)) / max(
        float(norm(b)), torch.finfo(b.dtype).eps))
    if not np.isfinite(res) or res > max_residual:
        raise SolveFailure("residual above threshold", residual=res)
    return res


def with_retry(solve: Callable, validate: Callable, retries: int = 2,
               perturb: Callable | None = None):
    """Generic retry harness: run ``solve(attempt)``, ``validate(result)``;
    on failure call ``perturb(attempt)`` (if given) and retry."""
    last_err: Exception | None = None
    for attempt in range(retries + 1):
        try:
            out = solve(attempt)
            validate(out)
            return out
        except SolveFailure as e:  # noqa: PERF203
            last_err = e
            if perturb is not None:
                perturb(attempt)
    raise last_err  # type: ignore[misc]


def resilient_linsolve(A, b, x0: TTVector, solver: Callable,
                       max_residual: float = 1e-6, retries: int = 2,
                       noise: float = 1e-3, grow_rank: int = 0,
                       generator: torch.Generator | None = None, **kwargs):
    """Run a TT linear solver with divergence detection and automatic retry.

    On failure the initial guess is perturbed with Gaussian noise (and
    optionally rank-enriched by ``grow_rank``) before retrying — the solver
    analog of the reference's Greedy->DMRG stall fallback
    (/root/reference/src/tt_cross_interpolation.jl:512-518). The noise
    comes from ``generator`` (by default one on ``x0``'s device seeded with
    0, as ttnx's default key).
    """
    if generator is None:
        generator = torch.Generator(device=x0.device).manual_seed(0)
    guess = x0
    last_err: Exception | None = None
    for attempt in range(retries + 1):
        try:
            x = solver(A, b, guess, **kwargs)
            check_solution(A, b, x, max_residual)
            return x
        except SolveFailure as e:
            last_err = e
            guess = rand_tt_like(generator, x0, eps=noise * (10.0 ** attempt))
            if grow_rank > 0:
                guess = increase_ranks(
                    guess, max(guess.ranks) + grow_rank,
                    noise=noise, generator=generator)
    raise last_err  # type: ignore[misc]
