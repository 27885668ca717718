"""Solver telemetry: per-solve metrics that a dashboard can consume.

Twin of ``ttnx.utils.profiling.SolverTelemetry``; the rest of that module
(tracing, timers, FLOP counts) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["SolverTelemetry"]


@dataclass
class SolverTelemetry:
    """Structured per-solve metrics: iteration and rank histories plus
    throughput."""

    residuals: list = field(default_factory=list)
    energies: list = field(default_factory=list)
    max_ranks: list = field(default_factory=list)
    local_solves: int = 0
    wall_seconds: float = 0.0
    flops: float = 0.0

    def gflops_per_s(self) -> float:
        return self.flops / max(self.wall_seconds, 1e-12) / 1e9

    def record_sweep(self, residual=None, energy=None, max_rank=None):
        if residual is not None:
            self.residuals.append(float(residual))
        if energy is not None:
            self.energies.append(float(energy))
        if max_rank is not None:
            self.max_ranks.append(int(max_rank))
