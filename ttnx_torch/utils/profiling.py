"""Profiling, timing and solver telemetry.

Twin of ``ttnx.utils.profiling``: :func:`trace` records a
``torch.profiler`` trace (host and, where a card exists, CUDA activity)
and writes it as a Chrome trace into a directory; :func:`sync_and_time`
times a function with its CUDA outputs finished; :class:`Timer`
accumulates named wall-clock sections; :func:`contraction_flops` counts a
pairwise contraction; :class:`SolverTelemetry` carries per-solve metrics
that a dashboard can consume.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

__all__ = ["trace", "Timer", "SolverTelemetry", "contraction_flops",
           "sync_and_time"]


@contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace around a block and write it into
    ``log_dir`` as a Chrome trace (``chrome://tracing``, Perfetto or
    TensorBoard read it). Yields the profiler, whose ``key_averages()``
    give the sums by operator."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def _tensors(out):
    """The tensors of a result: tensors, TT objects and containers."""
    if isinstance(out, torch.Tensor):
        yield out
    elif hasattr(out, "cores"):
        yield from out.cores
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def _finish(out) -> None:
    """Wait for the devices that hold ``out``'s CUDA tensors."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def sync_and_time(fn, *args, iters: int = 1):
    """``(seconds per call, output)`` of ``fn(*args)`` by the host clock,
    after one warm-up call; each timed call ends when the CUDA tensors of
    its output are finished (``torch.cuda.synchronize``)."""
    out = fn(*args)
    _finish(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
        _finish(out)
    return (time.perf_counter() - t0) / iters, out


class Timer:
    """Accumulating named wall-clock sections."""

    def __init__(self):
        self.sections: dict[str, float] = {}

    @contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + (
                time.perf_counter() - t0)

    def summary(self) -> str:
        total = sum(self.sections.values())
        lines = [f"total {total * 1e3:.2f} ms"]
        for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k}: {v * 1e3:.2f} ms ({100 * v / total:.1f}%)")
        return "\n".join(lines)


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


def contraction_flops(dims_a, dims_b, contracted) -> float:
    """FLOP count of a pairwise tensor contraction: 2 * prod(all distinct
    dims); ``contracted`` is the list of shared dimension sizes."""
    out = 2.0
    for d in dims_a:
        out *= d
    for d in dims_b:
        out *= d
    for d in contracted:
        out /= d
    return out
