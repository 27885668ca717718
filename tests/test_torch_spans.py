"""The phase spans of the scan solvers (``ttnx_torch.utils.profiling.span``):
nothing is recorded, and ``record_function`` is never called, unless a
profiler records; under one, a CN step and a batched ALS call open one span
per phase as often as the sweep implies, and no phase span holds another.
Small shapes on the CPU (the kernels' plain versions)."""

import pytest
import torch

from ttnx_torch.entry import batched_als_problem
from ttnx_torch.ops.operators import toeplitz_to_qtto
from ttnx_torch.solvers.als_scan_batched import als_sweeps_b
from ttnx_torch.solvers.round_scan import make_cn_step
from ttnx_torch.utils import profiling

D, R, SWEEPS = 4, 4, 2
PHASES = ("ttnx.round", "ttnx.als.solve", "ttnx.als.orth", "ttnx.als.env")


def _cn_step():
    hg = 1.0 / (2 ** D + 1)
    A = (-1.0 / hg ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, D, device="cpu")
    step, pack, _ = make_cn_step(
        A, 1e-6, rmax=R, dims=(2,) * D, u_rks=(1,) + (R,) * (D - 1) + (1,),
        dtype=torch.float64, sweep_count=SWEEPS, solver="cg_fused",
        round_method="gram_chain", cg_iters=1)
    u = torch.zeros((D, R, 2, R), dtype=torch.float64)
    u[:, 0, :, 0] = 1.0
    return lambda: step(u)


def _batched_call():
    p = batched_als_problem(torch.device("cpu"), batch=2, rmax=R, d=D,
                            dtype=torch.float64)
    return lambda: als_sweeps_b(p["lhs_stack"], p["b_batch"], p["x_batch"],
                                p["masks"], SWEEPS, cg_iters=1,
                                solver="cg_fused")


def _spans(fn):
    """The ``ttnx.*`` ranges ``(name, start, end)`` of one call of ``fn``
    under a CPU profiler, in order of start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("ttnx.")),
                  key=lambda s: s[1])


def test_no_span_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("ttnx.als.solve")
    assert profiling.span("ttnx.round") is first
    with first as entered:
        assert entered is None
    _cn_step()()  # every span of a step passes the guard


@pytest.mark.parametrize("unit,rounds", [(_cn_step, 1), (_batched_call, 0)],
                         ids=["cn_step", "als_sweeps_b"])
def test_a_unit_opens_the_spans_its_sweeps_imply(unit, rounds):
    spans = _spans(unit())
    counts = {p: sum(1 for s in spans if s[0] == p) for p in PHASES}
    sites = SWEEPS * (D - 1)
    assert counts == {"ttnx.round": rounds, "ttnx.als.solve": sites,
                      "ttnx.als.orth": sites,
                      "ttnx.als.env": SWEEPS + sites}
    assert len(spans) == sum(counts.values())
    for (a, _, end), (b, start, _) in zip(spans, spans[1:]):
        assert start >= end, f"{b} starts inside {a}"
