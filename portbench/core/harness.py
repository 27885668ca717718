"""One run of one cell: set-up, the measured window, the traced window on
request, the judgement of the outputs against the plain reference, and
the result line.

The cell's driver sets the port up from the seed's draws and runs units;
the harness keeps the clock, picks the judged units from the seed, reads
the metrics that ``BENCHMARK.json`` lists for the cell, and hands the kept
outputs and the same draws to the reference once the program's state is
freed.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass

import torch

from portbench.core import guard
from portbench.core.peaks import card
from portbench.core.trace import Trace, sync, traced_window
from portbench.core.traffic import draw, sampled
from portbench.core.window import Window, measure

__all__ = ["Run", "run_cell", "judge"]


@dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    window: Window
    trace: Trace | None
    work: dict            # flops and bytes of one unit


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def build_note() -> str:
    """The seconds the build of the port's kernel library took, where this
    process built it (in the set-up, at the first launch)."""
    built = getattr(sys.modules.get("ttnx_torch.kernels._build"),
                    "BUILD_SECONDS", None)
    return "" if built is None else f" (the kernel build {built:.3f} s)"


def judge(readings: dict, limits: dict) -> tuple[int, int, dict]:
    """``(answers judged, answers failed, checks)``: each reading is a list
    with one number per judged answer, held to its limit; an answer fails
    when any of its numbers is above its limit or not finite."""
    if set(readings) != set(limits):
        raise KeyError(f"the reference read {sorted(readings)}, the cell "
                       f"limits {sorted(limits)}")
    n = {len(v) for v in readings.values()}
    if len(n) != 1:
        raise ValueError(f"readings of unequal length: {n}")
    n = n.pop()
    bad = [any(not (math.isfinite(readings[k][a]) and readings[k][a] <= lim)
               for k, lim in limits.items()) for a in range(n)]
    checks = {k: {"value": (max(v) if all(map(math.isfinite, v))
                            else float("nan")) if v else float("nan"),
                  "limit": limits[k]} for k, v in readings.items()}
    return n, sum(bad), checks


def run_cell(catalog, name: str, seed: int, seconds: float, trace: bool,
             device, t0: float, control: bool = False,
             marks=None) -> dict:
    """Run cell ``name`` once and return its result line as a dict.
    ``control`` runs the driver's lower-precision path in place of the
    configured one (the check's control; never in a benchmark run).
    ``marks`` are ``(phase, time it ended)`` pairs of the set-up before
    the call, logged with the rest."""
    marks = list(marks or []) + [("harness import", time.perf_counter())]
    cell = catalog.cell(name)
    config = catalog.data("configs", cell["config"])
    traffic = catalog.data("traffic", cell["traffic"])
    guard.check_reference(catalog.find(f"reference/{cell['config']}.py"))
    driver = catalog.module("drivers", cell["config"])
    reference = catalog.module("reference", cell["config"])
    work = catalog.module("work", cell["config"]).unit_work(config, traffic)
    found = guard.forbidden_loaded()
    if found:
        raise RuntimeError(f"loaded at set-up: {found}")

    draws = draw(traffic, seed)
    marks.append(("modules and draws", time.perf_counter()))
    session = driver.setup(config, traffic, draws, device, control=control)
    sync(device)
    marks.append(("port and inputs on the device", time.perf_counter()))
    session.warmup()
    sync(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t0

    def keep(i):
        return sampled(seed, i, traffic["check_every"], traffic["check_span"])

    window = measure(session, seconds, keep, device)
    traced = (traced_window(session, traffic["trace_units"], window.units,
                            keep, device) if trace else None)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kept = session.close()
    del session
    if cuda:
        torch.cuda.empty_cache()
    n, failed, checks = judge(reference.judge(config, traffic, draws, kept),
                              cell["limits"])
    del kept

    run = Run(setup_s=setup_s, window=window, trace=traced, work=work)
    metrics = {}
    for m in catalog.metrics(name, "per_layer" if trace else "end_to_end"):
        value = catalog.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info = {"platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": n > 0 and failed == 0,
              "attempted": window.problems, "failed": failed,
              "metrics": metrics, "device": info}

    unit_ms = window.wall_s / window.units * 1e3
    log(f"card: {card() if cuda else 'cpu'}")
    log("set-up: " + "; ".join(
        f"{label} {b - a:.3f} s" for (label, b), a in
        zip(marks, [t0] + [t for _, t in marks[:-1]])) + build_note())
    log(f"{name} seed {seed}: set-up {setup_s:.3f} s; window {window.units} "
        f"units in {window.wall_s:.3f} s, {unit_ms:.4f} ms a unit; "
        f"{n} answers judged, {failed} failed")
    if traced is not None:
        traced_ms = traced.wall_s / traced.units * 1e3
        info.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
        log(f"traced window: {traced.units} units, {traced_ms:.4f} ms a unit "
            f"traced against {unit_ms:.4f} untraced "
            f"({traced_ms / unit_ms - 1:+.1%}); busy {traced.busy_s:.6f} of "
            f"{traced.window_s:.6f} s")
    found = guard.forbidden_loaded()
    if found:
        raise RuntimeError(f"loaded by the end of the run: {found}")
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return result
