"""Device time and idle time by solver phase in the two benchmark cells, read
from the phase spans of ``ttnx_torch.utils.profiling.span``.

    python3 scripts/probe_torch_spans.py [--seed 7] [--seconds 15] [--cells ...]

Needs a CUDA card. For each cell of ``--cells`` (default ``heat_cn_d12_r64.stream``,
``heat_batch_d12_r64.b512``): the cell's driver sets the port up from the
seed, runs its warm-up and an untimed window of ``--seconds`` (the wall a
unit, as the benchmark's measured window takes it), then windows of
the cell's ``trace_units`` units under ``torch.profiler`` inside the
benchmark's own ``portbench.window`` and ``portbench.units`` ranges, with
the spans and with the solvers' ``span`` replaced by a do-nothing context
in turns (on, off, off, on, on, off: the spans' cost to a traced unit).
From the first window's trace, by two rules:

* busy ms a unit of phase P: the union of the intervals of the device
  operations (kernels, copies, sets) whose launching CUDA runtime or driver
  call (Kineto's ``correlation``) starts inside a P span, over the units;
* idle ms a unit of phase P: the share of the traced window's idle gaps
  (``portbench.core.trace.Trace.gaps``) whose middle falls inside a P span
  (the innermost ``ttnx.*`` span open there), times the untraced idle time
  a unit ``wall a unit - busy_s a unit``, the numerator of ``idle_share``.

It prints, a cell: both numbers a phase and for the unspanned rest, the two
partition identities (phases + rest = ``busy_s``; phases + rest = idle share
x untraced wall), each phase's host ms inside its spans, the launch calls
whose device operation the trace lacks, the kernels each phase launched,
the phase of every kernel of the families the phases are named after, and
the traced ms a unit with and without the spans. Last, the cost of one
``span()`` with no profiler on this host against a bare ``record_function``.
The traces (a few hundred MB for the batch cell) are removed.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import importlib
import json
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from portbench.core.catalog import Catalog  # noqa: E402
from portbench.core.peaks import card  # noqa: E402
from portbench.core.trace import (UNITS, WINDOW, merged, parse,  # noqa: E402
                                  sync)
from portbench.core.traffic import draw  # noqa: E402
from portbench.core.window import measure  # noqa: E402

CELLS = ("heat_cn_d12_r64.stream", "heat_batch_d12_r64.b512")
PHASES = ("ttnx.round", "ttnx.als.solve", "ttnx.als.orth", "ttnx.als.env")
REST = "unspanned"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_CATS = ("cuda_runtime", "cuda_driver")
# kernel-name fragments of each phase's own work, and the phase they belong
# to: B4/B5; cuSOLVER's Jacobi eigh and B1; the QR; B2/B6
FAMILIES = {"cg_site_kernel": "ttnx.als.solve", "syevj": "ttnx.round",
            "syevbj": "ttnx.round", "rotate_batch": "ttnx.round",
            "ttnx_gramgrid": "ttnx.round", "geqr2": "ttnx.als.orth",
            "larft": "ttnx.als.orth", "ttnx_envsite": "ttnx.als.env"}
PAIRS = 3   # traced windows with and without spans, in turns
SPAN_MODULES = ("ttnx_torch.solvers.round_scan", "ttnx_torch.solvers.als_scan",
                "ttnx_torch.solvers.als_scan_batched")


def log(msg=""):
    print(msg, flush=True)


def phase_at(spans, starts, t):
    """The span of ``spans`` (``(name, start, end)``, sorted, none inside
    another) open at time ``t``, or ``REST``."""
    i = bisect.bisect_right(starts, t) - 1
    return spans[i][0] if i >= 0 and t < spans[i][2] else REST


def attribute(path, units, wall_s, unit_wall_s):
    """Busy and idle seconds a unit by phase, and each phase's kernels."""
    trace = parse(path, units, wall_s)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    window = next(e for e in events if e.get("cat") == "user_annotation"
                  and e["name"] == WINDOW)
    t0, t1, tid = window["ts"], window["ts"] + window["dur"], window["tid"]

    def inside(e):
        return t0 <= e["ts"] < t1

    spans = sorted(((e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
                    for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("ttnx.") and e.get("tid") == tid
                    and inside(e)), key=lambda s: s[1])
    for a, b in zip(spans, spans[1:]):
        if b[1] < a[2]:
            raise RuntimeError(f"{b} starts inside {a}")
    starts = [a for _, a, _ in spans]
    phase_of = {e["args"]["correlation"]: phase_at(spans, starts,
                                                   e["ts"] * 1e-6)
                for e in events if e.get("cat") in CALL_CATS and inside(e)
                and "correlation" in e.get("args", {})}
    ops = defaultdict(list)
    kernels = defaultdict(lambda: defaultdict(lambda: [0, 0.0]))
    launched = set()
    for e in events:
        if e.get("cat") in DEVICE_CATS and inside(e):
            corr = e.get("args", {}).get("correlation")
            launched.add(corr)
            p = phase_of.get(corr, REST)
            a, b = e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6
            ops[p].append((e["name"], a, b))
            k = kernels[p][e["name"][:96]]
            k[0] += 1
            k[1] += b - a
    busy = {p: sum(b - a for a, b in merged(ops[p])) / units
            for p in PHASES + (REST,)}
    idle_by = defaultdict(float)
    for a, b in trace.gaps():
        idle_by[phase_at(spans, starts, 0.5 * (a + b))] += b - a
    traced_idle = sum(idle_by.values())
    untraced_idle = unit_wall_s - trace.busy_s / units
    idle = {p: idle_by[p] / traced_idle * untraced_idle if traced_idle else 0.0
            for p in PHASES + (REST,)}
    host, count = defaultdict(float), defaultdict(int)
    for name, a, b in spans:
        host[name] += (b - a) / units
        count[name] += 1
    # launching calls whose device operation the trace lacks
    launches = [e for e in events if e.get("cat") in CALL_CATS and inside(e)
                and "aunch" in e["name"]]
    lost = defaultdict(int)
    for e in launches:
        if e["args"].get("correlation") not in launched:
            lost[phase_of.get(e["args"].get("correlation"), REST)] += 1
    return dict(trace=trace, busy=busy, idle=idle, host=host,
                kernels=kernels, spans=count, unit_wall=unit_wall_s,
                launches=len(launches), lost=dict(lost))


def traced(session, units, first, device, path=None):
    """The benchmark's traced window; its Chrome trace is written to
    ``path`` where one is given. Returns the window's host seconds."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, profile_memory=False,
                 with_stack=False) as prof:
        sync(device)
        with record_function(WINDOW):
            t = time.perf_counter()
            with record_function(UNITS):
                for i in range(first, first + units):
                    session.run(i, False)
            sync(device)
            wall = time.perf_counter() - t
    if path is not None:
        prof.export_chrome_trace(str(path))
    return wall


@contextlib.contextmanager
def spans_off():
    """The solvers' ``span`` replaced by a do-nothing context."""
    null = contextlib.nullcontext()
    mods = [importlib.import_module(m) for m in SPAN_MODULES]
    saved = [m.span for m in mods]
    for m in mods:
        m.span = lambda name: null
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.span = f


def report(name, r, units, walls):
    trace = r["trace"]
    ms = 1e3
    log(f"== {name}: {units} traced units; untraced {r['unit_wall'] * ms:.4f} "
        f"ms a unit; busy_s {trace.busy_s:.6f} of window {trace.window_s:.6f}")
    log(f"spans in the window: {dict(r['spans'])}")
    log(f"launch calls {r['launches']}; with no device op in the trace, by "
        f"phase: {r['lost']}")
    log(f"{'phase':<16}{'busy ms/unit':>14}{'idle ms/unit':>14}"
        f"{'host ms/unit':>14}")
    for p in PHASES + (REST,):
        log(f"{p:<16}{r['busy'][p] * ms:>14.4f}{r['idle'][p] * ms:>14.4f}"
            f"{r['host'].get(p, 0.0) * ms:>14.4f}")
    total_busy = sum(r["busy"].values()) * units
    log(f"busy identity: phases + rest {total_busy:.9f} s against busy_s "
        f"{trace.busy_s:.9f} s (rel "
        f"{abs(total_busy - trace.busy_s) / max(trace.busy_s, 1e-30):.3e})")
    share = 1.0 - trace.busy_s / units / r["unit_wall"]
    log(f"idle identity: phases + rest {sum(r['idle'].values()) * ms:.6f} ms "
        f"against idle_share {share:.6f} x untraced wall "
        f"{share * r['unit_wall'] * ms:.6f} ms")
    for p in PHASES + (REST,):
        top = sorted(r["kernels"][p].items(), key=lambda kv: -kv[1][1])
        log(f"-- kernels of {p} (count a unit, ms a unit), "
            f"{len(top)} names:")
        for k, (c, s) in top[:12]:
            log(f"   {c / units:9.2f} {s / units * ms:10.4f}  {k}")
    for frag, want in FAMILIES.items():
        where = defaultdict(int)
        for p in PHASES + (REST,):
            for k, (c, _) in r["kernels"][p].items():
                if frag in k.lower():
                    where[p] += c
        if where:
            ok = set(where) == {want}
            log(f"family {frag}: {dict(where)} ({'all' if ok else 'NOT all'}"
                f" under {want})")
    for key in ("on", "off"):
        log(f"traced ms a unit, spans {key}: " + ", ".join(
            f"{w / units * ms:.4f}" for w in walls[key]))
    on, off = (statistics.median(walls[k]) for k in ("on", "off"))
    log(f"spans on against off, medians: {on / off - 1:+.2%}")


def off_cost():
    from ttnx_torch.utils.profiling import span

    n = 1_000_000
    t = time.perf_counter()
    for _ in range(n):
        with span("ttnx.als.solve"):
            pass
    guarded = (time.perf_counter() - t) / n
    m = 50_000
    t = time.perf_counter()
    for _ in range(m):
        with torch.profiler.record_function("ttnx.als.solve"):
            pass
    bare = (time.perf_counter() - t) / m
    log(f"off-cost a span, no profiler: span() {guarded * 1e6:.3f} us, bare "
        f"record_function {bare * 1e6:.3f} us")


def probe_cell(catalog, name, seed, seconds, device):
    cell = catalog.cell(name)
    config = catalog.data("configs", cell["config"])
    traffic = catalog.data("traffic", cell["traffic"])
    driver = catalog.module("drivers", cell["config"])
    session = driver.setup(config, traffic, draw(traffic, seed), device)
    session.warmup()
    window = measure(session, seconds, lambda i: False, device)
    units, first = traffic["trace_units"], window.units
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        walls = {"on": [traced(session, units, first, device, path)],
                 "off": []}
        r = attribute(path, units, walls["on"][0],
                      window.wall_s / window.units)
    # on, off, off, on, on, off, ...: the spans' cost to a traced unit
    for k in range(2 * PAIRS - 1):
        first += units
        key = "off" if k % 4 in (0, 1) else "on"
        with spans_off() if key == "off" else contextlib.nullcontext():
            walls[key].append(traced(session, units, first, device))
    report(name, r, units, walls)
    session.close()


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--cells", nargs="+", default=CELLS,
                   help="benchmark cells to probe (default: %(default)s)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    device = torch.device("cuda", 0)
    log(f"card: {card()}; torch {torch.__version__}")
    catalog = Catalog()
    for name in args.cells:
        probe_cell(catalog, name, args.seed, args.seconds, device)
        torch.cuda.empty_cache()
    off_cost()


if __name__ == "__main__":
    main()
