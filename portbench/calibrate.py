"""Readings that set a cell's limits: the compared numbers of the program
on many seeds, of its control, and of faults planted under its timed path,
in one process.

    python3 -m portbench.calibrate --workload <cell> --seconds <s> \\
        --seeds 11 12 ... [--control] [--fault <name>]

Each seed is one full run of the cell (set-up, a measured window of
``--seconds``, the judgement), so a number reads as it does in a
benchmark run of that length. ``--control`` runs the driver's
lower-precision path (TF32 allowed), ``--fault`` plants the fault of that
name from ``faults/<config>.py``; both have to come out not correct. One
JSON line a seed on standard output.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


@contextlib.contextmanager
def planted(catalog, workload, fault):
    """Plant fault ``fault`` of the cell's configuration in its driver for
    the duration; nothing where ``fault`` is None."""
    if fault is None:
        yield
        return
    config = catalog.cell(workload)["config"]
    attr, wrap = catalog.module("faults", config).FAULTS[fault]
    # the module that defines the driver's set-up, where a driver re-exports
    driver = sys.modules[catalog.module("drivers", config).setup.__module__]
    saved = getattr(driver, attr)
    setattr(driver, attr, wrap(saved))
    try:
        yield
    finally:
        setattr(driver, attr, saved)


def calibrate(catalog, workload, seeds, seconds, control, device, fault=None):
    """Yield ``{seed, control, fault, correct, failed, attempted, checks,
    metrics}`` a seed."""
    from portbench.core.harness import run_cell

    for seed in seeds:
        with planted(catalog, workload, fault):
            r = run_cell(catalog, workload, seed, seconds, False, device,
                         time.perf_counter(), control=control)
        yield {"seed": seed, "control": control, "fault": fault,
               "correct": r["correct"], "failed": r["failed"],
               "attempted": r["attempted"], "checks": r["checks"],
               "metrics": r["metrics"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault")
    args = p.parse_args(argv)
    import torch

    from portbench.core.catalog import Catalog

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for line in calibrate(Catalog(), args.workload, args.seeds, args.seconds,
                          args.control, torch.device("cuda", 0), args.fault):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
