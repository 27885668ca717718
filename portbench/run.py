"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a traced window after the
measured one. The run needs as many CUDA cards as the cell asks for and
exits with a non-zero code, printing no result, without them.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.core.catalog import REPO, Catalog
    # a Triton cache, should the port ever compile one, stays in the
    # checkout at a fixed path; the kernel library builds in build/ttnx_torch
    os.environ.setdefault("TRITON_CACHE_DIR", str(REPO / "build" / "triton"))
    marks = [("python", time.perf_counter())]
    import torch

    marks.append(("torch import", time.perf_counter()))
    catalog = Catalog()
    chips = catalog.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    marks.append(("CUDA check", time.perf_counter()))
    from portbench.core.harness import run_cell

    result = run_cell(catalog, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T0,
                      marks=marks)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
