"""The device cross on one card: where a batched cross call spends its
time, and how large a batch of 5 x 5 ``eigvalsh`` cuSOLVER takes.

    python3 scripts/probe_torch_cross.py

No kernel build. Prints the card's name and power limit first, then:

1. ``torch.linalg.eigvalsh`` on stacks of N seeded symmetric 5 x 5 f32
   matrices (the Wishart integrand's), N from 8192 to 65536: ok or the
   error cuSOLVER gives;
2. for each batched Wishart cross of ``entry.wishart_cross_problem``
   (MaxVol at B = 16, DMRG at B = 8; f32, TF32 off), one call after a
   warm-up under torch.profiler: the wall time, the device kernel time
   and busy share, and the operators taking the most host time (with
   their calls and device time), to ``chiprun_out/probe_cross.txt`` and
   the first lines of each to the output.

Imports torch, numpy, ttnx_torch and chip_smoke only.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

import chip_smoke as cs


def eigvalsh_limits(device):
    rng = np.random.default_rng(0)
    for n in (8192, 16384, 24576, 32768, 65536):
        a = rng.standard_normal((n, 5, 5)).astype(np.float32)
        m = torch.as_tensor(a @ a.transpose(0, 2, 1) + 5 * np.eye(5,
                            dtype=np.float32), device=device)
        try:
            torch.linalg.eigvalsh(m)
            torch.cuda.synchronize()
            cs.log(f"eigvalsh {n} x 5 x 5 f32: ok")
        except RuntimeError as err:
            cs.log(f"eigvalsh {n} x 5 x 5 f32: {str(err).splitlines()[0]}")


def profile_cross(device, method, out):
    from torch.profiler import ProfilerActivity

    from ttnx_torch.config import matmul_precision
    from ttnx_torch.entry import wishart_cross_problem

    p = wishart_cross_problem(device, batch=cs.CROSS_BATCH[method],
                              method=method)

    def run():
        return p["fn"](torch.Generator(device=device).manual_seed(p["seed"]))

    with matmul_precision("highest"):
        run()
        torch.cuda.synchronize()
        with cs.profiler([ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    dev = sum(e.device_time for e in prof.events()
              if str(e.device_type).endswith("CUDA")) / 1e3
    table = prof.key_averages().table(sort_by="cpu_time_total",
                                      row_limit=25)
    head = (f"{method} cross B={cs.CROSS_BATCH[method]}: {wall:.1f} ms "
            f"wall, {dev:.1f} ms device kernels (busy {dev / wall:.3f})")
    cs.log(head)
    cs.log("\n".join(table.splitlines()[:16]))
    out.write(head + "\n" + table + "\n")


def main():
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(cs.smi_line())
    eigvalsh_limits(device)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "probe_cross.txt"), "w") as out:
        for method in ("maxvol", "dmrg"):
            profile_cross(device, method, out)


if __name__ == "__main__":
    main()
