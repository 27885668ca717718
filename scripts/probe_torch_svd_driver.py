"""The thin-SVD driver on one card: the scan tier's DMRG and TDVP before
and after every thin SVD of ttnx_torch went through
``core.linalg.thin_svd`` (cuSOLVER's ``gesvd`` on CUDA).

    python3 scripts/probe_torch_svd_driver.py

Builds the kernels (phase 6 runs B8 and B9), then runs, with every
``torch.linalg.svd`` call forced to cuSOLVER's default driver and to
``gesvd`` in turn (default, gesvd, gesvd, default, all in this one call):

1. the orthonormality of a seeded 1024 x 64 f32 matrix's singular
   vectors, ``max |U^T U - I|``;
2. ``chip_smoke.py`` phases 6 and 7 as they are (their ms/sweep and
   ms/step; both take the ``'gram'`` split, which calls no SVD);
3. the same DMRG eigensweeps (d = 10, rmax = 16 through 'lanczos_fused';
   d = 12, rmax = 64 through 'lanczos') and ``tdvp2_step`` with
   ``split='svd'``, which call ``dmrg_scan``'s and ``tdvp_scan``'s SVDs:
   ms/sweep or ms/step (median of 3 after a warm-up), the last energy's
   rel error to the dense ground energy and the TDVP state's to the
   analytic decay.

Prints the card's name and power limit first. Imports torch, numpy,
ttnx_torch and chip_smoke only.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

import chip_smoke as cs

DRIVERS = (None, "gesvd", "gesvd", None)


def forced(chosen):
    """``torch.linalg.svd`` with the caller's driver replaced by
    ``chosen``."""
    svd0 = torch.linalg.svd

    def call(m, full_matrices=True, driver=None):
        del driver
        return svd0(m, full_matrices=full_matrices, driver=chosen)

    return svd0, call


def orthonormality(dev):
    rng = np.random.default_rng(14)
    m = torch.as_tensor(rng.standard_normal((1024, 64)), dtype=torch.float32,
                        device=dev)
    u, _, _ = torch.linalg.svd(m, full_matrices=False)
    eye = torch.eye(64, dtype=torch.float32, device=dev)
    return float((u.T @ u - eye).abs().max())


def median_ms(run, n):
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / n * 1e3)
    return statistics.median(times), out


def svd_split_paths(dev, label):
    from ttnx_torch.core.decomp import ttv_to_tensor
    from ttnx_torch.entry import (dense_xxx_groundstate, dmrg_problem,
                                  tdvp_problem)
    from ttnx_torch.solvers.als_scan import rank_masks, unpack_tt
    from ttnx_torch.solvers.dmrg_scan import dmrg_eig_sweep
    from ttnx_torch.solvers.tdvp_scan import tdvp2_step

    for (d, rmax), solver in zip(cs.DMRG_CONFIGS, ("lanczos_fused",
                                                   "lanczos")):
        p = dmrg_problem(dev, d=d, rmax=rmax)

        def sweeps():
            x, m = p["x_stack"], p["masks"]
            for _ in range(cs.DMRG_SWEEPS):
                x, m, E = dmrg_eig_sweep(p["A_stack"], x, m, p["tol"],
                                         p["degen_tol"],
                                         lanczos_iters=cs.DMRG_ITERS,
                                         eig_solver=solver, split="svd")
            return E

        ms, E = median_ms(sweeps, cs.DMRG_SWEEPS)
        E0 = dense_xxx_groundstate(d)
        cs.log(f"{label} dmrg split='svd' d={d} r{rmax} {solver}: {ms:.3f} "
               f"ms/sweep | E rel {abs(float(E[-1]) - E0) / abs(E0):.3e}")

    p = tdvp_problem(dev, d=cs.TDVP_D, rmax=cs.TDVP_RMAX)
    m0 = rank_masks(p["u0"].ranks, cs.TDVP_RMAX, dtype=torch.float32,
                    device=dev)
    n = 8

    def steps():
        x, m = p["x_stack"], m0
        for _ in range(n):
            x, m = tdvp2_step(p["A_stack"], x, m, cs.TDVP_H, 0.0,
                              cs.TDVP_RMAX, krylov_dim=10, imag_real=True,
                              split="svd")
        return x, m

    ms, (x, m) = median_ms(steps, n)
    rks = [int(v) for v in m.sum(dim=1).tolist()]
    got = ttv_to_tensor(unpack_tt(x, rks)).reshape(-1).double().cpu()
    u0 = ttv_to_tensor(p["u0"]).reshape(-1).double().cpu().numpy()
    want = u0 * np.exp(-p["lam1"] * n * cs.TDVP_H)
    rel = float(np.linalg.norm(got.numpy() - want) / np.linalg.norm(want))
    cs.log(f"{label} tdvp2_step split='svd' d={cs.TDVP_D} r{cs.TDVP_RMAX}: "
           f"{ms:.3f} ms/step | rel to the analytic decay {rel:.3e}")


def main():
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_device()
    cs.phase_build()
    for call, chosen in enumerate(DRIVERS):
        label = f"[{call}] driver={chosen or 'default'}"
        svd0, patched = forced(chosen)
        torch.linalg.svd = patched
        try:
            cs.log(f"{label}: 1024 x 64 f32 orthonormality "
                   f"{orthonormality(dev):.3e}")
            cs.log(f"{label}: phases 6 and 7 as in chip_smoke.py")
            cs.timed("6", cs.phase_dmrg_path, dev)
            cs.timed("7", cs.phase_tdvp_path, dev)
            svd_split_paths(dev, label)
        finally:
            torch.linalg.svd = svd0


if __name__ == "__main__":
    main()
