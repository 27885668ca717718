"""Probe of the scan-tier MALS on one card: where its float32 eigensweep
loses accuracy, and where a local solve's time goes.

    python3 scripts/probe_torch_mals.py

1. ``mals_eigsolve_scan`` of the open XXX chain (d = 10, rmax = 16, f32,
   ``entry.als_eig_problem``'s seeded start, 2 sweeps) with the two-site
   splits' SVD on cuSOLVER's default driver and on ``gesvd``, each with
   its local ``eigh`` in f32 and in f64: the last energy against the
   dense ground energy, the lowest energy of the history, the worst
   orthonormality error of the split's singular vectors and the worst
   eigen-residual over ``|K|_F``.
2. One two-site local solve at R = 64, RA = 3 (M = 16384, the MALS
   linear solve at d = 12), f64 and f32: the dense K assembly against
   ``torch.linalg.solve`` (CUDA events, median of 3 x 3 calls).

Needs a CUDA card; builds no kernel (the MALS runs none). Imports torch,
numpy, ttnx_torch and chip_smoke only.
"""

from __future__ import annotations

import subprocess

import torch

import chip_smoke as cs
from ttnx_torch.entry import als_eig_problem, dense_xxx_groundstate
from ttnx_torch.solvers import dmrg_scan, mals_scan


def split_and_eigh(dev):
    E0 = dense_xxx_groundstate(10)
    svd0, eigh0 = torch.linalg.svd, torch.linalg.eigh
    stats = {}

    def svd(chosen):
        def call(m, full_matrices=True, driver=None):
            del driver  # the probe's choice replaces the caller's
            u, s, vt = svd0(m, full_matrices=full_matrices, driver=chosen)
            eye = torch.eye(u.shape[1], device=u.device, dtype=u.dtype)
            stats["orth"] = max(stats.get("orth", 0.0),
                                float((u.T @ u - eye).abs().max()),
                                float((vt @ vt.T - eye).abs().max()))
            return u, s, vt
        return call

    def eigh(f64):
        def call(K):
            w, U = eigh0(K.double() if f64 else K)
            w, U = w.to(K.dtype), U.to(K.dtype)
            res = float((K @ U[:, 0] - w[0] * U[:, 0]).norm() / K.norm())
            stats["res"] = max(stats.get("res", 0.0), res)
            return w, U
        return call

    for chosen in (None, "gesvd"):
        for f64 in (False, True):
            stats.clear()
            torch.linalg.svd, torch.linalg.eigh = svd(chosen), eigh(f64)
            try:
                p = als_eig_problem(dev, d=10, rmax=16, dtype=torch.float32)
                E, _ = mals_scan.mals_eigsolve_scan(p["A"], p["x0"],
                                                    rmax=16, n_sweeps=2)
            finally:
                torch.linalg.svd, torch.linalg.eigh = svd0, eigh0
            cs.log(f"mals_eigsolve d=10 r16 f32, svd driver "
                   f"{chosen or 'default'}, eigh {'f64' if f64 else 'f32'}:"
                   f" E {E[-1]:.7f} dense {E0:.7f} rel "
                   f"{(E[-1] - E0) / abs(E0):.3e} | min E - E0 "
                   f"{E.min() - E0:.3e} | orthonormality "
                   f"{stats['orth']:.2e} | eigen-residual / |K|_F "
                   f"{stats['res']:.2e}")


def local_solve_split(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    R, RA, n = 64, 3, 2
    M = R * n * n * R
    for dt in (torch.float64, torch.float32):
        L, Renv = (torch.randn(R, RA, R, generator=g, device=dev, dtype=dt)
                   for _ in range(2))
        Ai, Aj = (torch.randn(RA, n, n, RA, generator=g, device=dev,
                              dtype=dt) for _ in range(2))
        mask = torch.ones(M, device=dev, dtype=dt)
        rhs = torch.randn(M, generator=g, device=dev, dtype=dt)
        K = dmrg_scan._assemble_K2(L, Ai, Aj, Renv, mask)
        K.diagonal().add_(float(M))  # diagonally dominant: a regular K
        asm = cs.cuda_ms(lambda: dmrg_scan._assemble_K2(L, Ai, Aj, Renv,
                                                        mask), 3, 3)
        lu = cs.cuda_ms(lambda: torch.linalg.solve(K, rhs), 3, 3)
        cs.log(f"mals local solve M={M} {str(dt)[6:]}: K assembly "
               f"{asm:.3f} ms, linalg.solve {lu:.3f} ms "
               f"({2 / 3 * M ** 3 / lu / 1e9:.1f} TFLOP/s by 2/3 M^3)")
        del K


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_mals: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    split_and_eigh(dev)
    local_solve_split(dev)


if __name__ == "__main__":
    main()
