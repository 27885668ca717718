"""Probe of the batched gauge QR (``ttnx_torch/csrc/qr_batched.cu``) on one
card.

    python3 scripts/probe_torch_qr.py [--path] [--calls 5]

Builds ``qr_batched.cu`` alone (``nvcc -Xptxas -v``: registers, shared
memory and spills of each instantiation) into a library that the wrapper
``ttnx_torch.kernels.qr_batched.qr_batched`` then launches from. At the
batched ALS's shapes (B = 512 matrices of R n x R, R = 64 and 32, n = 2),
both layouts, f32 and f64, on seeded matrices of condition about 10
(every other one with three dead rows and columns): the kernel's factors
against ``torch.linalg.qr``'s, ``|QR - V| / |V|``, ``|Q^T Q - I|`` and two
launches bit-identical; then kernel and ``torch.linalg.qr`` timed in turns
(CUDA events, kernel, library, library, kernel), each beside the bound
(bytes at 3.35 TB/s, FLOPs at 67 TFLOP/s f32).

``--path`` then builds the whole kernel library and times ``als_sweeps_b``
on ``chip_smoke.py`` phase 5's problem (B = 512, d = 12, rank 64, f32,
``cg_fused``, 16 CG iterations) with the kernel's gauge and with
``torch.linalg.qr``'s, in turns (host clock, each call ended by a
synchronize; ``--calls`` a side a turn), with the launches of each and the
represented vectors of the two against each other; and one torch.profiler
window of each: device busy ms and kernels a call.

Needs a CUDA card with nvcc (sm_90a); imports torch, numpy, ttnx_torch and
chip_smoke only.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from ttnx_torch.kernels import _build  # noqa: E402
from ttnx_torch.kernels import qr_batched as qrk  # noqa: E402

WORK = REPO / "build" / "probe_qr"
BATCH = 512


def build_alone():
    """qr_batched.cu into its own library (ptxas's lines printed); returns
    the loaded CDLL with the entry points' argument types set."""
    WORK.mkdir(parents=True, exist_ok=True)
    so = WORK / "qr.so"
    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(_build.CSRC), "-shared", str(_build.CSRC / "qr_batched.cu"),
         "-o", str(so)], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stderr[-6000:]}")
    for line in (done.stdout + done.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip(), flush=True)
    lib = ctypes.CDLL(str(so))
    argtypes, suffixes = _build._SIGNATURES["qr_batched"]
    for sfx in suffixes:
        fn = getattr(lib, f"ttnx_qr_batched_{sfx}")
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def bound_ms(V, rows):
    B, a, b = V.shape
    m, k = (b, a) if rows else (a, b)
    flops = B * 2 * (2.0 * m * k * k - 2.0 * k ** 3 / 3)
    moved = V.element_size() * B * (2 * m * k + k * k)
    peak = chip_smoke.PEAK.get(V.dtype)
    t_ops = flops / peak if peak else 0.0
    return max(t_ops, moved / chip_smoke.HBM) * 1e3


def check_and_time(dev):
    for dtype in (torch.float32, torch.float64):
        for R in (64, 32):
            for rows in (False, True):
                V = chip_smoke.qr_stack(dev, dtype, R, rows)
                q, r = qrk.qr_batched(V, rows=rows)
                q2, r2 = qrk.qr_batched(V, rows=rows)
                q0, r0 = qrk.qr_batched_plain(V, rows=rows)
                torch.cuda.synchronize()
                same = torch.equal(q, q2) and torch.equal(r, r2)
                fq = float((q - q0).abs().max() / q0.abs().max())
                fr = float((r - r0).abs().max() / r0.abs().max())
                Vd, qd, rd = V.double(), q.double(), r.double()
                if rows:
                    Vd, qd, rd = (t.transpose(1, 2) for t in (Vd, qd, rd))
                res = float(torch.linalg.norm(qd @ rd - Vd)
                            / torch.linalg.norm(Vd))
                eye = torch.eye(R, dtype=torch.float64, device=dev)
                orth = float((qd.transpose(1, 2) @ qd - eye).abs().max())
                times = []
                for fn in (qrk.qr_batched, qrk.qr_batched_plain,
                           qrk.qr_batched_plain, qrk.qr_batched):
                    times.append(chip_smoke.cuda_ms(
                        lambda fn=fn: fn(V, rows=rows), 10, 5))
                kms = (times[0] + times[3]) / 2
                lms = (times[1] + times[2]) / 2
                bms = bound_ms(V, rows)
                print(f"QR B={BATCH} {2 * R}x{R} {str(dtype)[6:]} "
                      f"{'rows' if rows else 'cols'}: factors vs "
                      f"torch.linalg.qr Q {fq:.2e} R {fr:.2e} | |QR-V|/|V| "
                      f"{res:.2e} |QtQ-I| {orth:.2e} | bit-identical {same} "
                      f"| kernel {times[0]:.4f}, {times[3]:.4f} ms, library "
                      f"{times[1]:.4f}, {times[2]:.4f} ms ({lms / kms:.1f}x) "
                      f"| bound {bms:.4f} ms, {bms / kms:.3f} of it",
                      flush=True)


def dense(x):
    x = x.double()
    B, d, R = x.shape[:3]
    v = x[:, 0, 0]
    for k in range(1, d):
        v = torch.einsum("bNr,brns->bNns", v, x[:, k]).reshape(B, -1, R)
    return v[..., 0]


def path(dev, calls):
    from ttnx_torch.entry import batched_als_problem
    from ttnx_torch.kernels.dispatch import launch_counts, reset_launch_counts
    from ttnx_torch.solvers import als_scan_batched as sb

    _build._LIB = None
    _build.lib()
    p = batched_als_problem(dev, batch=BATCH)
    A, bb, xb, masks = p["lhs_stack"], p["b_batch"], p["x_batch"], p["masks"]

    def run():
        return sb.als_sweeps_b(A, bb, xb, masks, 2, cg_iters=16,
                               solver="cg_fused")

    sides = {"kernel": qrk.qr_batched, "library": qrk.qr_batched_plain}
    outs, times = {}, {s: [] for s in sides}
    for side, fn in sides.items():
        sb.qr_batched = fn
        run()
        torch.cuda.synchronize()
        reset_launch_counts()
        outs[side] = run()
        torch.cuda.synchronize()
        print(f"path {side}: launches/call "
              f"{ {k: v for k, v in launch_counts().items() if v} }",
              flush=True)
    for side in ("kernel", "library", "library", "kernel"):
        sb.qr_batched = sides[side]
        for _ in range(calls):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times[side].append((time.perf_counter() - t0) * 1e3)
    for side in sides:
        ms = statistics.median(times[side])
        print(f"path {side}: {ms:.2f} ms a call (median of "
              f"{len(times[side])}), {BATCH / ms * 1e3:.1f} solves/s; "
              f"calls {', '.join(f'{t:.1f}' for t in times[side])}",
              flush=True)
    g, r = dense(outs["kernel"]), dense(outs["library"])
    rel = torch.linalg.norm(g - r, dim=1) / torch.linalg.norm(r, dim=1)
    print(f"path: represented vectors kernel vs library gauge, max rel "
          f"{float(rel.max()):.3e}", flush=True)
    from torch.profiler import ProfilerActivity, profile
    for side, fn in sides.items():
        sb.qr_batched = fn
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        top = sorted(((e.device_time_total, e.key, e.count)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)[:6]
        print(f"path {side} profiled: {len(events)} device ops, device "
              f"time {busy / 1e3:.2f} ms; top: "
              + "; ".join(f"{k[:40]} {t / 1e3:.2f} ms x{c}"
                          for t, k, c in top), flush=True)
    sb.qr_batched = qrk.qr_batched


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", action="store_true")
    ap.add_argument("--calls", type=int, default=5)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    dev = torch.device("cuda", 0)
    _build._LIB = build_alone()
    check_and_time(dev)
    if opt.path:
        path(dev, opt.calls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
