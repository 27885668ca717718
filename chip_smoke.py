#!/usr/bin/env python3
"""Smoke run of the ttnx_torch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. Build: compile the Hopper kernels from ttnx_torch/csrc (nvcc, sm_90a).
3. Kernels: each of B1-B4 against its plain PyTorch version on the card,
   on the inputs the CN step really gives it at ranks 16, 32 and 64, in
   float32 and float64; max relative error (<= 1e-4 f32, <= 1e-10 f64)
   and median time of kernel and plain version.
4. Main path: the d=12 Crank-Nicolson step at ranks 16, 32 and 64 (f32,
   16 warm CG iterations) on a three-mode eigenstate: the 8-step trajectory
   against the closed form (rel <= 1e-3), the implicit residual (<= 1e-2),
   ms/step and GFLOP/s through the kernels and through the plain versions,
   agreement of the two 8-step states (rel <= 1e-4), and the kernel launch
   counts per step (B1 = 1, B2 = 1 right + 1 left, B3/B4 = 22/0 at rank 16,
   0/22 at ranks 32 and 64).

The last two lines are a JSON summary of the kernels and the device line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

D = 12
RANKS = (16, 32, 64)
H_STEP = 1e-6
N_STEPS = 8
CG_ITERS = 16
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
MIDDLE_SITE = 5  # which of the 22 local solves of a step to compare

# wrapper name -> (label, patched module, source, TPU kernel it replaces)
KERNELS = {
    "gram_chain_fused": (
        "B1", "ttnx_torch.solvers.round_scan",
        "ttnx_torch/csrc/gram_chain.cu", "ttnx/kernels/gram.py:87"),
    "right_env_chain_fused": (
        "B2", "ttnx_torch.solvers.als_scan",
        "ttnx_torch/csrc/env_chain.cu", "ttnx/kernels/env_chain.py:420"),
    "left_env_chain_fused": (
        "B2", "ttnx_torch.solvers.als_scan",
        "ttnx_torch/csrc/env_chain.cu", "ttnx/kernels/env_chain.py:382"),
    "cg_solve_fused": (
        "B3", "ttnx_torch.solvers.als_scan",
        "ttnx_torch/csrc/local_cg.cu", "ttnx/kernels/local_cg.py:167"),
    "cg_matfree_fused": (
        "B4", "ttnx_torch.solvers.als_scan",
        "ttnx_torch/csrc/local_cg_mf.cu", "ttnx/kernels/local_cg_mf.py:260"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def wrappers():
    from ttnx_torch.kernels import env_chain, gram, local_cg, local_cg_mf

    return {
        "gram_chain_fused": (gram.gram_chain_fused, gram.gram_chain_plain),
        "right_env_chain_fused": (env_chain.right_env_chain_fused,
                                  env_chain.right_env_chain_plain),
        "left_env_chain_fused": (env_chain.left_env_chain_fused,
                                 env_chain.left_env_chain_plain),
        "cg_solve_fused": (local_cg.cg_solve_fused, local_cg.cg_solve_plain),
        "cg_matfree_fused": (local_cg_mf.cg_matfree_fused,
                             local_cg_mf.cg_matfree_plain),
    }


@contextlib.contextmanager
def solver_calls(replace):
    """Inside the block the solver modules call ``replace(name, kernel,
    plain)`` in place of each kernel wrapper."""
    import importlib

    saved = []
    try:
        for name, (kernel, plain) in wrappers().items():
            mod = importlib.import_module(KERNELS[name][1])
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, replace(name, kernel, plain))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_versions():
    return solver_calls(lambda name, kernel, plain: plain)


def cuda_ms(fn, reps: int = 10, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean device time of ``reps`` calls,
    by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def three_mode_state(d, hg, device):
    """Sum of three Dirichlet eigenmodes of the grid Laplacian (rank 6):
    the CN evolution has a closed form."""
    from ttnx_torch.ops.qtt import qtt_sin

    def mode(lam):
        return qtt_sin(d, a=hg, b=1 - hg, lam=lam, device=device)

    return mode(1.0) + 0.5 * mode(3.0) + 0.25 * mode(9.0)


def cn_analytic(d, hg, h_step, steps):
    j = np.arange(1, 2 ** d + 1)
    out = np.zeros(2 ** d)
    for k, amp in ((1, 1.0), (3, 0.5), (9, 0.25)):
        mu = (2 - 2 * np.cos(k * np.pi * hg)) / hg ** 2
        rho = (1 - h_step / 2 * mu) / (1 + h_step / 2 * mu)
        out += amp * rho ** steps * np.sin(k * np.pi * j * hg)
    return out


def cn_residual(u_next, u_prev, hg, h_step):
    """||L u+ - R u|| / ||R u|| with the exact tridiagonal operators."""
    c = h_step / (2 * hg ** 2)

    def T(v):
        out = 2 * v
        out[:-1] -= v[1:]
        out[1:] -= v[:-1]
        return out

    lhs = u_next + c * T(u_next.copy())
    rhs = u_prev - c * T(u_prev.copy())
    return float(np.linalg.norm(lhs - rhs) / np.linalg.norm(rhs))


def setup(rmax, device, dtype=torch.float32):
    from ttnx_torch.entry import flagship_cn_step

    hg = 1.0 / (2 ** D + 1)
    step_fn, pack, unpack = flagship_cn_step(device, rmax=rmax, d=D,
                                             h=H_STEP, dtype=dtype,
                                             cg_iters=CG_ITERS)
    return step_fn, pack(three_mode_state(D, hg, device)), unpack


def dense(unpack, stack):
    from ttnx_torch.core.decomp import ttv_to_tensor

    return ttv_to_tensor(unpack(stack)).reshape(-1).double().cpu().numpy()


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} | CUDA {torch.version.cuda} | python "
        f"{sys.version.split()[0]}")
    return smi


def phase_build():
    from ttnx_torch.kernels import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    nvcc = ("cached" if _build.BUILD_SECONDS is None
            else f"nvcc {_build.BUILD_SECONDS:.1f} s")
    log(f"build: {so.name} in {time.perf_counter() - t0:.1f} s ({nvcc})")


def capture_inputs(rmax, device, dtype):
    """Run one CN step through the plain versions and keep the arguments
    each kernel wrapper received (the MIDDLE_SITE-th local solve)."""
    seen = {}

    def recorder(name, kernel, plain):
        def call(*args, **kwargs):
            seen.setdefault(name, []).append((args, kwargs))
            return plain(*args, **kwargs)
        return call

    step_fn, us, _ = setup(rmax, device, dtype)
    with solver_calls(recorder):
        step_fn(us)
    torch.cuda.synchronize()
    return {name: calls[min(MIDDLE_SITE, len(calls) - 1)]
            for name, calls in seen.items()}


def max_err(got, ref):
    if isinstance(ref, tuple):
        pairs = list(zip(got, ref))
    else:
        pairs = [(got, ref)]
    abs_err = max(float((g - r).abs().max()) for g, r in pairs)
    scale = max(float(r.abs().max()) for _, r in pairs)
    return abs_err, abs_err / scale


def phase_kernels(device):
    fns = wrappers()
    rows = []
    for dtype in (torch.float32, torch.float64):
        for rmax in RANKS:
            inputs = capture_inputs(rmax, device, dtype)
            for name, (args, kwargs) in inputs.items():
                kernel, plain = fns[name]
                got = kernel(*args, **kwargs)
                ref = plain(*args, **kwargs)
                torch.cuda.synchronize()
                abs_err, rel_err = max_err(got, ref)
                ms = cuda_ms(lambda: kernel(*args, **kwargs))
                plain_ms = cuda_ms(lambda: plain(*args, **kwargs))
                shape = "x".join(str(s) for s in args[0].shape)
                ok = rel_err <= TOL[dtype]
                log(f"kernel {KERNELS[name][0]} {name:22s} r{rmax:<3d} "
                    f"{str(dtype)[6:]:8s} in0 {shape:14s} max_rel_err "
                    f"{rel_err:.3e} max_abs_err {abs_err:.3e} | kernel "
                    f"{ms:.4f} ms  plain {plain_ms:.4f} ms  "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise RuntimeError(
                        f"{name} r{rmax} {dtype}: kernel disagrees with its "
                        f"plain version, rel err {rel_err:.3e} > "
                        f"{TOL[dtype]:.0e}")
                rows.append(dict(name=name, rmax=rmax, dtype=dtype,
                                 abs_err=abs_err, rel_err=rel_err, ms=ms,
                                 plain_ms=plain_ms))
    if {r["name"] for r in rows} != set(KERNELS):
        raise RuntimeError("the CN step did not call every kernel wrapper")
    return rows


def run_chain(step_fn, us, n):
    """n chained steps; returns (state after n-1 steps, after n steps)."""
    prev, v = us, us
    for _ in range(n):
        prev, v = v, step_fn(v)
    return prev, v


def timed_chain(step_fn, us):
    """ms/step: median over 3 chains of N_STEPS steps, after a warm-up."""
    v = step_fn(us)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prev, v = run_chain(step_fn, us, N_STEPS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / N_STEPS * 1e3)
    return statistics.median(times), prev, v


def phase_main_path(device):
    from ttnx_torch.kernels.dispatch import launch_counts, reset_launch_counts
    from ttnx_torch.utils.flops import cn_step_flops

    hg = 1.0 / (2 ** D + 1)
    exact = cn_analytic(D, hg, H_STEP, N_STEPS)
    reset_launch_counts()
    for rmax in RANKS:
        step_fn, us, unpack = setup(rmax, device)
        before = launch_counts()
        one = step_fn(us)
        torch.cuda.synchronize()
        per_step = {k: v - before[k] for k, v in launch_counts().items()}
        dense_k = 2 * rmax * rmax <= 1024  # M = R n R: B3 below, B4 above
        want = {"gram_chain_fused": 1, "right_env_chain_fused": 1,
                "left_env_chain_fused": 1,
                "cg_solve_fused": 2 * (D - 1) if dense_k else 0,
                "cg_matfree_fused": 0 if dense_k else 2 * (D - 1)}
        if per_step != want:
            raise RuntimeError(f"r{rmax}: launches per step {per_step}, "
                               f"expected {want}")
        if one.shape != us.shape or not bool(torch.isfinite(one).all()):
            raise RuntimeError(f"r{rmax}: step output is not a finite "
                               f"{tuple(us.shape)} stack")
        ms, v7, v8 = timed_chain(step_fn, us)
        d7, d8 = dense(unpack, v7), dense(unpack, v8)
        rel = float(np.linalg.norm(d8 - exact) / np.linalg.norm(exact))
        res = cn_residual(d8, d7, hg, H_STEP)
        with plain_versions():
            plain_ms, _, p8 = timed_chain(step_fn, us)
        agree = float(np.linalg.norm(d8 - dense(unpack, p8))
                      / np.linalg.norm(d8))
        gflops = cn_step_flops(D, rmax, 4, 4, cg_iters=CG_ITERS + 1) / (
            ms * 1e-3) / 1e9
        log(f"cn_step d={D} r{rmax}: {ms:.3f} ms/step ({gflops:.2f} "
            f"GFLOP/s) | plain {plain_ms:.3f} ms/step | traj rel "
            f"{rel:.3e} (<= 1e-3) residual {res:.3e} (<= 1e-2) | kernel vs "
            f"plain 8-step rel {agree:.3e} (<= 1e-4) | launches/step "
            f"{per_step}")
        if not (np.isfinite(rel) and rel <= 1e-3 and res <= 1e-2
                and agree <= 1e-4):
            raise RuntimeError(f"cn r{rmax} failed its gates: rel={rel:.3e} "
                               f"residual={res:.3e} agree={agree:.3e}")
    counts = launch_counts()
    missing = [k for k in KERNELS if counts[k] == 0]
    if missing:
        raise RuntimeError(f"main path launched no {missing}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    import ttnx_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda", 0)
    # full-f32 products in the plain versions the kernels are held against
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device()
    phase_build()
    rows = phase_kernels(device)
    counts = phase_main_path(device)
    # one summary row per kernel, f32, at the rank where the path runs it
    pick = {"cg_solve_fused": 16}
    summary = []
    for name, (label, _, source, replaces) in KERNELS.items():
        r = next(r for r in rows if r["name"] == name
                 and r["dtype"] == torch.float32
                 and r["rmax"] == pick.get(name, 64))
        summary.append({"name": f"{label} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": counts[name],
                        "max_abs_err": r["abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
