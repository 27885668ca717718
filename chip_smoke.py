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
3b. Batched kernels: B5-B7 against their plain versions at R = 64 and
   32, float32 and float64, on B = 8 distinct problems: B5 and B6 on the
   inputs one als_sweeps_b call gives them (b[i] = (1 + 0.2 i) u_s, x[i] =
   u_s plus a seeded perturbation inside the masks), B7 whole on distinct
   flat-spectrum problems (ROADMAP C: on u_s, whose bond spectrum falls to
   rounding level, its Newton-Schulz gauge is set by rounding noise), plus
   one B7 case with cg_refine=2, cg_polish=2 at R = 32.
4. Main path: the d=12 Crank-Nicolson step at ranks 16, 32 and 64 (f32,
   16 warm CG iterations) on a three-mode eigenstate: the 8-step trajectory
   against the closed form (rel <= 1e-3), the implicit residual (<= 1e-2),
   ms/step and GFLOP/s through the kernels and through the plain versions,
   agreement of the two 8-step states (rel <= 1e-4), and the kernel launch
   counts per step (B1 = 1, B2 = 1 right + 1 left, B3/B4 = 22/0 at rank 16,
   0/22 at ranks 32 and 64).
5. Batched path: 512 rank-64 d=12 implicit heat solves (f32, no TF32)
   through both routes of the bench ladder, explicit_kernel (als_sweeps_b,
   cg_fused, 16 warm CG iterations: B6 2 launches, B5 22) and
   sweep_pair_fused (B7, one launch): solves/s and GFLOP/s (median of 3
   calls after a warm-up) through the kernels and through the plain
   versions, element 0's residual against the exact tridiagonal operator
   (<= 1e-2) and the kernel-against-plain agreement of its represented
   vector (<= 1e-4).

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

BATCH, BATCH_CHECK = 512, 8
BATCHED_RANKS = (64, 32)

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
    "cg_matfree_fused_batched": (
        "B5", "ttnx_torch.solvers.als_scan_batched",
        "ttnx_torch/csrc/local_cg_mf.cu", "ttnx/kernels/local_cg_mf.py:225"),
    "env_chain_fused_batched": (
        "B6", "ttnx_torch.solvers.als_scan_batched",
        "ttnx_torch/csrc/env_chain.cu", "ttnx/kernels/env_chain.py:346"),
    "als_fwd_bwd_fused_batched": (
        "B7", "ttnx_torch.kernels.als_sweep_fused",
        "ttnx_torch/csrc/als_sweep_fused.cu",
        "ttnx/kernels/als_sweep_fused.py:545"),
}
CN_KERNELS = ("gram_chain_fused", "right_env_chain_fused",
              "left_env_chain_fused", "cg_solve_fused", "cg_matfree_fused")


def log(msg: str) -> None:
    print(msg, flush=True)


def wrappers():
    from ttnx_torch.kernels import (als_sweep_fused, env_chain, gram,
                                    local_cg, local_cg_mf)

    return {
        "gram_chain_fused": (gram.gram_chain_fused, gram.gram_chain_plain),
        "right_env_chain_fused": (env_chain.right_env_chain_fused,
                                  env_chain.right_env_chain_plain),
        "left_env_chain_fused": (env_chain.left_env_chain_fused,
                                 env_chain.left_env_chain_plain),
        "cg_solve_fused": (local_cg.cg_solve_fused, local_cg.cg_solve_plain),
        "cg_matfree_fused": (local_cg_mf.cg_matfree_fused,
                             local_cg_mf.cg_matfree_plain),
        "cg_matfree_fused_batched": (local_cg_mf.cg_matfree_fused_batched,
                                     local_cg_mf.cg_matfree_batched_plain),
        "env_chain_fused_batched": (env_chain.env_chain_fused_batched,
                                    env_chain.env_chain_batched_plain),
        "als_fwd_bwd_fused_batched": (
            als_sweep_fused.als_fwd_bwd_fused_batched,
            als_sweep_fused.als_fwd_bwd_plain),
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
    """The CN step on the three-mode state (rank 6), whose evolution has a
    closed form."""
    from ttnx_torch.entry import flagship_cn_step, three_mode_state

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


def record_calls(run):
    """``run()`` through the plain versions; returns ``{wrapper name: [(args,
    kwargs), ...]}`` of every kernel wrapper call it made."""
    seen = {}

    def recorder(name, kernel, plain):
        def call(*args, **kwargs):
            seen.setdefault(name, []).append((args, kwargs))
            return plain(*args, **kwargs)
        return call

    with solver_calls(recorder):
        run()
    torch.cuda.synchronize()
    return seen


def capture_inputs(rmax, device, dtype):
    """Run one CN step through the plain versions and keep the arguments
    each kernel wrapper received (the MIDDLE_SITE-th local solve)."""
    step_fn, us, _ = setup(rmax, device, dtype)
    seen = record_calls(lambda: step_fn(us))
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


def hold(name, rmax, dtype, args, kwargs, reps=10, repeats=5, tag=""):
    """One kernel against its plain version on the same inputs: raises
    above the tolerance, returns the row of errors and CUDA-event times."""
    kernel, plain = wrappers()[name]
    got = kernel(*args, **kwargs)
    ref = plain(*args, **kwargs)
    torch.cuda.synchronize()
    abs_err, rel_err = max_err(got, ref)
    ms = cuda_ms(lambda: kernel(*args, **kwargs), reps, repeats)
    plain_ms = cuda_ms(lambda: plain(*args, **kwargs), reps, repeats)
    big = max((a for a in args if torch.is_tensor(a)), key=torch.numel)
    shape = "x".join(str(s) for s in big.shape)
    ok = rel_err <= TOL[dtype]
    log(f"kernel {KERNELS[name][0]} {name:25s} r{rmax:<3d} "
        f"{str(dtype)[6:]:8s} in {shape:16s}{tag} max_rel_err "
        f"{rel_err:.3e} max_abs_err {abs_err:.3e} | kernel {ms:.4f} ms  "
        f"plain {plain_ms:.4f} ms  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(
            f"{name} r{rmax} {dtype}{tag}: kernel disagrees with its plain "
            f"version, rel err {rel_err:.3e} > {TOL[dtype]:.0e}")
    return dict(name=name, rmax=rmax, dtype=dtype, abs_err=abs_err,
                rel_err=rel_err, ms=ms, plain_ms=plain_ms, tag=tag)


def phase_kernels(device):
    rows = []
    for dtype in (torch.float32, torch.float64):
        for rmax in RANKS:
            inputs = capture_inputs(rmax, device, dtype)
            for name, (args, kwargs) in inputs.items():
                rows.append(hold(name, rmax, dtype, args, kwargs))
    if {r["name"] for r in rows} != set(CN_KERNELS):
        raise RuntimeError("the CN step did not call every kernel wrapper")
    return rows


def distinct_batch(device, dtype, rmax):
    """The batched heat problem with BATCH_CHECK distinct problems: b[i] =
    (1 + 0.2 i) u_s, x[i] = u_s + a seeded perturbation inside the masks."""
    from ttnx_torch.entry import batched_als_problem

    p = batched_als_problem(device, batch=1, rmax=rmax, dtype=dtype)
    us, m = p["b_batch"][0], p["masks"]
    inside = m[:-1][:, :, None, None] * m[1:][:, None, None, :]
    rng = np.random.default_rng(rmax)
    noise = torch.as_tensor(rng.standard_normal((BATCH_CHECK,) + us.shape),
                            dtype=dtype, device=device)
    b = torch.stack([(1.0 + 0.2 * i) * us for i in range(BATCH_CHECK)])
    x = us + 1e-2 * float(us.abs().max()) * noise * inside
    return p, b, x


def flat_batch(device, dtype, rmax):
    """BATCH_CHECK distinct flat-spectrum problems on the same operator."""
    from ttnx_torch.entry import batched_als_problem, flat_spectrum_stack

    p = batched_als_problem(device, batch=1, rmax=rmax, dtype=dtype)
    rng = np.random.default_rng(100 + rmax)
    b = np.stack([flat_spectrum_stack(rng, p["u_rks"], rmax)
                  for _ in range(BATCH_CHECK)])
    x = b + 0.3 * np.stack([flat_spectrum_stack(rng, p["u_rks"], rmax)
                            for _ in range(BATCH_CHECK)])
    return p, *(torch.as_tensor(a, dtype=dtype, device=device)
                for a in (b, x))


def phase_batched_kernels(device):
    from ttnx_torch.solvers.als_scan_batched import als_sweeps_b

    rows = []
    for dtype in (torch.float32, torch.float64):
        for rmax in BATCHED_RANKS:
            p, b, x = distinct_batch(device, dtype, rmax)
            seen = record_calls(lambda: als_sweeps_b(
                p["lhs_stack"], b, x, p["masks"], 2, cg_iters=CG_ITERS,
                solver="cg_fused"))
            args, kwargs = seen["cg_matfree_fused_batched"][MIDDLE_SITE]
            rows.append(hold("cg_matfree_fused_batched", rmax, dtype, args,
                             kwargs))
            for (args, kwargs), tag in zip(seen["env_chain_fused_batched"],
                                           (" right", " left")):
                rows.append(hold("env_chain_fused_batched", rmax, dtype,
                                 args, kwargs, tag=tag))
            p, b, x = flat_batch(device, dtype, rmax)
            sweep = (p["lhs_stack"], b, x, p["masks"])
            rows.append(hold("als_fwd_bwd_fused_batched", rmax, dtype, sweep,
                             {}, reps=1, repeats=3))
            if rmax == 32 and dtype == torch.float32:
                rows.append(hold("als_fwd_bwd_fused_batched", rmax, dtype,
                                 sweep, dict(cg_refine=2, cg_polish=2),
                                 reps=1, repeats=3, tag=" refine2 polish2"))
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
        want = dict.fromkeys(per_step, 0)
        want.update({"gram_chain_fused": 1, "right_env_chain_fused": 1,
                     "left_env_chain_fused": 1,
                     "cg_solve_fused": 2 * (D - 1) if dense_k else 0,
                     "cg_matfree_fused": 0 if dense_k else 2 * (D - 1)})
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
    missing = [k for k in CN_KERNELS if counts[k] == 0]
    if missing:
        raise RuntimeError(f"main path launched no {missing}")
    return counts


def timed_calls(fn, calls=3):
    """Seconds per call: median of ``calls`` host-timed calls after one
    warm-up, each ended by a synchronize; returns (seconds, last output)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def phase_batched_path(device):
    """Both routes of the batched bench at full width; returns the launch
    counts of each route's first call."""
    from ttnx_torch.core.decomp import ttv_to_tensor
    from ttnx_torch.entry import batched_als_problem
    from ttnx_torch.kernels import als_sweep_fused
    from ttnx_torch.kernels.dispatch import launch_counts, reset_launch_counts
    from ttnx_torch.solvers.als_scan import unpack_tt
    from ttnx_torch.solvers.als_scan_batched import als_sweeps_b
    from ttnx_torch.utils.flops import als_sweeps_flops

    p = batched_als_problem(device, batch=BATCH, rmax=64, d=D, h=H_STEP)
    A, bb, xb, masks = p["lhs_stack"], p["b_batch"], p["x_batch"], p["masks"]
    hg = 1.0 / (2 ** D + 1)
    c = H_STEP / (2 * hg ** 2)
    u0 = ttv_to_tensor(p["u0"]).reshape(-1).double().cpu().numpy()

    def unpack(stack):
        return unpack_tt(stack, p["u_rks"])
    routes = {
        "explicit_kernel": (
            lambda: als_sweeps_b(A, bb, xb, masks, 2, cg_iters=CG_ITERS,
                                 solver="cg_fused"),
            CG_ITERS + 1,
            {"env_chain_fused_batched": 2,
             "cg_matfree_fused_batched": 2 * (D - 1)}),
        "sweep_pair_fused": (
            lambda: als_sweep_fused.als_fwd_bwd_fused_batched(A, bb, xb,
                                                              masks),
            25, {"als_fwd_bwd_fused_batched": 1}),
    }
    route_counts = {}
    for route, (run, applies, launched) in routes.items():
        reset_launch_counts()
        run()
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {k: launched.get(k, 0) for k in counts}
        if counts != want:
            raise RuntimeError(f"{route}: launches per call {counts}, "
                               f"expected {want}")
        route_counts[route] = counts
        sec, out = timed_calls(run)
        with plain_versions():
            plain_sec, plain_out = timed_calls(run)
        if out.shape != xb.shape or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{route}: output is not a finite "
                               f"{tuple(xb.shape)} stack")
        x0 = dense(unpack, out[0])
        lhs = x0 + c * (2 * x0 - np.pad(x0[1:], (0, 1))
                        - np.pad(x0[:-1], (1, 0)))
        res = float(np.linalg.norm(lhs - u0) / np.linalg.norm(u0))
        agree = float(np.linalg.norm(x0 - dense(unpack, plain_out[0]))
                      / np.linalg.norm(x0))
        gflops = BATCH * als_sweeps_flops(D, 64, A.shape[1], 64,
                                          cg_iters=applies) / sec / 1e9
        log(f"batched {route} d={D} r64 B={BATCH} f32: {BATCH / sec:.2f} "
            f"solves/s ({gflops:.2f} GFLOP/s, {sec * 1e3:.1f} ms/call) | "
            f"plain {BATCH / plain_sec:.2f} solves/s ({plain_sec * 1e3:.1f} "
            f"ms/call) | residual[0] {res:.3e} (<= 1e-2) | kernel vs plain "
            f"vector[0] rel {agree:.3e} (<= 1e-4) | launches/call "
            f"{ {k: v for k, v in counts.items() if v} }")
        if not (np.isfinite(res) and res <= 1e-2 and agree <= 1e-4):
            raise RuntimeError(f"{route} failed its gates: residual={res:.3e}"
                               f" agree={agree:.3e}")
    return route_counts


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
    rows = phase_kernels(device) + phase_batched_kernels(device)
    counts = phase_main_path(device)
    for route_counts in phase_batched_path(device).values():
        for name, n in route_counts.items():
            if name not in CN_KERNELS:
                counts[name] += n
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
