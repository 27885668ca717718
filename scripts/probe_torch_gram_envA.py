"""Design probe of kernels B1 (the right-Gram chain of the CN rounding) and
B8 (the operator-only env chain of the DMRG sweeps) on one card.

    python3 scripts/probe_torch_gram_envA.py --step0
    python3 scripts/probe_torch_gram_envA.py

Builds ``gram_chain.cu``, ``gram_chain_grid.cu``, ``env_chain.cu`` and
``env_chain_site.cu`` (each ``nvcc -Xptxas -v``, printing every kernel
instantiation's registers and spill bytes) into one library, which the
wrappers of ``ttnx_torch.kernels`` then launch from. Inputs: B1 on the
call one heat CN step makes at ranks 16, 32 and 64 (RB = 64, 128, 256;
``chip_smoke.capture_inputs``, f32), B8 on the two calls (right, left)
one ``dmrg_eig_sweep`` makes at (d, rmax) = (10, 16) and (12, 64)
(``chip_smoke.DMRG_CONFIGS``, f32, RA = 5).

* ``--step0``: route ``staged`` only (``gram_chain.cu``,
  ``env_chain.cu``): each input's time (CUDA events, median of 3) beside
  the plain version's, and one torch.profiler window of each, its kernel
  launches split by kernel and by site. Then the grid-wide barrier:
  ``cooperative_groups::this_grid().sync()`` under
  ``cudaLaunchCooperativeKernel`` (built without ``-rdc``) and a
  counter barrier on global atomics, each timed as the difference of
  launches with 0 and ``BARRIERS`` barriers, at 8, 16, 132 and 264 CTAs
  of 256 threads.
* default: the new routes (B1 ``grid``, B8 ``cluster``) against their
  plain versions and against themselves (two launches bit-identical) on
  every input, beside route ``staged``; each input timed interleaved
  (new, staged, staged, new, by ``chip_smoke.forced_gram_envA_route``)
  beside the plain version, and one
  torch.profiler window of each route. (``chip_smoke.py`` phase 3f times
  the CN r64 step and the DMRG d = 12 sweep with the routes forced each
  way: they need the whole library.)

Needs a CUDA card with nvcc (sm_90a); imports torch, numpy, ttnx_torch and
chip_smoke only.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
import probe_torch_env as penv  # noqa: E402
from ttnx_torch.kernels import _build, dispatch  # noqa: E402

WORK = ROOT / "build" / "probe_gram_envA"
STAGED = ("gram_chain.cu", "env_chain.cu")
NEW = ("gram_chain_grid.cu", "env_chain_site.cu")
BARRIERS = 1000
BARRIER_CTAS = (8, 16, 132, 264)
BARRIER_SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void __launch_bounds__(256) grid_barriers(int n) {
  cg::grid_group g = cg::this_grid();
  for (int i = 0; i < n; ++i) g.sync();
}

// A sense-free counter barrier: the last CTA to arrive bumps the
// generation; the others spin on it.
__global__ void __launch_bounds__(256)
    counter_barriers(int n, unsigned* count, unsigned* gen) {
  for (int i = 0; i < n; ++i) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned g0 = atomicAdd(gen, 0u);
      __threadfence();
      if (atomicAdd(count, 1u) == gridDim.x - 1) {
        atomicExch(count, 0u);
        __threadfence();
        atomicAdd(gen, 1u);
      } else {
        while (atomicAdd(gen, 0u) == g0) {
        }
      }
      __threadfence();
    }
    __syncthreads();
  }
}

extern "C" int run_grid(int blocks, int n, void* stream) {
  void* args[] = {&n};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)grid_barriers, dim3(blocks), dim3(256), args, 0,
      (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int run_counter(int blocks, int n, void* count, void* gen,
                           void* stream) {
  void* args[] = {&n, &count, &gen};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (void*)counter_barriers, dim3(blocks), dim3(256), args, 0,
      (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int max_blocks() {
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_barriers,
                                                256, 0);
  return per_sm * sms;
}
"""


def cuda_ms(fn, reps=10) -> float:
    return chip_smoke.cuda_ms(fn, reps, 3)


def build(names):
    penv.WORK = WORK
    return penv.compile_sources(
        "now", {s: (_build.CSRC / s).read_text() for s in names})


def b1_inputs(dev):
    """``[(label, args, kwargs)]``: B1's call of one CN step at each
    rank."""
    out = []
    for rmax in chip_smoke.RANKS:
        args, kwargs = chip_smoke.capture_inputs(
            rmax, dev, torch.float32)["gram_chain_fused"]
        out.append((f"B1 r{rmax} RB={args[0].shape[1]}", args, kwargs))
    return out


def b8_inputs(dev):
    """``[(label, args, kwargs)]``: B8's two calls of the third
    dmrg_eig_sweep at each DMRG configuration (``chip_smoke.env_A_inputs``:
    every env column slab nonzero)."""
    from ttnx_torch.entry import dmrg_problem

    out = []
    for d, rmax in chip_smoke.DMRG_CONFIGS:
        p = dmrg_problem(dev, d=d, rmax=rmax)
        seen = chip_smoke.record_calls(lambda: chip_smoke.dmrg_sweeps(
            p, chip_smoke.ENV_A_SWEEPS, "lanczos"))
        for args, kwargs in chip_smoke.env_A_inputs(seen):
            side = "left" if kwargs.get("left") else "right"
            out.append((f"B8 d={d} R={rmax} RA={args[1].shape[1]} {side}",
                        args, kwargs))
    return out


def run_of(name, args, kwargs, plain=False):
    fn = chip_smoke.wrappers()[name][1 if plain else 0]
    return lambda: fn(*args, **kwargs)


def split_sites(label, run, d, per_site):
    """Device time of one call by kernel name and by site (``per_site``
    launches a site after the boundary fills)."""
    evs = [(penv.short(n), t) for n, t in penv.kernel_events(run)]
    total = sum(t for _, t in evs)
    by = {}
    for n, t in evs:
        by.setdefault(n, []).append(t)
    body = [t for n, t in evs if n != "set_e0"]
    sites = [sum(body[k * per_site:(k + 1) * per_site])
             for k in range(len(body) // per_site)]
    print(f"profile {label}: {len(evs)} launches, device {total / 1e3:.4f} "
          f"ms; by kernel (count, ms, us a launch): "
          + ", ".join(f"{n} {len(v)} {sum(v) / 1e3:.4f} "
                      f"{sum(v) / len(v):.2f}" for n, v in by.items())
          + "; by site (us): " + " ".join(f"{s:.1f}" for s in sites),
          flush=True)


def step0_kernels(dev):
    for label, args, kwargs in b1_inputs(dev):
        run = run_of("gram_chain_fused", args, kwargs)
        print(f"time {label} staged: {cuda_ms(run):.4f} ms, plain "
              f"{cuda_ms(run_of('gram_chain_fused', args, kwargs, True)):.4f}"
              f" ms", flush=True)
        split_sites(f"{label} staged", run, args[0].shape[0], 2)
    for label, args, kwargs in b8_inputs(dev):
        run = run_of("env_chain_A_fused", args, kwargs)
        print(f"time {label} staged: {cuda_ms(run):.4f} ms, plain "
              f"{cuda_ms(run_of('env_chain_A_fused', args, kwargs, True)):.4f}"
              f" ms", flush=True)
        split_sites(f"{label} staged", run, args[0].shape[0], 3)


def step0_barriers():
    d = WORK / "barrier"
    d.mkdir(parents=True, exist_ok=True)
    (d / "barrier.cu").write_text(BARRIER_SOURCE)
    so = d / "barrier.so"
    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         str(d / "barrier.cu"), "-o", str(so)], capture_output=True,
        text=True)
    print(f"barrier build without -rdc: exit {done.returncode}\n"
          f"{(done.stdout + done.stderr)[-3000:]}", flush=True)
    if done.returncode:
        return
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.run_grid.argtypes = [I, I, P]
    lib.run_counter.argtypes = [I, I, P, P, P]
    print(f"co-resident CTAs of 256 threads: {lib.max_blocks()}", flush=True)
    state = torch.zeros(2, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cnt, gen = state.data_ptr(), state.data_ptr() + 4
    for blocks in BARRIER_CTAS:
        for kind in ("grid.sync", "counter"):
            def launch(n, kind=kind, blocks=blocks):
                err = (lib.run_grid(blocks, n, stream) if kind == "grid.sync"
                       else lib.run_counter(blocks, n, cnt, gen, stream))
                if err:
                    raise RuntimeError(f"{kind} at {blocks}: CUDA error "
                                       f"{err}")
            try:
                t0 = cuda_ms(lambda: launch(0))
                tn = cuda_ms(lambda: launch(BARRIERS))
            except RuntimeError as e:
                print(f"barrier {kind} {blocks} CTAs: {e}", flush=True)
                continue
            print(f"barrier {kind} {blocks} CTAs: launch {t0 * 1e3:.2f} us, "
                  f"{(tn - t0) / BARRIERS * 1e6:.1f} ns a barrier",
                  flush=True)


def cases(dev):
    return ([("gram_chain_fused", *c) for c in b1_inputs(dev)]
            + [("env_chain_A_fused", *c) for c in b8_inputs(dev)])


def check_and_time(all_cases):
    for name, label, args, kwargs in all_cases:
        kernel, plain = chip_smoke.wrappers()[name]
        for route in ("new", "staged"):
            with chip_smoke.forced_gram_envA_route(route):
                before = dispatch.route_counts()
                got, again = kernel(*args, **kwargs), kernel(*args, **kwargs)
                taken = "/".join(chip_smoke.routes_of(name, before))
            ref = plain(*args, **kwargs)
            torch.cuda.synchronize()
            err = chip_smoke.max_err(got, ref)[1]
            same = torch.equal(got, again)
            print(f"check {label} route {taken}: max rel err against plain "
                  f"{err:.3e} (<= 1e-4), two launches bit-identical {same}",
                  flush=True)
            if route == "new" and not (err <= 1e-4 and same):
                raise RuntimeError(f"{label}: route {taken} is wrong")
        times = []
        for route in ("new", "staged", "staged", "new"):
            with chip_smoke.forced_gram_envA_route(route):
                times.append(cuda_ms(lambda: kernel(*args, **kwargs)))
        plain_ms = cuda_ms(lambda: plain(*args, **kwargs))
        print(f"time {label} (new, staged, staged, new): "
              f"{', '.join(f'{t:.4f}' for t in times)} ms; plain "
              f"{plain_ms:.4f} ms", flush=True)
        for route in ("new", "staged"):
            with chip_smoke.forced_gram_envA_route(route):
                evs = penv.kernel_events(lambda: kernel(*args, **kwargs))
            print(f"profile {label} {route}: {len(evs)} kernels, device "
                  f"{sum(t for _, t in evs) / 1e3:.4f} ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--step0", action="store_true",
                    help="route staged and the grid barrier only")
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
    _build._LIB = build(STAGED if opt.step0 else STAGED + NEW)
    if opt.step0:
        step0_kernels(dev)
        step0_barriers()
        return 0
    check_and_time(cases(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
