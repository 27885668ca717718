"""Design probe of kernels B3 (the dense CG) and B9 (the dense Lanczos) on
one card.

    python3 scripts/probe_torch_cg_lanczos.py --step0
    python3 scripts/probe_torch_cg_lanczos.py [--no-paths]
    python3 scripts/probe_torch_cg_lanczos.py --paths
    python3 scripts/probe_torch_cg_lanczos.py --b10-parent FILE

Builds ``local_cg.cu`` and ``lanczos.cu`` (each ``nvcc -Xptxas -v``,
printing every kernel instantiation's registers and spill bytes) into one
library, which the wrappers of ``ttnx_torch.kernels`` then launch from,
and a small probe library. Inputs: B3 on the K of the rank-16 heat CN
step (f32, M = 512, 16 warm iterations: local solve ``MIDDLE_SITE`` of
``chip_smoke.py`` and all 22 of the step), B9 on the K the d = 10 DMRG
sweep assembles (f32, M = 1024, iters 8: local eigensolve
``MIDDLE_SITE`` and all 18 of the sweep).

* ``--step0``: the kernels of route ``l2`` only, each split by its own
  ``iters`` (B9 1 / 8 / 24, B3 warm 0 / 8 / 16; CUDA events, median of
  3, warm); the cost of one cluster barrier at C = 8 and C = 16 (an empty
  kernel on one cluster running N rounds of cooperative groups'
  ``sync()``, alone and with one 256-byte ``map_shared_rank`` store a CTA
  a round); what ``cudaOccupancyMaxActiveClusters`` says of a cluster of
  8 and of 16 CTAs (non-portable) at several dynamic shared-memory sizes;
  and the rate at which one SM, and 16 SMs at once, stream rows of 1024
  floats from L2 into registers (one row a warp, 32 scalar loads a lane
  or 8 float4 loads a lane, all in flight at once).
* default: each new kernel checked against its plain version and against
  itself (two launches bit-identical) on its path's inputs, timed
  interleaved with the old route's (new, old, old, new), split by
  ``iters``, over all the launches of a step or sweep, the host's cost
  to enqueue one launch of each route, then the paths (alone with
  ``--paths``).
* ``--paths``: the heat CN step at rank 16 (``chip_smoke.py`` phase 4's
  settings, ms/step: median of 3 chains of 8 steps) with B3's route
  forced to ``l2`` and as chosen (``cluster``), and the d = 10 DMRG sweep
  through ``lanczos_fused`` (phase 6's settings, ms/sweep) with B9's
  route forced likewise, interleaved: cluster, l2, l2, cluster, twice,
  and the median of each route's four; then one torch.profiler window
  of each (8 steps, 4 sweeps): wall and device kernel time a call and
  the device's busy share. Forcing
  the route is a patch of ``local_cg.cg_route`` / ``lanczos.lanczos_route``
  inside this process; it builds the whole library.
* ``--b10-parent FILE``: B10's cluster kernel's PTX from ``local_cg.cu``
  against the same kernel's PTX from FILE (an earlier ``local_cg.cu``, with
  the ``dense_cluster.cuh`` given by ``--b10-parent-header``, else the
  current one): equal or not, once the branch labels' function index
  (which moves when kernels are added to the file) is taken out.

Needs a CUDA card with nvcc (sm_90a); imports torch, numpy, ttnx_torch and
chip_smoke only.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ttnx_torch.kernels import _build, dispatch  # noqa: E402

WORK = ROOT / "build" / "probe_cg_lanczos"
SOURCES = ("local_cg.cu", "lanczos.cu")
ROW = 1024  # floats a streamed row: B9's M

PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace cg = cooperative_groups;

// One cluster running `rounds` cluster barriers; mode 1 adds one 256-byte
// store a CTA a round into the next CTA's shared memory.
__global__ void __launch_bounds__(256)
    barrier_probe(int rounds, int mode, float* sink) {
  extern __shared__ float buf[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  if (tid < 64) buf[tid] = 0.f;
  cluster.sync();
  float* peer = cluster.map_shared_rank(buf, (rank + 1) % C);
  for (int i = 0; i < rounds; ++i) {
    if (mode == 1 && tid < 64) peer[tid] = (float)i;
    cluster.sync();
  }
  if (tid == 0) sink[blockIdx.x] = buf[0];
}

static cudaLaunchConfig_t cluster_cfg(int C, int smem, cudaStream_t st,
                                      cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(256, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

static int prepare(int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      barrier_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(
      barrier_probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

extern "C" int probe_barrier(int C, int rounds, int mode, void* sink,
                             void* stream) {
  int e = prepare(1024);
  if (e) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_cfg(C, 1024, (cudaStream_t)stream, attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, barrier_probe, rounds, mode,
                                       (float*)sink);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of C CTAs of 256 threads with `smem` bytes of dynamic shared
// memory each that can be active at once (0: none fits), or -error.
extern "C" int probe_occupancy(int C, int smem) {
  int e = prepare(smem);
  if (e) return -e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_cfg(C, smem, 0, attr);
  int clusters = -1;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, barrier_probe,
                                                   &cfg);
  if (err != cudaSuccess) return -(int)err;
  return clusters;
}

__device__ __forceinline__ float ldcg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float4 ldcg4(const float4* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// Block b streams rows [b rows, b rows + rows) of K (ROW floats each) from
// L2, `rounds` times: one row a warp, all of a lane's loads of the row in
// flight at once (mode 0: 32 scalars, mode 1: 8 float4).
__global__ void __launch_bounds__(256)
    stream_probe(const float* K, int rows, int rounds, int mode,
                 float* sink) {
  extern __shared__ float hold[];  // only to keep one block on an SM
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* base = K + (size_t)blockIdx.x * rows * 1024;
  float acc = 0.f;
  for (int it = 0; it < rounds; ++it)
    for (int r = warp; r < rows; r += 8) {
      const float* kr = base + (size_t)r * 1024;
      if (mode == 0) {
        float k[32];
#pragma unroll
        for (int u = 0; u < 32; ++u) k[u] = ldcg(kr + lane + 32 * u);
#pragma unroll
        for (int u = 0; u < 32; ++u) acc += k[u];
      } else {
        float4 k[8];
        const float4* k4 = reinterpret_cast<const float4*>(kr);
#pragma unroll
        for (int u = 0; u < 8; ++u) k[u] = ldcg4(k4 + lane + 32 * u);
#pragma unroll
        for (int u = 0; u < 8; ++u) acc += k[u].x + k[u].y + k[u].z + k[u].w;
      }
    }
  hold[threadIdx.x] = acc;
  if (acc == 1234.5f) sink[blockIdx.x] = hold[(threadIdx.x + 1) & 255];
}

extern "C" int probe_stream(const void* K, int blocks, int rows, int rounds,
                            int mode, void* sink, void* stream) {
  const int smem = 160 * 1024;
  cudaError_t e = cudaFuncSetAttribute(
      stream_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  stream_probe<<<blocks, 256, smem, (cudaStream_t)stream>>>(
      (const float*)K, rows, rounds, mode, (float*)sink);
  return (int)cudaGetLastError();
}
"""


def ptxas_lines(label, out, err, keep=lambda name: True):
    lines = (out + err).splitlines()
    for k, ln in enumerate(lines):
        if "Compiling entry" in ln:
            kern = ln.split("'")[1]
            if not keep(kern):
                continue
            info = " | ".join(
                x.split(":")[-1].strip() for x in lines[k + 1:k + 5]
                if "registers" in x or "spill" in x)
            print(f"ptxas {label}: {demangle(kern)} | {info}", flush=True)


def compile_all():
    """The two sources into one library (assigned to ``_build._LIB``) and
    the probe kernels into another; prints ptxas's registers and spills of
    every kernel. Returns the probe's CDLL."""
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / "probe.cu").write_text(PROBE)
    jobs = [(_build.CSRC / s, WORK / (Path(s).stem + ".o")) for s in SOURCES]
    jobs.append((WORK / "probe.cu", WORK / "probe.o"))
    procs = [(src, obj, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(_build.CSRC), "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for src, obj in jobs]
    for src, _, proc in procs:
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{err[-6000:]}")
        ptxas_lines(src.name, out, err)
    so = WORK / "kernels.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), *(str(obj) for _, obj, _ in procs[:-1])],
                   check=True)
    probe_so = WORK / "probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(probe_so), str(procs[-1][1])], check=True)
    handle = ctypes.CDLL(str(so))
    for name, (argtypes, suffixes) in _build._SIGNATURES.items():
        for suffix in suffixes:
            fn = getattr(handle, f"ttnx_{name}_{suffix}", None)
            if fn is not None:
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
    _build._LIB = handle
    probe = ctypes.CDLL(str(probe_so))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (("probe_barrier", [I, I, I, P, P]),
                           ("probe_occupancy", [I, I]),
                           ("probe_stream", [P, I, I, I, I, P, P])):
        fn = getattr(probe, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return probe


def demangle(name):
    filt = subprocess.run(["c++filt", name], capture_output=True, text=True)
    return (filt.stdout.strip() or name)[:100]


def cuda_ms(fn, reps=1) -> float:
    return chip_smoke.cuda_ms(fn, reps, 3)


def stream():
    return torch.cuda.current_stream().cuda_stream


def b3(entry, K, rhs, x0):
    """B3 through ``entry`` ("cg_solve" or "cg_solve_cluster"), warm."""
    def run(iters):
        out = torch.empty_like(rhs)
        _build.call(entry, K.dtype, K.data_ptr(), rhs.data_ptr(),
                    x0.data_ptr(), out.data_ptr(), K.shape[0], iters, 1)
        return out
    return run


def b9(entry, K, v0):
    """B9 through ``entry`` ("lanczos" or "lanczos_cluster")."""
    def run(iters):
        M = K.shape[0]
        Q = torch.empty((iters, M), dtype=K.dtype, device=K.device)
        a = torch.empty(iters, dtype=K.dtype, device=K.device)
        b = torch.empty(iters, dtype=K.dtype, device=K.device)
        _build.call(entry, K.dtype, K.data_ptr(), v0.data_ptr(),
                    Q.data_ptr(), a.data_ptr(), b.data_ptr(), M, iters)
        return Q, a, b
    return run


def split(label, run, its, reps):
    t = {it: cuda_ms(lambda: run(it), reps) for it in its}
    per_it = (t[its[-1]] - t[its[-2]]) / (its[-1] - its[-2])
    fixed = t[its[0]] - its[0] * per_it
    print(f"split {label}: iters {' / '.join(map(str, its))}: "
          f"{' / '.join(f'{v:.4f}' for v in t.values())} ms; "
          f"{per_it * 1e3:.3f} us an iteration, fixed {fixed * 1e3:.2f} us",
          flush=True)


def barrier_cost(probe):
    sink = torch.zeros(16, device="cuda")
    for C in (8, 16):
        for mode, label in ((0, "cg sync() alone"),
                            (1, "sync() + 256 B map_shared_rank store a "
                                "CTA")):
            def run(rounds, C=C, mode=mode):
                err = probe.probe_barrier(C, rounds, mode, sink.data_ptr(),
                                          stream())
                if err:
                    raise RuntimeError(f"barrier probe C={C}: CUDA error "
                                       f"{err}")
            t = {n: cuda_ms(lambda n=n: run(n), 5) for n in (0, 1000, 10000)}
            per = (t[10000] - t[1000]) / 9000
            print(f"cluster of {C}, {label}: rounds 0 / 1000 / 10000: "
                  f"{t[0]:.4f} / {t[1000]:.4f} / {t[10000]:.4f} ms; "
                  f"{per * 1e6:.1f} ns a round", flush=True)


def occupancy(probe):
    for C in (8, 16):
        for smem in (1024, 131072, 200704, 229376, 232448):
            n = probe.probe_occupancy(C, smem)
            print(f"occupancy: clusters of {C} CTAs (256 threads, {smem} B "
                  f"dynamic shared memory a CTA) active at once: "
                  f"{n if n >= 0 else f'error {-n}'}", flush=True)


def l2_stream(probe):
    """Rows of ROW floats from L2 into registers: one SM and 16 at once,
    10 and 74 rows a block (B9's streamed rows at C = 16 and 8)."""
    K = torch.randn(16 * 74 * ROW, device="cuda")
    sink = torch.zeros(16, device="cuda")
    for blocks in (1, 16):
        for rows in (10, 74):
            for mode, label in ((0, "32 scalar loads a lane"),
                                (1, "8 float4 loads a lane")):
                def run(rounds, blocks=blocks, rows=rows, mode=mode):
                    err = probe.probe_stream(K.data_ptr(), blocks, rows,
                                             rounds, mode, sink.data_ptr(),
                                             stream())
                    if err:
                        raise RuntimeError(f"stream probe: CUDA error {err}")
                t = {n: cuda_ms(lambda n=n: run(n), 5) for n in (10, 110)}
                per = (t[110] - t[10]) / 100 * 1e-3  # s a round
                sm_rate = rows * ROW * 4 / per
                print(f"L2 stream: {blocks} SM(s), {rows} rows of {ROW} "
                      f"floats a block, {label}: {per * 1e6:.3f} us a round"
                      f", {sm_rate / 1e9:.1f} GB/s an SM, "
                      f"{blocks * sm_rate / 1e9:.1f} GB/s in all",
                      flush=True)


def cn_inputs(dev):
    """The 22 (K, rhs, x0, iters) of one r16 heat CN step, f32, as
    chip_smoke.py records them."""
    step_fn, us, _ = chip_smoke.setup(16, dev)
    seen = chip_smoke.record_calls(lambda: step_fn(us))
    out = []
    for (K, rhs), kw in seen["cg_solve_fused"]:
        assert kw["x0"] is not None and kw["iters"] == chip_smoke.CG_ITERS
        out.append((K.contiguous(), rhs.contiguous(), kw["x0"].contiguous()))
    return out


def dmrg_inputs(dev):
    """The 18 (K, v0) of one d = 10 DMRG sweep through lanczos_fused, f32,
    as chip_smoke.py phase 3c records them."""
    from ttnx_torch.entry import dmrg_problem

    d, rmax = chip_smoke.DMRG_CONFIGS[0]
    p = dmrg_problem(dev, d=d, rmax=rmax)
    seen = chip_smoke.record_calls(
        lambda: chip_smoke.dmrg_sweeps(p, 1, "lanczos_fused"))
    out = []
    for (K, v0), kw in seen["lanczos_fused"]:
        assert kw["iters"] == chip_smoke.DMRG_ITERS
        out.append((K.contiguous(), v0.contiguous()))
    return out


def step0(probe, cn, dm):
    K, rhs, x0 = cn[chip_smoke.MIDDLE_SITE]
    split("B3 l2 r16 CN MIDDLE_SITE warm", b3("cg_solve", K, rhs, x0),
          (0, 8, 16), 10)
    K, v0 = dm[chip_smoke.MIDDLE_SITE]
    split("B9 l2 d=10 sweep MIDDLE_SITE", b9("lanczos", K, v0), (1, 8, 24),
          10)
    barrier_cost(probe)
    occupancy(probe)
    l2_stream(probe)


def ritz(got, ref):
    """B9 on a sweep's K, gauge-free: chip_smoke's Ritz-pair error."""
    return chip_smoke.ritz_err(got, ref)[1]


def residual(K, x, b):
    """|K x - b| / |b| in float64."""
    K, x, b = K.double(), x.double(), b.double()
    return float((K @ x - b).norm() / b.norm())


def check(cn, dm):
    """Each new kernel against its plain version on every input of its
    path, beside PR 1/3's kernel, with K's extreme eigenvalues and each
    solve's residual; gates as chip_smoke.py's: at MIDDLE_SITE rel <= 1e-4
    (B9 gauge-free), and everywhere two launches bit-identical."""
    from ttnx_torch.kernels.lanczos import lanczos_plain
    from ttnx_torch.kernels.local_cg import cg_solve_plain

    it = chip_smoke.CG_ITERS
    for i, (K, rhs, x0) in enumerate(cn):
        got = b3("cg_solve_cluster", K, rhs, x0)(it)
        again = b3("cg_solve_cluster", K, rhs, x0)(it)
        old = b3("cg_solve", K, rhs, x0)(it)
        ref = cg_solve_plain(K, rhs, x0=x0, iters=it)
        err = float((got - ref).abs().max() / ref.abs().max())
        err_old = float((old - ref).abs().max() / ref.abs().max())
        same = torch.equal(got, again)
        ev = torch.linalg.eigvalsh(K.double())
        active = ev[ev.abs() > 1e-30]
        ref64 = cg_solve_plain(K.double(), rhs.double(), x0=x0.double(),
                               iters=it)
        err64 = float((ref.double() - ref64).abs().max() / ref64.abs().max())
        print(f"check B3 cluster r16 solve {i}: max rel err against plain "
              f"{err:.3e}, the l2 kernel {err_old:.3e}, plain f32 against "
              f"plain f64 {err64:.3e}; residual cluster "
              f"{residual(K, got, rhs):.3e} l2 {residual(K, old, rhs):.3e} "
              f"plain {residual(K, ref, rhs):.3e}; |eig(K)| above 1e-30: "
              f"{float(active.abs().min()):.3e} .. "
              f"{float(active.abs().max()):.3e}; two launches bit-identical "
              f"{same}", flush=True)
        gate = i == chip_smoke.MIDDLE_SITE
        if not same or (gate and not err <= 1e-4):
            raise RuntimeError(f"B3 cluster is wrong at solve {i}")
    it = chip_smoke.DMRG_ITERS
    for i, (K, v0) in enumerate(dm):
        got = b9("lanczos_cluster", K, v0)(it)
        again = b9("lanczos_cluster", K, v0)(it)
        old = b9("lanczos", K, v0)(it)
        ref = lanczos_plain(K, v0, iters=it)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        err, err_old = ritz(got, ref), ritz(old, ref)
        rows = chip_smoke.max_err(got, ref)[1]
        rows_old = chip_smoke.max_err(old, ref)[1]
        ref64 = lanczos_plain(K.double(), v0.double(), iters=it)
        rows64 = chip_smoke.max_err(tuple(t.double() for t in ref), ref64)[1]
        print(f"check B9 cluster d=10 solve {i}: Ritz pair rel err against "
              f"plain {err:.3e}, the l2 kernel {err_old:.3e}; Q, alphas, "
              f"betas max rel {rows:.3e}, the l2 kernel {rows_old:.3e}, "
              f"plain f32 against plain f64 {rows64:.3e}; smallest beta "
              f"{float(ref[2][:-1].min()):.3e}; two launches bit-identical "
              f"{same}", flush=True)
        gate = i == chip_smoke.MIDDLE_SITE
        if not same or (gate and not err <= 1e-4):
            raise RuntimeError(f"B9 cluster is wrong at solve {i}")


def time_pair(label, new, old, reps):
    for name, run in (("new", new), ("old", old), ("old", old),
                      ("new", new)):
        print(f"time {label} {name}: {cuda_ms(run, reps):.4f} ms",
              flush=True)


def timings(cn, dm):
    it3, it9 = chip_smoke.CG_ITERS, chip_smoke.DMRG_ITERS
    K, rhs, x0 = cn[chip_smoke.MIDDLE_SITE]
    time_pair("B3 r16 MIDDLE_SITE iters 16 warm",
              lambda: b3("cg_solve_cluster", K, rhs, x0)(it3),
              lambda: b3("cg_solve", K, rhs, x0)(it3), 10)
    split("B3 cluster r16 MIDDLE_SITE warm",
          b3("cg_solve_cluster", K, rhs, x0), (0, 8, 16), 10)
    K9, v0 = dm[chip_smoke.MIDDLE_SITE]
    for iters in (it9, 24):
        time_pair(f"B9 d=10 MIDDLE_SITE iters {iters}",
                  lambda: b9("lanczos_cluster", K9, v0)(iters),
                  lambda: b9("lanczos", K9, v0)(iters), 10)
    split("B9 cluster d=10 MIDDLE_SITE", b9("lanczos_cluster", K9, v0),
          (1, 8, 24), 10)
    for entry in ("cg_solve_cluster", "cg_solve", "cg_solve",
                  "cg_solve_cluster"):
        per = [cuda_ms(lambda a=a: b3(entry, *a)(it3), 10) for a in cn]
        print(f"time B3 {entry} over the 22 local solves of a step: "
              f"{sum(per):.4f} ms (min {min(per):.4f}, max {max(per):.4f} "
              f"a launch)", flush=True)
    for entry in ("lanczos_cluster", "lanczos", "lanczos",
                  "lanczos_cluster"):
        per = [cuda_ms(lambda a=a: b9(entry, *a)(it9), 10) for a in dm]
        print(f"time B9 {entry} over the 18 local eigensolves of a sweep: "
              f"{sum(per):.4f} ms (min {min(per):.4f}, max {max(per):.4f} "
              f"a launch)", flush=True)


def paths(dev):
    """The CN r16 step and the d = 10 DMRG sweep with each new kernel's
    route forced either way, interleaved."""
    from ttnx_torch.kernels import lanczos, local_cg

    _build._LIB = None
    _build.lib()  # the whole library: the paths run B1, B2 and B8 too
    print(f"build for the paths: nvcc {_build.BUILD_SECONDS} s", flush=True)
    chosen3, chosen9 = local_cg.cg_route, lanczos.lanczos_route
    step_fn, us, _ = chip_smoke.setup(16, dev)
    d, rmax = chip_smoke.DMRG_CONFIGS[0]
    from ttnx_torch.entry import dmrg_problem

    p = dmrg_problem(dev, d=d, rmax=rmax)
    order = ("cluster", "l2", "l2", "cluster") * 2
    try:
        got = {"cluster": [], "l2": []}
        for route in order:
            local_cg.cg_route = chosen3 if route == "cluster" else (
                lambda *shape: "l2")
            before = dispatch.route_counts()
            ms = chip_smoke.timed_chain(step_fn, us)[0]
            assert set(chip_smoke.routes_of("cg_solve_fused",
                                            before)) == {route}
            got[route].append(ms)
            print(f"path cn_step d={chip_smoke.D} r16 ms/step B3 route "
                  f"{route}: {ms:.3f}", flush=True)
        print(f"path cn_step r16 median ms/step: cluster "
              f"{statistics.median(got['cluster']):.3f}, l2 "
              f"{statistics.median(got['l2']):.3f}", flush=True)
        got = {"cluster": [], "l2": []}
        for route in order:
            lanczos.lanczos_route = chosen9 if route == "cluster" else (
                lambda *shape: "l2")
            before = dispatch.route_counts()
            ms = chip_smoke.timed_sweeps(p, "lanczos_fused")[0]
            assert set(chip_smoke.routes_of("lanczos_fused",
                                            before)) == {route}
            got[route].append(ms)
            print(f"path dmrg d={d} r{rmax} lanczos_fused ms/sweep B9 route "
                  f"{route}: {ms:.3f}", flush=True)
        print(f"path dmrg d={d} median ms/sweep: cluster "
              f"{statistics.median(got['cluster']):.3f}, l2 "
              f"{statistics.median(got['l2']):.3f}", flush=True)
        for route in ("cluster", "l2"):
            local_cg.cg_route = chosen3 if route == "cluster" else (
                lambda *shape: "l2")
            lanczos.lanczos_route = chosen9 if route == "cluster" else (
                lambda *shape: "l2")
            profiled(f"cn_step r16 B3 route {route}",
                     lambda: step_fn(us), 8)
            profiled(f"dmrg d={d} lanczos_fused sweep B9 route {route}",
                     lambda: chip_smoke.dmrg_sweeps(p, 1, "lanczos_fused"),
                     4)
    finally:
        local_cg.cg_route, lanczos.lanczos_route = chosen3, chosen9


def enqueue_us(run, n=200):
    """Host microseconds to enqueue one launch: ``n`` launches on the host
    clock, no synchronize inside (the device queue does not fill)."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def profiled(label, run, n):
    """Device kernel time and wall time a call of ``run`` over ``n`` calls
    under torch.profiler, after one warm call."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    dev, kernels = 0.0, 0
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "device_time", None)
            dev += e.cuda_time if t is None else t
            kernels += 1
    print(f"profile {label}: wall {wall:.3f} ms a call, device kernels "
          f"{dev / n / 1e3:.3f} ms a call ({kernels / n:.0f} kernels), busy "
          f"share {dev / n / 1e3 / wall:.3f}", flush=True)


def host_costs(cn, dm):
    """Enqueue cost of one launch of each route on the host."""
    it3, it9 = chip_smoke.CG_ITERS, chip_smoke.DMRG_ITERS
    K, rhs, x0 = cn[chip_smoke.MIDDLE_SITE]
    K9, v0 = dm[chip_smoke.MIDDLE_SITE]
    for entry in ("cg_solve_cluster", "cg_solve"):
        print(f"host B3 {entry}: "
              f"{enqueue_us(lambda: b3(entry, K, rhs, x0)(it3)):.1f} us to "
              f"enqueue a launch", flush=True)
    for entry in ("lanczos_cluster", "lanczos"):
        print(f"host B9 {entry}: "
              f"{enqueue_us(lambda: b9(entry, K9, v0)(it9)):.1f} us to "
              f"enqueue a launch", flush=True)


def entry_ptx(src: Path, header: Path | None, name: str) -> str:
    """The PTX of the kernel entry whose mangled name contains ``name``,
    compiled from ``src`` (with ``header`` as dense_cluster.cuh)."""
    d = WORK / f"ptx_{src.stem}_{abs(hash(str(src))) % 10 ** 6}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "local_cg.cu").write_text(src.read_text())
    (d / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
    (d / "dense_cluster.cuh").write_text(
        (header or _build.CSRC / "dense_cluster.cuh").read_text())
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-ptx", "-I", str(d),
                    str(d / "local_cg.cu"), "-o", str(d / "out.ptx")],
                   check=True)
    ptx = (d / "out.ptx").read_text()
    m = re.search(r"\.entry (\S*" + name + r"\S*)\(.*?\n}\n", ptx, re.S)
    if m is None:
        raise RuntimeError(f"no entry {name} in the PTX of {src}")
    # branch labels carry the function's index in the file: $L__BB<i>_<n>
    return re.sub(r"\$L__BB\d+_", "$L__BB_", m.group(0))


def b10_ptx(parent: Path, parent_header: Path | None):
    new = entry_ptx(_build.CSRC / "local_cg.cu", None,
                    "bicgstab_cluster_kernel")
    old = entry_ptx(parent, parent_header, "bicgstab_cluster_kernel")
    print(f"B10 cluster kernel PTX: {len(new.splitlines())} lines now, "
          f"{len(old.splitlines())} in {parent.name}; identical up to the "
          f"function index in its branch labels {new == old}", flush=True)
    if new != old:
        import difflib

        for ln in list(difflib.unified_diff(old.splitlines(),
                                            new.splitlines(), lineterm="",
                                            n=0))[:40]:
            print(f"  ptx diff: {ln[:150]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--step0", action="store_true",
                    help="the old routes' splits, barriers, occupancy, L2")
    ap.add_argument("--paths", action="store_true",
                    help="only the CN step and DMRG sweep by route")
    ap.add_argument("--no-paths", action="store_true")
    ap.add_argument("--b10-parent", type=Path,
                    help="compare B10's PTX with this local_cg.cu")
    ap.add_argument("--b10-parent-header", type=Path,
                    help="the dense_cluster.cuh of --b10-parent")
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
    if opt.b10_parent:
        b10_ptx(opt.b10_parent, opt.b10_parent_header)
    probe = compile_all()
    if opt.paths:
        paths(dev)
        return 0
    cn, dm = cn_inputs(dev), dmrg_inputs(dev)
    if opt.step0:
        step0(probe, cn, dm)
        return 0
    check(cn, dm)
    timings(cn, dm)
    host_costs(cn, dm)
    if not opt.no_paths:
        paths(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
