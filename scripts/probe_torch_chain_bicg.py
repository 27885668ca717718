"""Design probe of kernels B12 (the bf16 matmul chain) and B10 (the dense
BiCGStab) on one card.

    python3 scripts/probe_torch_chain_bicg.py --step0
    python3 scripts/probe_torch_chain_bicg.py [--no-paths]
    python3 scripts/probe_torch_chain_bicg.py --paths

Builds ``gram_chain.cu``, ``env_chain.cu``, ``local_cg.cu`` and
``contraction.cu`` (each ``nvcc -Xptxas -v``, printing every kernel
instantiation's registers and spill bytes) into one library, which the
wrappers of ``ttnx_torch.kernels`` then launch from, and a small cluster
probe kernel. On the bench inputs (``entry.matmul_ceiling_problem``,
bf16, (4096, 128, 128)) and on the K the convection CN step assembles (f32,
M = 512: local solve ``CONV_SITE`` of ``chip_smoke.py`` and all 22 of the
step):

* ``--step0``: the kernels of routes ``wmma`` (B12) and ``l2`` (B10)
  only, each split by its own ``iters`` (B12 0 / 8 / 64 / 1024, B10 0 /
  16 / 32; CUDA events, median of 3, warm);
  the cost of one cluster barrier (an empty kernel on a cluster of 8 CTAs
  running N rounds of ``barrier.cluster.arrive.release`` +
  ``wait.acquire``, alone, with one 256-byte DSMEM store a CTA a round,
  and as cooperative groups' ``map_shared_rank`` store + ``sync()``); and
  the new kernels checked against their plain versions, untimed.
* default: the checks, then each new kernel timed interleaved with the
  old route's (new, old, old, new), the new kernels' own splits, B10 over
  the 22 local solves of a step, then the paths (alone with ``--paths``).
* ``--variants``: B10's cluster kernel and the variants of ``VARIANTS``
  (text edits of ``local_cg.cu`` / ``dense_cluster.cuh``, one library
  each, registers and spills printed) checked against the plain version
  and timed interleaved at ``CONV_SITE`` (base, variants, then the
  reverse).
* ``--paths``: the convection CN step (``chip_smoke.py`` phase 8's
  settings, ms/step: median of 3 chains of 8 steps) with B10's route
  forced to ``l2`` and as chosen (``cluster``), interleaved: cluster, l2,
  l2, cluster. Forcing the route is a patch of
  ``local_cg.bicgstab_route`` inside this process.

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

import chip_smoke  # noqa: E402
from ttnx_torch.kernels import _build  # noqa: E402

WORK = ROOT / "build" / "probe_chain_bicg"
SOURCES = ("gram_chain.cu", "env_chain.cu", "local_cg.cu", "contraction.cu")
BF16_ULP = 2.0 ** -8

# B10 cluster variants: name -> [(file, old text, new text), ...]; the
# edits must match the source exactly or the probe stops
PUSH_S = ("local_cg.cu", """    if (w0)
      for (int i = lane; i < rows; i += 32)
        push_all<C>(s, row0 + i, r[i] - alpha * v[i]);""",
          """    for (int i = tid; i < rows; i += nt)
      push_all<C>(s, row0 + i, r[i] - alpha * v[i]);""")
PUSH_P = ("local_cg.cu", """    if (w0)
      for (int i = lane; i < rows; i += 32) {
        const int j = row0 + i;""", """    for (int i = tid; i < rows; i += nt) {
        const int j = row0 + i;""")
THREADS_512 = ("local_cg.cu", "constexpr int kClusterThreads = 256;",
               "constexpr int kClusterThreads = 512;")
ROWS_8 = ("dense_cluster.cuh", "constexpr int kSliceRows = 4;",
          "constexpr int kSliceRows = 8;")
OWN_ONLY = ("dense_cluster.cuh",
            "for (int c = 0; c < C; ++c) cluster_map(a, c)[i] = v;",
            "cluster_map(a, cluster_rank())[i] = v;")
VARIANTS = {
    "512 threads": [THREADS_512],
    "8 rows a warp": [ROWS_8],
    "pushes by all warps": [PUSH_S, PUSH_P],
    "512 threads, pushes by all warps": [THREADS_512, PUSH_S, PUSH_P],
    "slices pushed to the own CTA only (measurement only)": [OWN_ONLY],
}

# One cluster of 8 CTAs, 256 threads each, running `rounds` cluster
# barriers; mode 1 adds one 256-byte store a CTA a round into the next
# CTA's shared memory (st.shared::cluster), mode 2 does the same through
# cooperative groups (map_shared_rank, then sync()).
BARRIER_PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
namespace cg = cooperative_groups;

__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(256)
    barrier_probe(int rounds, int mode, float* sink) {
  __shared__ float buf[64];
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int tid = threadIdx.x;
  if (tid < 64) buf[tid] = 0.f;
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  const uint32_t local =
      (uint32_t)__cvta_generic_to_shared(buf + (tid & 63));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"((rank + 1) % 8));
  cg::cluster_group cluster = cg::this_cluster();
  float* peer = cluster.map_shared_rank(buf, (int)((rank + 1) % 8));
  for (int i = 0; i < rounds; ++i) {
    if (mode == 2) {
      if (tid < 64) peer[tid] = (float)i;
      cluster.sync();
      continue;
    }
    if (mode == 1 && tid < 64)
      asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote),
                   "f"((float)i) : "memory");
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
  if (tid == 0) sink[blockIdx.x] = buf[0];
}

extern "C" int probe_barrier(int rounds, int mode, void* sink,
                             void* stream) {
  barrier_probe<<<8, 256, 0, (cudaStream_t)stream>>>(rounds, mode,
                                                     (float*)sink);
  return (int)cudaGetLastError();
}
"""


def compile_all():
    """The four sources into one library (assigned to ``_build._LIB``) and
    the barrier probe into another; prints ptxas's registers and spills
    of every kernel. Returns the probe's CDLL."""
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / "barrier_probe.cu").write_text(BARRIER_PROBE)
    jobs = [(_build.CSRC / s, WORK / (Path(s).stem + ".o")) for s in SOURCES]
    jobs.append((WORK / "barrier_probe.cu", WORK / "barrier_probe.o"))
    procs = [(src, obj, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         str(_build.CSRC), "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for src, obj in jobs]
    for src, _, proc in procs:
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{err[-6000:]}")
        lines = (out + err).splitlines()
        for k, ln in enumerate(lines):
            if "Compiling entry" in ln:
                kern = ln.split("'")[1]
                info = " | ".join(
                    x.split(":")[-1].strip() for x in lines[k + 1:k + 5]
                    if "registers" in x or "spill" in x)
                print(f"ptxas {src.name}: {demangle(kern)} | {info}",
                      flush=True)
    so = WORK / "kernels.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), *(str(obj) for _, obj, _ in procs[:-1])],
                   check=True)
    probe_so = WORK / "barrier_probe.so"
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
    probe.probe_barrier.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p]
    probe.probe_barrier.restype = ctypes.c_int
    return probe


def build_variants():
    """Each entry of VARIANTS as its own library; {name: CDLL}."""
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = WORK / f"variant{i}"
        d.mkdir(parents=True, exist_ok=True)
        texts = {f: (_build.CSRC / f).read_text()
                 for f in ("local_cg.cu", "dense_cluster.cuh")}
        for f, old, new in edits:
            if old not in texts[f]:
                raise RuntimeError(f"{f} changed: {old[:50]!r}")
            texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            (d / f).write_text(text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-shared", "-o", str(d / "lib.so"),
             str(d / "local_cg.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-6000:]}")
        lines = (out + err).splitlines()
        for k, ln in enumerate(lines):
            if "Compiling entry" in ln and "cluster" in ln:
                info = " | ".join(
                    x.split(":")[-1].strip() for x in lines[k + 1:k + 5]
                    if "registers" in x or "spill" in x)
                print(f"ptxas variant {name}: {info}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.ttnx_bicgstab_cluster_f32.argtypes = \
            _build._SIGNATURES["bicgstab_cluster"][0]
        lib.ttnx_bicgstab_cluster_f32.restype = ctypes.c_int
        libs[name] = lib
    return libs


def variant_run(lib, K, rhs, iters):
    def run():
        out = torch.empty_like(rhs)
        err = lib.ttnx_bicgstab_cluster_f32(
            K.data_ptr(), rhs.data_ptr(), out.data_ptr(), K.shape[0], iters,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"variant: CUDA error {err}")
        return out
    return run


def variants(sites):
    from ttnx_torch.kernels.local_cg import bicgstab_solve_plain

    it = chip_smoke.BICG_ITERS
    K, rhs = sites[chip_smoke.CONV_SITE]
    runs = {"base": lambda: b10("bicgstab_cluster", K, rhs)(it)}
    runs.update({name: variant_run(lib, K, rhs, it)
                 for name, lib in build_variants().items()})
    ref = bicgstab_solve_plain(K, rhs, iters=it)
    for name, run in runs.items():
        got = run()
        err = float((got - ref).abs().max() / ref.abs().max())
        gate = "measurement only" not in name
        print(f"check variant {name}: max rel err against plain {err:.3e}"
              f"{' (<= 1e-4)' if gate else ''}", flush=True)
        if gate and not err <= 1e-4:
            raise RuntimeError(f"variant {name} is wrong")
    for name in list(runs) + list(runs)[::-1]:
        print(f"time variant {name}: {cuda_ms(runs[name], 10):.4f} ms",
              flush=True)


def demangle(name):
    filt = subprocess.run(["c++filt", name], capture_output=True, text=True)
    return (filt.stdout.strip() or name)[:90]


def cuda_ms(fn, reps=1) -> float:
    return chip_smoke.cuda_ms(fn, reps, 3)


def b12(entry, x, w):
    def run(iters):
        out = torch.empty_like(x)
        B, m, k = x.shape
        _build.call(entry, x.dtype, x.data_ptr(), w.data_ptr(),
                    out.data_ptr(), B, m, k, iters)
        return out
    return run


def b10(entry, K, rhs):
    def run(iters):
        out = torch.empty_like(rhs)
        _build.call(entry, K.dtype, K.data_ptr(), rhs.data_ptr(),
                    out.data_ptr(), K.shape[0], iters)
        return out
    return run


def split(label, run, its, reps):
    t = {it: cuda_ms(lambda: run(it), reps) for it in its}
    per_it = (t[its[-1]] - t[its[-2]]) / (its[-1] - its[-2])
    print(f"split {label}: iters {' / '.join(map(str, its))}: "
          f"{' / '.join(f'{v:.4f}' for v in t.values())} ms; "
          f"{per_it * 1e3:.4f} us an iteration, fixed {t[0]:.4f} ms",
          flush=True)


def barrier_cost(probe):
    sink = torch.zeros(8, device="cuda")
    for mode, label in ((0, "barrier alone"),
                        (1, "barrier + 256 B st.shared::cluster a CTA"),
                        (2, "cg map_shared_rank store + cluster.sync()")):
        def run(rounds, mode=mode):
            err = probe.probe_barrier(rounds, mode, sink.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"barrier probe: CUDA error {err}")
        t = {n: cuda_ms(lambda n=n: run(n), 5) for n in (0, 1000, 10000)}
        per = (t[10000] - t[1000]) / 9000
        print(f"cluster of 8, {label}: rounds 0 / 1000 / 10000: "
              f"{t[0]:.4f} / {t[1000]:.4f} / {t[10000]:.4f} ms; "
              f"{per * 1e6:.1f} ns a round", flush=True)


def chain_inputs(dev):
    from ttnx_torch.entry import (matmul_ceiling_problem,
                                  norm_keeping_matmul_problem)

    return matmul_ceiling_problem(dev), norm_keeping_matmul_problem(dev)


def conv_inputs(dev):
    """The 22 (K, rhs) of one convection CN step, f32, as chip_smoke.py
    records them."""
    step_fn, us, _, _ = chip_smoke.conv_setup(dev)
    seen = chip_smoke.record_calls(lambda: step_fn(us))
    calls = seen["bicgstab_solve_fused"]
    assert all(kw["iters"] == chip_smoke.BICG_ITERS for _, kw in calls)
    return [tuple(t.contiguous() for t in args) for args, _ in calls]


def check_b12(q, nk):
    from ttnx_torch.kernels.contraction import matmul_chain_plain

    short = chip_smoke.SHORT_ITERS
    new, old = b12("matmul_chain_wgmma", q["x"], q["w"]), \
        b12("matmul_chain", q["x"], q["w"])
    got, ref = new(short).float(), matmul_chain_plain(
        q["x"], q["w"], short).float()
    prev = old(short).float()
    err = float((got - ref).abs().max() / ref.abs().max())
    print(f"check B12 wgmma bench input iters {short}: max rel err "
          f"{err:.3e} (<= {short * BF16_ULP:.3e}); elements differing from "
          f"the wmma kernel {int((got != prev).sum())} of {got.numel()}, "
          f"from "
          f"plain {int((got != ref).sum())}", flush=True)
    if not err <= short * BF16_ULP:
        raise RuntimeError("B12 wgmma is wrong on the bench input")
    it = chip_smoke.CEIL_ITERS
    got = b12("matmul_chain_wgmma", nk["x"], nk["w"])(it).float()
    ref = matmul_chain_plain(nk["x"], nk["w"], it).float()
    x = nk["x"].float()
    rel = float((got - ref).norm() / ref.norm())
    ratio = float(got.norm() / x.norm())
    print(f"check B12 wgmma norm-keeping iters {it}: rel Frobenius "
          f"{rel:.3e} (<= 1e-3), |out| / |x| {ratio:.7f} (within 1 %), "
          f"plain |out| / |x| {float(ref.norm() / x.norm()):.7f}",
          flush=True)
    if not (rel <= 1e-3 and abs(ratio - 1) <= 1e-2):
        raise RuntimeError("B12 wgmma fails the norm-keeping check")


def check_b10(sites):
    from ttnx_torch.kernels.local_cg import bicgstab_solve_plain

    it = chip_smoke.BICG_ITERS
    for i, (K, rhs) in enumerate(sites):
        got = b10("bicgstab_cluster", K, rhs)(it)
        again = b10("bicgstab_cluster", K, rhs)(it)
        ref = bicgstab_solve_plain(K, rhs, iters=it)
        old = b10("bicgstab", K, rhs)(it)
        err = float((got - ref).abs().max() / ref.abs().max())
        err_old = float((old - ref).abs().max() / ref.abs().max())
        gate = i == chip_smoke.CONV_SITE
        print(f"check B10 cluster site {i}: max rel err against plain "
              f"{err:.3e}{' (<= 1e-4)' if gate else ''}, the l2 kernel "
              f"{err_old:.3e}; two launches bit-identical "
              f"{torch.equal(got, again)}", flush=True)
        if gate and not (err <= 1e-4 and torch.equal(got, again)):
            raise RuntimeError("B10 cluster is wrong at CONV_SITE")


def time_pair(label, new, old, reps):
    for name, run in (("new", new), ("old", old), ("old", old),
                      ("new", new)):
        print(f"time {label} {name}: {cuda_ms(run, reps):.4f} ms",
              flush=True)


def paths(dev):
    from ttnx_torch.kernels import local_cg

    chosen = local_cg.bicgstab_route
    step_fn, us, _, _ = chip_smoke.conv_setup(dev)
    try:
        for route in ("cluster", "l2", "l2", "cluster"):
            local_cg.bicgstab_route = chosen if route == "cluster" else (
                lambda *shape: "l2")
            ms = chip_smoke.timed_chain(step_fn, us)[0]
            assert local_cg.bicgstab_solve_fused.route == route
            print(f"path convection cn_step d={chip_smoke.D} "
                  f"r{chip_smoke.CONV_RMAX} ms/step B10 route {route}: "
                  f"{ms:.3f}", flush=True)
    finally:
        local_cg.bicgstab_route = chosen


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--step0", action="store_true",
                    help="the old routes' splits, the cluster barrier, "
                         "checks of the new kernels")
    ap.add_argument("--paths", action="store_true",
                    help="only the convection step by B10 route")
    ap.add_argument("--no-paths", action="store_true")
    ap.add_argument("--variants", action="store_true",
                    help="only B10's cluster kernel against VARIANTS")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    probe = compile_all()
    if opt.paths:
        paths(dev)
        return 0
    if opt.variants:
        variants(conv_inputs(dev))
        return 0
    q, nk = chain_inputs(dev)
    sites = conv_inputs(dev)
    K, rhs = sites[chip_smoke.CONV_SITE]
    check_b12(q, nk)
    check_b10(sites)
    if opt.step0:
        split("B12 wmma bench", b12("matmul_chain", q["x"], q["w"]),
              (0, 8, 64, 1024), 1)
        split("B10 l2 CONV_SITE", b10("bicgstab", K, rhs),
              (0, 16, 32), 10)
        barrier_cost(probe)
        return 0
    it12, it10 = chip_smoke.CEIL_ITERS, chip_smoke.BICG_ITERS
    time_pair("B12 bench iters 1024",
              lambda: b12("matmul_chain_wgmma", q["x"], q["w"])(it12),
              lambda: b12("matmul_chain", q["x"], q["w"])(it12), 1)
    split("B12 wgmma bench", b12("matmul_chain_wgmma", q["x"], q["w"]),
          (0, 8, 64, 1024), 1)
    time_pair("B10 CONV_SITE iters 32",
              lambda: b10("bicgstab_cluster", K, rhs)(it10),
              lambda: b10("bicgstab", K, rhs)(it10), 10)
    split("B10 cluster CONV_SITE", b10("bicgstab_cluster", K, rhs),
          (0, 16, 32), 10)
    for entry in ("bicgstab_cluster", "bicgstab", "bicgstab",
                  "bicgstab_cluster"):
        per = [cuda_ms(lambda a=a: b10(entry, *a)(it10), 10) for a in sites]
        print(f"time B10 {entry} over the 22 local solves of a step: "
              f"{sum(per):.4f} ms (min {min(per):.4f}, max {max(per):.4f} "
              f"a launch)", flush=True)
    if not opt.no_paths:
        paths(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
