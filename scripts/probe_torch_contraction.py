"""Design probe of the port's contraction kernels B11 and B13 on one card.

    python3 scripts/probe_torch_contraction.py

Builds ``ttnx_torch/csrc/contraction.cu`` alone and a few variants of it
(text edits of the source, one shared library each, ``nvcc -Xptxas -v``
printing the merge kernels' registers and spills), holds each B13 variant
against ``torch.bmm`` in float32 on the bench inputs, and times, in the
same process on the same card, interleaved over three rounds (CUDA events,
median of 5 x 20 calls):

* B13 at the bench shape (4096 x (128 x 64) @ (64 x 128), bf16 in, f32
  out): the shipped kernel (one block a problem, evict-first ``cp.async``
  loads, staged whole-row stores); the same with plain ``cp.async``; the
  same with direct 16-byte stores from registers (lanes swap halves, no
  staging); a persistent grid (blocks resident on every SM walking the
  problems) with 2 and 3 ``cp.async`` stages; and ``torch.bmm(a, b,
  out_dtype=float32)``.
* B11 at the bench shape and 2048 iterations: the ``wgmma`` route and the
  ``wmma`` kernel of PR 4 (the route larger shapes still take).

Needs a CUDA card with nvcc (sm_90a); imports torch and ttnx_torch only.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ttnx_torch.entry import contraction_problem  # noqa: E402
from ttnx_torch.kernels import _build  # noqa: E402

WORK = Path(__file__).resolve().parents[1] / "build" / "probe_contraction"

EVICT_FIRST = """      "{\\n"
      ".reg .b64 pol;\\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\\n"
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, pol;\\n"
      "}\\n" ::"r"(s),"""
PLAIN_LOAD = """      "cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s),"""
STAGED_START = "    // the 16 x 64 tile through the warp's staging rows"
STAGED_END = "    __syncwarp();\n  }\n}\n"
DIRECT = """    // lanes t, t ^ 1 swap halves: even t take row g, columns 8j + 2t ..
    // 2t + 3; odd t row g + 8, columns 8j + 2t - 2 .. 2t + 1
    const bool odd = t & 1;
    const int row = r0 + g + (odd ? 8 : 0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x0 = odd ? acc[j][0] : acc[j][2];
      const float x1 = odd ? acc[j][1] : acc[j][3];
      const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1);
      const float y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
      const float4 v = odd ? make_float4(y0, y1, acc[j][2], acc[j][3])
                           : make_float4(acc[j][0], acc[j][1], y0, y1);
      const int col = c0 + 8 * j + 4 * (t >> 1);
      if (row < m && col + 3 < n)
        *reinterpret_cast<float4*>(o + (size_t)row * n + col) = v;
    }
  }
}
"""
PERSISTENT = """
// Persistent blocks walking the problems with NS cp.async stages (NS - 1
// problems prefetched); the tile and epilogue of merge_mma_kernel. Shapes
// with k, n multiples of 16 only.
template <int NS>
__global__ void __launch_bounds__(kMergeThreads)
    merge_persistent_kernel(const bf16* a, const bf16* b, float* out, int B,
                            int m, int k, int n) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int mp = up16(m), kp = up16(k), np = up16(n);
  const int lda = kp + 8, ldb = np + 8;
  const size_t stage = (size_t)mp * lda + (size_t)kp * ldb;
  bf16* st0 = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* stg = reinterpret_cast<float*>(st0 + NS * stage) +
               warp * 16 * kStageLd;
  auto issue = [&](int s, size_t p) {
    bf16* As = st0 + s * stage;
    bf16* Bs = As + (size_t)mp * lda;
    const bf16* ag = a + p * m * k;
    const bf16* bg = b + p * k * n;
    const int va = k / 8, vb = n / 8;
    for (int q = tid; q < m * va; q += kMergeThreads)
      cp_async16_evict_first(smem_u32(As + (q / va) * lda + (q % va) * 8),
                             ag + (size_t)q * 8);
    for (int q = tid; q < k * vb; q += kMergeThreads)
      cp_async16_evict_first(smem_u32(Bs + (q / vb) * ldb + (q % vb) * 8),
                             bg + (size_t)q * 8);
    cp_async_commit();
  };
  size_t p = blockIdx.x;
  for (int i = 0; i < NS - 1; ++i) {
    const size_t q = p + (size_t)i * gridDim.x;
    if (q < (size_t)B)
      issue(i, q);
    else
      cp_async_commit();
  }
  for (int s = 0; p < (size_t)B; p += gridDim.x, s = (s + 1) % NS) {
    const size_t ahead = p + (size_t)(NS - 1) * gridDim.x;
    if (ahead < (size_t)B)
      issue((s + NS - 1) % NS, ahead);
    else
      cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();
    const bf16* As = st0 + s * stage;
    const bf16* Bs = As + (size_t)mp * lda;
    float* o = out + p * m * n;
TILES
    __syncthreads();
  }
}

"""
HOST = """  return launch(merge_mma_kernel, merge_mma_smem(m, k, n), B, s, a, b, out,
                m, k, n);"""
PERSISTENT_HOST = """  constexpr int NS = STAGES;
  auto kernel = merge_persistent_kernel<NS>;
  const size_t smem = merge_mma_smem(m, k, n) +
      (NS - 1) * ((size_t)up16(m) * (up16(k) + 8) +
                  (size_t)up16(k) * (up16(n) + 8)) * sizeof(bf16);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kMergeThreads, smem);
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  kernel<<<(int)(B < resident ? B : resident), kMergeThreads, smem, s>>>(
      a, b, out, B, m, k, n);
  return (int)cudaGetLastError();"""


def variants(src: str) -> dict[str, str]:
    """Variant name -> contraction.cu text."""
    for needle in (EVICT_FIRST, STAGED_START, HOST, "// Launch helper"):
        if needle not in src:
            raise RuntimeError(f"contraction.cu changed: {needle[:40]!r}")
    i0 = src.index(STAGED_START)
    i1 = src.index(STAGED_END, i0)
    direct = src[:i0] + DIRECT + src[i1 + len(STAGED_END):]
    t0 = src.index("  const bool vec_out", src.index("merge_mma_kernel("))
    tiles = src[t0:i1 + len("    __syncwarp();\n  }\n")]
    helper = src.index("// Launch helper")
    persistent = (src[:helper] + PERSISTENT.replace("TILES", tiles)
                  + src[helper:])
    out = {"mma (shipped)": src,
           "mma, plain cp.async": src.replace(EVICT_FIRST, PLAIN_LOAD),
           "mma, direct stores": direct}
    for ns in (2, 3):
        out[f"persistent, {ns} stages"] = persistent.replace(
            HOST, PERSISTENT_HOST.replace("STAGES", str(ns)))
    return out


def build(texts: dict[str, str]) -> dict[str, ctypes.CDLL]:
    WORK.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = WORK / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = (WORK / f"v{i}.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-shared", "-o", str(WORK / f"v{i}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-3000:]}")
        lines = (out + err).splitlines()
        for k, ln in enumerate(lines):
            if "Compiling entry" in ln and "merge_" in ln and (
                    "mma_kernel" in ln or "persistent" in ln
                    or "chain_wgmma" in ln):
                kern = ln.split("'")[1]
                print(f"{name}: {kern[:48]} | {lines[k + 1].strip()} | "
                      f"{lines[k + 2].strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def cuda_ms(fn, reps=20, repeats=5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(variants((_build.CSRC / "contraction.cu").read_text()))
    dev = torch.device("cuda", 0)
    p = contraction_problem(dev)
    a, b, w = p["a"], p["b"], p["w"]
    B, m, k = a.shape
    n = b.shape[2]
    out = torch.empty((B, m, n), device=dev)
    ref = torch.bmm(a.float(), b.float())
    P, I = ctypes.c_void_p, ctypes.c_int
    merges = {}
    for name, lib in libs.items():
        fn = lib.ttnx_two_site_merge_mma_bf16
        fn.argtypes, fn.restype = [P, P, P, I, I, I, I, P], ctypes.c_int

        def call(fn=fn):
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, m, k, n,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        out.fill_(float("nan"))
        call()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max() / ref.abs().max())
        print(f"B13 {name}: max rel err against f32 bmm {err:.3e}",
              flush=True)
        if not err <= 1e-5:
            raise RuntimeError(f"B13 {name} is wrong")
        merges[name] = call
    bmm = ("torch.bmm(a, b, out_dtype=float32)",
           lambda: torch.bmm(a, b, out_dtype=torch.float32))
    for rnd in range(3):
        for name, fn in [bmm, *merges.items()]:
            print(f"round {rnd} B13 {name}: {cuda_ms(fn):.4f} ms",
                  flush=True)
    lib = libs["mma (shipped)"]
    acc = torch.empty_like(a)
    chains = {}
    for route in ("wgmma", "wmma"):
        fn = getattr(lib, "ttnx_merge_resplit_chain_wgmma_bf16"
                     if route == "wgmma" else
                     "ttnx_merge_resplit_chain_bf16")
        fn.argtypes, fn.restype = [P, P, P, P, I, I, I, I, I, P], ctypes.c_int
        chains[route] = lambda fn=fn: fn(
            a.data_ptr(), b.data_ptr(), w.data_ptr(), acc.data_ptr(), B, m, k,
            n, 2048, torch.cuda.current_stream().cuda_stream)
    for route in ("wgmma", "wmma", "wgmma"):
        print(f"B11 {route} route, 2048 iterations: "
              f"{cuda_ms(chains[route], reps=1, repeats=3):.3f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
