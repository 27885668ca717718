"""Build and load the Hopper kernels.

All sources under ``ttnx_torch/csrc`` compile, at first use, into one shared
library with a plain C interface: one ``nvcc -c`` per source, all started
together, then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c csrc/<name>.cu -o <name>.o      (each source)
    nvcc <the same flags> -shared *.o \\
         -o build/ttnx_torch/libttnx_torch_<hash>.so

The file name carries a hash of the sources and flags, so an edited kernel
never loads a stale library. The library is loaded with ``ctypes``; every
entry point takes ``c_void_p`` for pointers and the stream, ``c_int`` for
sizes (``c_longlong`` for an element stride), and returns ``cudaGetLastError()`` after its launches. Each entry
point exists for the dtype suffixes its signature lists: ``f32`` and
``f64`` for the linear-algebra kernels, ``f32`` alone for the
site-resident routes of B7, B4/B5 and B6, the cluster routes of B2,
B3, B8, B9 and B10 and the grid route of B1,
``bf16`` and ``f32`` for the contraction kernels, ``bf16`` alone for
their tensor-core routes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["lib", "build", "call", "query", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ttnx_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
REAL = ("f32", "f64")   # the linear-algebra kernels: IEEE f32 and f64
MM = ("bf16", "f32")    # the contraction kernels: the TPU kernels' types
# entry point -> (argument types, dtype suffixes); the stream is always the
# last pointer
_SIGNATURES = {
    # y, out, scratch, d, R, n, stream
    "gram_chain": ([P, P, P, I, I, I, P], REAL),
    # the same; R = 64, 128 or 256, n = 2
    "gram_chain_grid": ([P, P, P, I, I, I, P], ("f32",)),
    # x, A, b, envs, envs_b, scratch, d, R, RA, n, Rb, stream
    "env_chain_right": ([P, P, P, P, P, P, I, I, I, I, I, P], REAL),
    "env_chain_left": ([P, P, P, P, P, P, I, I, I, I, I, P], REAL),
    # x, A, envs, scratch, d, R, RA, n, stream
    "env_chain_A_right": ([P, P, P, P, I, I, I, I, P], REAL),
    "env_chain_A_left": ([P, P, P, P, I, I, I, I, P], REAL),
    # x, A, envs, d, R, RA, n, left, stream; R = 64, 32 or 16, n = 2, RA = 5
    "env_chain_A_cluster": ([P, P, P, I, I, I, I, I, P], ("f32",)),
    # K, v0, Q, alphas, betas, M, iters, stream
    "lanczos": ([P, P, P, P, P, I, I, P], REAL),
    "lanczos_cluster": ([P, P, P, P, P, I, I, P], ("f32",)),
    # K, rhs, x0, out, M, iters, warm, stream
    "cg_solve": ([P, P, P, P, I, I, I, P], REAL),
    "cg_solve_cluster": ([P, P, P, P, I, I, I, P], ("f32",)),
    # K, rhs, out, M, iters, stream
    "bicgstab": ([P, P, P, I, I, P], REAL),
    "bicgstab_cluster": ([P, P, P, I, I, P], ("f32",)),
    # L, Ac, Renv, rhs, mask, x0, out, scratch, R, RA, n, iters, warm, stream
    "cg_matfree": ([P, P, P, P, P, P, P, P, I, I, I, I, I, P], REAL),
    # the same with B first among the sizes
    "cg_matfree_batched": ([P, P, P, P, P, P, P, P, I, I, I, I, I, I, P],
                           REAL),
    # the same arguments; (R, n, RA) = (64, 2, 4) or (32, 2, 4)
    "cg_matfree_site": ([P, P, P, P, P, P, P, P, I, I, I, I, I, I, P],
                        ("f32",)),
    # x, A, b, envs, envs_b, scratch, B, d, R, RA, n, Rb, left, raw, stream
    "env_chain_batched": ([P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
                          REAL),
    # x, A, b, envs, envs_b, b_stride, B, d, R, RA, n, Rb, left, raw,
    # stream; R = 64 or 32, n = 2, RA = 4, Rb = R
    "env_chain_resident": ([P, P, P, P, P, LL, I, I, I, I, I, I, I, I, P],
                           ("f32",)),
    # x, A, b, envs, envs_b, d, R, RA, n, Rb, left, raw, stream
    "env_chain_cluster": ([P, P, P, P, P, I, I, I, I, I, I, I, P],
                          ("f32",)),
    # A, b, x, masks, out, scratch, B, d, R, RA, n, cg_iters, cg_refine,
    # cg_polish, ns1, ns2, stream
    "als_sweep_pair": ([P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P],
                       REAL),
    # the same arguments; (R, n, RA) = (64, 2, 4) or (32, 2, 4), cg_refine 0
    "als_sweep_site": ([P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P],
                       ("f32",)),
    # a, b, out, B, m, k, n, stream
    "two_site_merge": ([P, P, P, I, I, I, I, P], MM),
    "two_site_merge_mma": ([P, P, P, I, I, I, I, P], ("bf16",)),
    # x, w, out, B, m, k, iters, stream
    "matmul_chain": ([P, P, P, I, I, I, I, P], MM),
    "matmul_chain_wgmma": ([P, P, P, I, I, I, I, P], ("bf16",)),
    # a, b, w, out, B, m, r, n, iters, stream
    "merge_resplit_chain": ([P, P, P, P, I, I, I, I, I, P], MM),
    "merge_resplit_chain_wgmma": ([P, P, P, P, I, I, I, I, I, P],
                                  ("bf16",)),
}
# size queries (no stream, no dtype suffix) -> argument types; return
# c_longlong
_QUERIES = {
    # d, R, RA, n -> scratch elements per problem of als_sweep_pair
    "als_sweep_pair_scratch": [I, I, I, I],
    "als_sweep_site_scratch": [I, I, I, I],
    # R, S, RA, rhs -> shared-memory bytes of the env site kernels' block
    "env_site_smem": [I, I, I, I],
}

_LIB = None
BUILD_SECONDS = None  # nvcc wall time of this process's build, if any


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the ttnx_torch CUDA kernels are "
                       "built at first use and need the CUDA toolkit")


def build() -> Path:
    """Compile the kernels (if the hashed library is missing) and return
    its path."""
    global BUILD_SECONDS
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libttnx_torch_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs, procs = [], []
        for cu in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(work, cu.stem + ".o")
            objs.append(obj)
            procs.append((cu.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(cu), "-o",
                 obj], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for name, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{err[-4000:]}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr[-8000:]}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half
    BUILD_SECONDS = time.perf_counter() - t0
    return so


def lib():
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, (argtypes, suffixes) in _SIGNATURES.items():
            for suffix in suffixes:
                fn = getattr(handle, f"ttnx_{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        for name, argtypes in _QUERIES.items():
            fn = getattr(handle, f"ttnx_{name}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong
        _LIB = handle
    return _LIB


def query(name: str, *args) -> int:
    """Call the size query ``ttnx_<name>`` of the library."""
    return int(getattr(lib(), f"ttnx_{name}")(*args))


def call(name: str, dtype, *args) -> None:
    """Launch entry point ``ttnx_<name>_<f32|f64|bf16>`` on the current
    stream and raise if CUDA reported an error."""
    import torch

    suffix = {torch.float32: "f32", torch.float64: "f64",
              torch.bfloat16: "bf16"}.get(dtype)
    if suffix not in _SIGNATURES[name][1]:
        raise TypeError(f"ttnx_{name} has no {dtype} entry point")
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib(), f"ttnx_{name}_{suffix}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"ttnx_{name}_{suffix}: CUDA error {err}")
