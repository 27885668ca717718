"""Build and load the Hopper kernels.

All sources under ``ttnx_torch/csrc`` compile, at first use, into one shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/ttnx_torch/libttnx_torch_<hash>.so csrc/*.cu

The file name carries a hash of the sources and flags, so an edited kernel
never loads a stale library. The library is loaded with ``ctypes``; every
entry point takes ``c_void_p`` for pointers and the stream, ``c_int`` for
sizes, and returns ``cudaGetLastError()`` after its launches.
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

__all__ = ["lib", "build", "call", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ttnx_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

P, I = ctypes.c_void_p, ctypes.c_int
# entry point -> argument types (the stream is always the last pointer)
_SIGNATURES = {
    # y, out, scratch, d, R, n, stream
    "gram_chain": [P, P, P, I, I, I, P],
    # x, A, b, envs, envs_b, scratch, d, R, RA, n, Rb, stream
    "env_chain_right": [P, P, P, P, P, P, I, I, I, I, I, P],
    "env_chain_left": [P, P, P, P, P, P, I, I, I, I, I, P],
    # K, rhs, x0, out, M, iters, warm, stream
    "cg_solve": [P, P, P, P, I, I, I, P],
    # L, Ac, Renv, rhs, mask, x0, out, scratch, R, RA, n, iters, warm, stream
    "cg_matfree": [P, P, P, P, P, P, P, P, I, I, I, I, I, P],
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
    cus = [str(s) for s in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cus]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-8000:]}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def lib():
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(handle, f"ttnx_{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def call(name: str, dtype, *args) -> None:
    """Launch entry point ``ttnx_<name>_<f32|f64>`` on the current stream
    and raise if CUDA reported an error."""
    import torch

    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib(), f"ttnx_{name}_{suffix}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"ttnx_{name}_{suffix}: CUDA error {err}")
