"""The batched gauge QR's kernel (``ttnx_torch/csrc/qr_batched.cu``) on the
CPU, through the thread emulation of a CUDA block in ``tests/cuda_emu``
(one thread per CUDA thread, 256 a block, barriers for ``__syncthreads``
and for the warp shuffles, each block's dynamic shared memory starting as
NaN bytes), held against ``torch.linalg.qr``, the kernel's plain version.

Both layouts (``rows`` 0: a ``(B, m, k)`` stack, 1: the ``(B, k, m)``
stack of the transposes) on stacks with the zero rows and columns that
the rank masks leave (a chain-end site, three dead rows and columns) and
a rank-deficient one, with the 16-byte copies; a ragged 37 x 20 stack with
the element-wise copies. The shapes are small, since an emulated barrier
is slow, but reach what the batched ALS's do: 100 rows fill all four rows
a lane holds, 16 columns give a warp two trailing columns a step. This
checks the kernel's index arithmetic, its two layouts, the LAPACK
conventions on zero columns and the barriers without a card; the card
tests (``test_torch_qr_batched.py``) check it at the ALS's shapes and
that it compiled. Needs g++ with C++20 (``<barrier>``) and skips without
it.

Tolerances, relative to the largest entry: the factors 1e-5 in f32 (f32
FMAs summed in another order than LAPACK's blocked routines, on matrices
of condition about 10) and 1e-12 in f64; where a live block is rank
deficient only ``Q R = V`` and the live columns' orthonormality are held
(1e-5), since Q's columns past the rank are set by rounding.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
CSRC = ROOT / "ttnx_torch" / "csrc"
SMEM = "extern __shared__ __align__(16) unsigned char qr_smem[];"


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the CUDA kernel's emulation")
    work = tmp_path_factory.mktemp("qr_emu")
    src = (CSRC / "qr_batched.cu").read_text()
    assert src.count(SMEM) == 1
    src = src.replace(SMEM, "#define qr_smem (emu_dynamic_smem())")
    src, launches = re.subn(r"<<<[^>]*>>>", "", src)
    assert launches == 1
    (work / "qr.cpp").write_text(src)
    exe = work / "emulate_qr"
    done = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-I", str(EMU), "-I", str(CSRC),
         f'-DQR_SOURCE="{work / "qr.cpp"}"', str(EMU / "emulate_qr.cpp"),
         "-o", str(exe), "-lpthread"], capture_output=True, text=True)
    if done.returncode and "barrier" in done.stderr and "No such file" in \
            done.stderr:
        pytest.skip("g++ has no C++20 <barrier>")
    assert done.returncode == 0, done.stderr[-3000:]
    return exe, work


def _run(emulator, tag, V, rows, vec):
    exe, work = emulator
    d = work / tag
    d.mkdir(exist_ok=True)
    V = np.ascontiguousarray(V)
    V.tofile(d / "V.bin")
    B = V.shape[0]
    k, m = V.shape[1:] if rows else V.shape[:0:-1]
    done = subprocess.run(
        [str(exe), str(d), "f64" if V.dtype == np.float64 else "f32",
         str(B), str(m), str(k), str(int(rows)), str(vec)],
        capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    q = np.fromfile(d / "Q.bin", dtype=V.dtype).reshape(V.shape)
    r = np.fromfile(d / "R.bin", dtype=V.dtype).reshape(B, k, k)
    return q, r


def _stack(rng, m, k, dtype):
    """Three (m, k) matrices: Gaussian plus 3 I; a chain-end site (the two
    first rows and one column live, the rest exactly zero); three dead
    rows and columns. Condition about 10 where live."""
    A = rng.standard_normal((3, m, k)) + 3.0 * np.eye(m, k)
    A[1, 2:] = 0.0
    A[1, :, 1:] = 0.0
    A[2, m - 3:] = 0.0
    A[2, :, k - 3:] = 0.0
    return A.astype(dtype)


def _reference(V, rows):
    q, r = torch.linalg.qr(torch.as_tensor(V).transpose(1, 2) if rows
                           else torch.as_tensor(V))
    if rows:
        q, r = q.transpose(1, 2), r.transpose(1, 2)
    return q.numpy(), r.numpy()


def _close(got, ref, tol):
    err = float(np.abs(got - ref).max())
    assert err <= tol * float(np.abs(ref).max()), err


@pytest.mark.parametrize("m,k,dtype,rows,vec", [
    (100, 16, np.float32, 0, 1), (100, 16, np.float32, 1, 1),
    (66, 10, np.float64, 1, 1), (37, 20, np.float32, 0, 0)],
    ids=["f32-cols", "f32-rows", "f64-rows", "ragged-scalar"])
def test_qr_kernel_emulated(emulator, m, k, dtype, rows, vec):
    rng = np.random.default_rng(m + k + rows)
    A = _stack(rng, m, k, dtype)
    V = A.transpose(0, 2, 1) if rows else A
    q, r = _run(emulator, f"{m}_{k}_{rows}_{vec}_{dtype.__name__}", V, rows,
                vec)
    q0, r0 = _reference(V, rows)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    _close(q, q0, tol)
    _close(r, r0, tol)


def test_qr_kernel_emulated_rank_deficient(emulator):
    """A live block of rank 3 in a 48 x 16 matrix (both layouts):
    ``Q R = V``, ``R`` upper triangular with its diagonal past the rank at
    rounding level, the columns of Q orthonormal."""
    rng = np.random.default_rng(9)
    A = (rng.standard_normal((1, 48, 3)) @ rng.standard_normal((1, 3, 16))
         ).astype(np.float32)
    for rows in (0, 1):
        V = A.transpose(0, 2, 1) if rows else A
        q, r = _run(emulator, f"low_{rows}", V, rows, 1)
        if rows:
            q, r = q.transpose(0, 2, 1), r.transpose(0, 2, 1)
        q, r = q.astype(np.float64), r.astype(np.float64)
        scale = np.abs(A).max()
        assert np.abs(q @ r - A).max() <= 1e-5 * scale
        assert not np.tril(r[0], -1).any()
        assert np.abs(np.diag(r[0])[3:]).max() <= 1e-5 * scale
        assert np.abs(q[0].T @ q[0] - np.eye(16)).max() <= 1e-5
