"""The resident route of kernels B4/B5 (``ttnx_torch/csrc/local_cg_site.cu``)
on the CPU, through the thread emulation of a CUDA block in
``tests/cuda_emu`` (one thread per CUDA thread, 512 a block, barriers for
``__syncthreads`` and for the warp shuffles), held against the plain
version ``cg_matfree_batched_plain`` — which ``test_torch_kernels.py``
holds against ttnx's kernel. This checks the kernel's index arithmetic,
shared-memory layouts, mask handling and reductions without a card; the
card tests (``test_torch_cuda.py``) check it compiled.

The masks: the outer product of two rank masks (what the ALS solvers
build), a scattered 0/1 mask that is no outer product, and fractional
values (the kernel applies the mask where the plain version does, so the
formula holds for any mask). Needs g++ with C++20 (``<barrier>``) and
skips without it. Tolerance 1e-4 relative to the largest entry, as on the
card: f32 CG carries the rounding of products summed in another order.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ttnx_torch.kernels.local_cg_mf import cg_matfree_batched_plain

ROOT = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
CSRC = ROOT / "ttnx_torch" / "csrc"
LAUNCH = "<<<B, kThreads, smem, st>>>"
RA, N = 4, 2


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the CUDA kernel's emulation")
    work = tmp_path_factory.mktemp("matfree_emu")
    src = (CSRC / "local_cg_site.cu").read_text()
    assert src.count(LAUNCH) == 1
    (work / "matfree.cpp").write_text(src.replace(LAUNCH, ""))
    exe = work / "emulate_matfree"
    done = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-I", str(EMU), "-I", str(CSRC),
         f'-DMATFREE_SOURCE="{work / "matfree.cpp"}"',
         str(EMU / "emulate_matfree.cpp"), "-o", str(exe), "-lpthread"],
        capture_output=True, text=True)
    if done.returncode and "barrier" in done.stderr and "No such file" in \
            done.stderr:
        pytest.skip("g++ has no C++20 <barrier>")
    assert done.returncode == 0, done.stderr[-3000:]
    return exe, work


def _env(rng, R):
    """An SPD (R, RA, R) environment: L[:, w] and Renv[:, w] symmetric."""
    e = np.zeros((R, RA, R))
    for w in range(RA):
        g = rng.standard_normal((R, R)) / np.sqrt(R)
        e[:, w] = g @ g.T + (np.eye(R) if w == 0 else 0.0)
    return e


def _mask(rng, R, kind):
    if kind == "outer":
        m_l = (np.arange(R) < R - 3).astype(float)
        m_r = (np.arange(R) < R - 5).astype(float)
        return m_l[:, None, None] * np.ones(N)[None, :, None] * m_r
    if kind == "scattered":
        return (rng.random((R, N, R)) < 0.8).astype(float)
    return rng.random((R, N, R))


@pytest.mark.parametrize("R,B,warm,kind", [
    (32, 1, False, "outer"), (32, 1, True, "scattered"),
    (32, 2, True, "outer"), (32, 2, False, "scattered"),
    (64, 1, True, "outer"), (64, 1, False, "scattered"),
    (64, 2, False, "outer"), (64, 2, True, "scattered"),
    (32, 2, True, "fractional")])
def test_resident_kernel_emulated_matches_plain(emulator, R, B, warm, kind):
    exe, work = emulator
    rng = np.random.default_rng(R + 10 * B + warm)
    Ac = np.zeros((RA, N, N, RA))
    Ac[0, :, :, 0] = np.eye(N)
    for w in range(1, RA):
        s = rng.standard_normal((N, N)) * 0.1
        Ac[w, :, :, w] = s @ s.T
    inputs = dict(L=np.stack([_env(rng, R) for _ in range(B)]), Ac=Ac,
                  Renv=np.stack([_env(rng, R) for _ in range(B)]),
                  rhs=rng.standard_normal((B, R, N, R)),
                  mask=_mask(rng, R, kind),
                  x0=rng.standard_normal((B, R, N, R)))
    for name, a in inputs.items():
        np.asarray(a, np.float32).tofile(work / f"{name}.bin")
    iters = 6
    subprocess.run([str(exe), str(work), str(B), str(R), str(iters),
                    str(int(warm))], check=True, timeout=600)
    got = np.fromfile(work / "out.bin", np.float32).reshape(B, R, N, R)
    t = {k: torch.as_tensor(np.asarray(a, np.float32))
         for k, a in inputs.items()}
    ref = cg_matfree_batched_plain(
        t["L"], t["Ac"], t["Renv"], t["rhs"], t["mask"],
        x0=t["x0"] if warm else None, iters=iters).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
