"""The cluster route of kernel B3 (``cg_cluster_kernel`` in
``ttnx_torch/csrc/local_cg.cu``, on ``dense_cluster.cuh``) on the CPU,
through the thread emulation of a cluster of CUDA blocks in
``tests/cuda_emu`` (one thread per CUDA thread, 256 a block, all blocks of
the cluster at once; one barrier for the cluster's threads, partner
addresses mapped to the partner block's shared memory), held against the
plain version ``cg_solve_plain`` — which ``test_torch_cn_step.py`` holds
against ttnx's kernel. The cluster size is the kernel's template
parameter: C = 2 and 4 here (8 on the card), on small M, multiples of C
and not, of 4 and not (the copy path and the element path of K's load),
and one where a block owns no row; warm (the extra matvec whose r slices
ride on the first exchange) and cold. This checks the kernel's row split,
shared-memory layout, pushes and rank-ordered sums without a card; the
card tests (``test_torch_cuda.py``) check it compiled.

Needs g++ with C++20 (``<barrier>``) and skips without it. Tolerance 1e-4
relative to the largest entry, as on the card: f32 CG amplifies the
rounding of products summed in another order.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ttnx_torch.kernels.local_cg import cg_solve_plain

ROOT = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
CSRC = ROOT / "ttnx_torch" / "csrc"
SMEM = "extern __shared__ __align__(16) float bcl_smem[];"


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the CUDA kernel's emulation")
    work = tmp_path_factory.mktemp("cg_emu")
    src = (CSRC / "local_cg.cu").read_text()
    assert src.count(SMEM) == 1
    src = src.replace(
        SMEM, "#define bcl_smem reinterpret_cast<float*>(emu_dynamic_smem())")
    src, launches = re.subn(r"<<<[^>]*>>>", "", src)
    assert launches == 2  # the one-block kernels'
    (work / "local_cg.cpp").write_text(src)
    exe = work / "emulate_cluster"
    done = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-I", str(EMU), "-I", str(CSRC),
         f'-DCLUSTER_SOURCE="{work / "local_cg.cpp"}"',
         str(EMU / "emulate_cluster.cpp"), "-o", str(exe), "-lpthread"],
        capture_output=True, text=True)
    if done.returncode and "barrier" in done.stderr and "No such file" in \
            done.stderr:
        pytest.skip("g++ has no C++20 <barrier>")
    assert done.returncode == 0, done.stderr[-3000:]
    return exe, work


def _run(emulator, K, b, x0, iters, C, tag):
    exe, work = emulator
    d = work / tag
    d.mkdir(exist_ok=True)
    K.astype(np.float32).tofile(d / "K.bin")
    b.astype(np.float32).tofile(d / "b.bin")
    if x0 is not None:
        x0.astype(np.float32).tofile(d / "x0.bin")
    subprocess.run([str(exe), str(d), str(len(b)), str(iters), str(C), "cg",
                    str(int(x0 is not None))], check=True, timeout=600)
    return np.fromfile(d / "out.bin", np.float32)


def _problem(M):
    """SPD K = g g^T / M + I, a rhs and a warm start."""
    rng = np.random.default_rng(M)
    g = rng.standard_normal((M, M))
    K = g @ g.T / M + np.eye(M)
    return tuple(a.astype(np.float32) for a in
                 (K, rng.standard_normal(M), rng.standard_normal(M)))


@pytest.mark.parametrize("C,M,iters,warm", [
    (2, 24, 8, True), (2, 37, 8, False), (4, 64, 8, True), (4, 50, 8, False),
    (4, 61, 6, True), (4, 5, 3, False), (4, 5, 3, True)])
def test_cg_cluster_kernel_emulated_matches_plain(emulator, C, M, iters,
                                                  warm):
    K, b, x0 = _problem(M)
    x0 = x0 if warm else None
    got = _run(emulator, K, b, x0, iters, C, f"c{C}m{M}w{int(warm)}")
    ref = cg_solve_plain(torch.as_tensor(K), torch.as_tensor(b),
                         x0=None if x0 is None else torch.as_tensor(x0),
                         iters=iters).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_cg_cluster_kernel_emulated_zero_iterations(emulator):
    """iters 0: the warm start comes back unchanged, the cold one zero."""
    K, b, x0 = _problem(37)
    assert np.array_equal(_run(emulator, K, b, x0, 0, 4, "z1"), x0)
    assert not _run(emulator, K, b, None, 0, 4, "z0").any()


@pytest.mark.parametrize("C,M", [(2, 37), (4, 61)])
def test_cg_cluster_kernel_emulated_is_deterministic(emulator, C, M):
    """Two runs give the same bits: every sum has a fixed order, whatever
    order the emulated threads run in."""
    K, b, x0 = _problem(M)
    first = _run(emulator, K, b, x0, 6, C, f"d1c{C}m{M}")
    again = _run(emulator, K, b, x0, 6, C, f"d2c{C}m{M}")
    assert np.array_equal(first.view(np.uint32), again.view(np.uint32))
