"""The cluster route of kernel B9 (``lanczos_cluster_kernel`` in
``ttnx_torch/csrc/lanczos.cu``, on ``dense_cluster.cuh``) on the CPU,
through the thread emulation of a cluster of CUDA blocks in
``tests/cuda_emu`` (``emulate_lanczos.cpp``: one thread per CUDA thread,
256 a block, all blocks of the cluster at once), held against the plain
version ``lanczos_plain`` — which ``test_torch_dmrg.py`` holds against
ttnx's kernel. The cluster size is the kernel's template parameter: C = 2
and 4 here (16 on the card), on small M, multiples of C and not, of 4
and not (the float4 and the scalar paths of the loads), and one where a
block owns no row; iters 1, 8 and 24; a breakdown; and shared-memory
budgets forced small, so that rows of K are streamed from device memory
on every matvec (``streamed_matvec``) and, at the smallest, the basis
lives in the output. The layout the host function picks is checked
against its Python twin ``lanczos.cluster_layout``.

Needs g++ with C++20 (``<barrier>``) and skips without it. Tolerance 1e-4
relative to each output's largest entry, as on the card: f32 Lanczos
amplifies the rounding of products summed in another order.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ttnx_torch.kernels.lanczos import (SMEM_BLOCK, cluster_layout,
                                        lanczos_plain)

ROOT = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
CSRC = ROOT / "ttnx_torch" / "csrc"
SMEM = "extern __shared__ __align__(16) float lcl_smem[];"


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the CUDA kernel's emulation")
    work = tmp_path_factory.mktemp("lanczos_emu")
    src = (CSRC / "lanczos.cu").read_text()
    assert src.count(SMEM) == 1
    src = src.replace(
        SMEM, "#define lcl_smem reinterpret_cast<float*>(emu_dynamic_smem())")
    src, launches = re.subn(r"<<<[^>]*>>>", "", src)
    assert launches == 1  # the one-block kernel's
    (work / "lanczos.cpp").write_text(src)
    exe = work / "emulate_lanczos"
    done = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-I", str(EMU), "-I", str(CSRC),
         f'-DLANCZOS_SOURCE="{work / "lanczos.cpp"}"',
         str(EMU / "emulate_lanczos.cpp"), "-o", str(exe), "-lpthread"],
        capture_output=True, text=True)
    if done.returncode and "barrier" in done.stderr and "No such file" in \
            done.stderr:
        pytest.skip("g++ has no C++20 <barrier>")
    assert done.returncode == 0, done.stderr[-3000:]
    return exe, work


def _run(emulator, K, v0, iters, C, budget, tag):
    """(Q, alphas, betas) of the emulated kernel, and its layout line."""
    exe, work = emulator
    d = work / tag
    d.mkdir(exist_ok=True)
    K.astype(np.float32).tofile(d / "K.bin")
    v0.astype(np.float32).tofile(d / "v0.bin")
    M = len(v0)
    done = subprocess.run([str(exe), str(d), str(M), str(iters), str(C),
                           str(budget)], check=True, timeout=600,
                          capture_output=True, text=True)
    out = tuple(np.fromfile(d / f"{n}.bin", np.float32)
                for n in ("Q", "alphas", "betas"))
    return (out[0].reshape(iters, M), *out[1:]), done.stdout.split()


def _spread(M):
    """Symmetric K with eigenvalues spread over [-1, 2], a unit start."""
    rng = np.random.default_rng(M)
    q, _ = np.linalg.qr(rng.standard_normal((M, M)))
    K = (q * np.linspace(-1.0, 2.0, M)) @ q.T
    v0 = rng.standard_normal(M)
    return (0.5 * (K + K.T)).astype(np.float32), \
        (v0 / np.linalg.norm(v0)).astype(np.float32)


def _plain(K, v0, iters):
    return tuple(t.numpy() for t in lanczos_plain(
        torch.as_tensor(K), torch.as_tensor(v0), iters=iters))


def _small_budget(M, iters, C, kind):
    """A budget that leaves half of a CTA's rows resident ("half"), or
    none with the basis in the output ("none")."""
    lay = cluster_layout(M, iters, C)
    ld, rpc = (M + 3) // 4 * 4, (M + C - 1) // C
    if kind == "half":
        return 4 * (lay["fixed"] + iters * ((rpc + 3) // 4 * 4)
                    + (rpc // 2) * ld)
    return 4 * lay["fixed"]


@pytest.mark.parametrize("C,M,iters,budget", [
    (2, 64, 8, "full"), (4, 61, 8, "full"), (4, 96, 24, "full"),
    (2, 50, 1, "full"), (4, 5, 3, "full"), (4, 64, 8, "half"),
    (4, 61, 8, "half"), (2, 96, 24, "none"), (4, 37, 8, "none")])
def test_lanczos_cluster_kernel_emulated_matches_plain(emulator, C, M, iters,
                                                       budget):
    K, v0 = _spread(M)
    nbytes = SMEM_BLOCK if budget == "full" else _small_budget(M, iters, C,
                                                               budget)
    got, layout = _run(emulator, K, v0, iters, C, nbytes,
                       f"c{C}m{M}i{iters}{budget}")
    lay = cluster_layout(M, iters, C, nbytes)
    assert layout == ["resident", str(lay["resident"]), "q_in_smem",
                      str(int(lay["q_in_smem"])), "bytes", str(lay["bytes"])]
    rpc = (M + C - 1) // C
    assert (lay["resident"] == rpc) == (budget == "full")
    assert lay["q_in_smem"] == (budget != "none")
    for g, r in zip(got, _plain(K, v0, iters)):
        assert g.shape == r.shape and np.isfinite(g).all()
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max()
    assert got[2][-1] == 0.0


@pytest.mark.parametrize("budget", ["full", "none"])
def test_lanczos_cluster_kernel_emulated_breakdown(emulator, budget):
    """A diagonal K with an eigenvector start breaks down at the first
    step (w is exactly zero after the reorthogonalization): betas all
    zero, every later row and alpha exactly zero, as in the plain
    version."""
    M, iters, C = 37, 8, 4
    K = np.diag(np.r_[1.0, 2.0, 3.0, np.zeros(M - 3)]).astype(np.float32)
    v0 = np.eye(M, dtype=np.float32)[1]
    nbytes = SMEM_BLOCK if budget == "full" else _small_budget(M, iters, C,
                                                               budget)
    (Q, a, b), _ = _run(emulator, K, v0, iters, C, nbytes, f"bd{budget}")
    rQ, ra, rb = _plain(K, v0, iters)
    assert not b.any() and not rb.any()
    assert not Q[1:].any() and not a[1:].any()
    assert np.array_equal(Q[0], v0) and a[0] == ra[0] == 2.0


def test_lanczos_cluster_kernel_emulated_is_deterministic(emulator):
    """Two runs give the same bits, streamed rows included."""
    K, v0 = _spread(61)
    nbytes = _small_budget(61, 8, 4, "half")
    first, _ = _run(emulator, K, v0, 8, 4, nbytes, "det1")
    again, _ = _run(emulator, K, v0, 8, 4, nbytes, "det2")
    for f, g in zip(first, again):
        assert np.array_equal(f.view(np.uint32), g.view(np.uint32))
