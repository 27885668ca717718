"""The resident route of kernel B5 (``ttnx_torch/csrc/local_cg_site.cu``)
and the cluster route of kernel B4 (``local_cg_cluster.cu``) on the CPU,
through the thread emulation of CUDA blocks in ``tests/cuda_emu`` (one
thread per CUDA thread, 512 a block, barriers for ``__syncthreads`` and
for the warp shuffles; the cluster's R / 4 blocks at once, partner
addresses mapped to the partner block's shared memory), held against the
plain versions ``cg_matfree_batched_plain`` and ``cg_matfree_plain`` —
which ``test_torch_kernels.py`` holds against ttnx's kernel. This checks
the kernels' index arithmetic, shared-memory layouts, pushes, mask
handling and reductions without a card; the card tests
(``test_torch_cuda.py``) check that they compiled. The cluster layout's
shared-memory bytes, read from the compiled source, must fit one SM.

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

from ttnx_torch.kernels.local_cg_mf import (cg_matfree_batched_plain,
                                            cg_matfree_plain)

ROOT = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
CSRC = ROOT / "ttnx_torch" / "csrc"
LAUNCH = "<<<B, kThreads, smem, st>>>"
CLUSTER_SMEM = "extern __shared__ __align__(16) float cgc_smem[];"
SMEM_BLOCK = 232448  # the H100's shared memory a block can use
RA, N = 4, 2


def _compile(gxx, work, driver, define, source):
    """The emulator ``driver`` on ``source`` (text) in ``work``; skips
    without C++20's <barrier>."""
    (work / "kernel.cpp").write_text(source)
    exe = work / driver
    done = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-I", str(EMU), "-I", str(CSRC),
         f'-D{define}="{work / "kernel.cpp"}"', str(EMU / f"{driver}.cpp"),
         "-o", str(exe), "-lpthread"],
        capture_output=True, text=True)
    if done.returncode and "barrier" in done.stderr and "No such file" in \
            done.stderr:
        pytest.skip("g++ has no C++20 <barrier>")
    assert done.returncode == 0, done.stderr[-3000:]
    return exe


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the CUDA kernel's emulation")
    work = tmp_path_factory.mktemp("matfree_emu")
    src = (CSRC / "local_cg_site.cu").read_text()
    assert src.count(LAUNCH) == 1
    return _compile(gxx, work, "emulate_matfree", "MATFREE_SOURCE",
                    src.replace(LAUNCH, "")), work


@pytest.fixture(scope="module")
def cluster_emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the CUDA kernel's emulation")
    work = tmp_path_factory.mktemp("matfree_cluster_emu")
    src = (CSRC / "local_cg_cluster.cu").read_text()
    assert src.count(CLUSTER_SMEM) == 1 and "<<<" not in src
    src = src.replace(CLUSTER_SMEM, "#define cgc_smem reinterpret_cast"
                      "<float*>(emu_dynamic_smem())")
    return _compile(gxx, work, "emulate_matfree_cluster", "CLUSTER_SOURCE",
                    src), work


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


def _problem(rng, R, B, kind, work):
    """B seeded problems with SPD envs, written to ``work``; returns them
    as float32 tensors."""
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
    return {k: torch.as_tensor(np.asarray(a, np.float32))
            for k, a in inputs.items()}


def _held(got, ref):
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("R,B,warm,kind", [
    (32, 1, False, "outer"), (32, 1, True, "scattered"),
    (32, 2, True, "outer"), (32, 2, False, "scattered"),
    (64, 1, True, "outer"), (64, 1, False, "scattered"),
    (64, 2, False, "outer"), (64, 2, True, "scattered"),
    (32, 2, True, "fractional")])
def test_resident_kernel_emulated_matches_plain(emulator, R, B, warm, kind):
    exe, work = emulator
    t = _problem(np.random.default_rng(R + 10 * B + warm), R, B, kind, work)
    iters = 6
    subprocess.run([str(exe), str(work), str(B), str(R), str(iters),
                    str(int(warm))], check=True, timeout=600)
    got = np.fromfile(work / "out.bin", np.float32).reshape(B, R, N, R)
    _held(got, cg_matfree_batched_plain(
        t["L"], t["Ac"], t["Renv"], t["rhs"], t["mask"],
        x0=t["x0"] if warm else None, iters=iters).numpy())


def _smem(stdout):
    return {int(w[2]): int(w[3]) for w in map(str.split, stdout.splitlines())
            if w[:2] == ["smem", "R"]}


@pytest.mark.parametrize("R,warm,kind", [
    (64, True, "outer"), (64, False, "scattered"), (64, True, "fractional"),
    (32, False, "outer")])
def test_cluster_kernel_emulated_matches_plain(cluster_emulator, R, warm,
                                               kind):
    """B4's route cluster, one problem on R / 4 emulated CTAs."""
    exe, work = cluster_emulator
    t = _problem(np.random.default_rng(7 * R + warm), R, 1, kind, work)
    iters = 6
    done = subprocess.run([str(exe), str(work), str(R), str(iters),
                           str(int(warm))], check=True, timeout=600,
                          capture_output=True, text=True)
    assert f"grid {R // 4}" in done.stdout.splitlines()
    got = np.fromfile(work / "out.bin", np.float32).reshape(R, N, R)
    _held(got, cg_matfree_plain(
        t["L"][0], t["Ac"], t["Renv"][0], t["rhs"][0], t["mask"],
        x0=t["x0"][0] if warm else None, iters=iters).numpy())


def test_cluster_layout_fits_one_sm(cluster_emulator):
    """A CTA of route cluster holds L, the whole P and its slices at both
    ranks within the shared memory of one SM (the bytes the compiled
    source reports)."""
    exe, _ = cluster_emulator
    done = subprocess.run([str(exe)], capture_output=True, text=True,
                          timeout=60)
    assert done.returncode == 2  # no problem given
    assert _smem(done.stdout) == {64: 114816, 32: 33408}
    assert max(_smem(done.stdout).values()) <= SMEM_BLOCK
