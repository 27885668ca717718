"""Kernel B1's route ``grid`` (``ttnx_torch/csrc/gram_chain_grid.cu``, one
persistent cooperative launch over the right-Gram chain) on the CPU,
through the thread emulation of CUDA blocks in ``tests/cuda_emu`` (one
thread per CUDA thread, 256 a block, every block of the grid at once and
the grid barrier a barrier of all their threads), held against the plain
version ``gram_chain_plain`` — which ``test_torch_kernels.py`` holds
against ttnx's kernel. The kernel sizes its grid itself (as many CTAs as
a phase has tiles, at most the co-resident count); the emulated device's
SM count steers it. Every instantiated R (64, 128, 256) on 4 SMs, so a
grid of 4 blocks, fewer than either phase has tiles, and the stride that
deals tiles out is exercised; grids of 3 (which divides no tile count)
and 1, and a device of more SMs than tiles (the grid capped at the tile
count); two runs bit-identical. This checks the tiles' index arithmetic,
the grid sizing, the staged chunks and the barriers without a card; the
card tests (``test_torch_cuda.py``) check it compiled.

Needs g++ with C++20 (``<barrier>``) and skips without it. Tolerance 1e-4
relative to the largest entry, as on the card: f32 products summed in
another order than the plain version's.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ttnx_torch.kernels.gram import GRID_RANKS, gram_chain_plain, gram_route

ROOT = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
CSRC = ROOT / "ttnx_torch" / "csrc"
SMEM = "extern __shared__ __align__(16) float gram_smem[];"


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the CUDA kernel's emulation")
    work = tmp_path_factory.mktemp("gram_emu")
    src = (CSRC / "gram_chain_grid.cu").read_text()
    assert src.count(SMEM) == 1
    src = src.replace(
        SMEM, "float* gram_smem = reinterpret_cast<float*>("
              "emu_dynamic_smem());")
    (work / "gram.cpp").write_text(src)
    exe = work / "emulate_gram"
    done = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-I", str(EMU), "-I", str(CSRC),
         f'-DGRAM_SOURCE="{work / "gram.cpp"}"',
         str(EMU / "emulate_gram.cpp"), "-o", str(exe), "-lpthread"],
        capture_output=True, text=True)
    if done.returncode and "barrier" in done.stderr and "No such file" in \
            done.stderr:
        pytest.skip("g++ has no C++20 <barrier>")
    assert done.returncode == 0, done.stderr[-3000:]
    return exe, work


def _chain(d, R, seed):
    """A seeded chain y (d, R, 2, R), scaled so that G stays of order one
    along the chain, with a masked tail as the CN step's padding leaves."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((d, R, 2, R)) / np.sqrt(2 * R)
    y[:, R - 5:] = 0.0
    return y.astype(np.float32)


def _run(emulator, tag, y, sms):
    """The kernel on an emulated device of ``sms`` SMs, one CTA an SM."""
    exe, work = emulator
    d = work / tag
    d.mkdir(exist_ok=True)
    y.tofile(d / "y.bin")
    done = subprocess.run([str(exe), str(d), str(y.shape[0]),
                           str(y.shape[1]), str(sms)], timeout=600,
                          capture_output=True, text=True)
    if done.returncode:
        return None, done
    return np.fromfile(d / "Gs.bin", np.float32), done


def _grid(done):
    """The grid size the kernel chose on the emulated device."""
    return int(done.stdout.split("grid ")[1])


def _tiles(R):
    """The tiles of either phase at R (32 x 32 and 32 x 16 tiles)."""
    return 2 * (R // 32) ** 2


def _close(got, ref):
    ref = ref.numpy()
    got = got.reshape(ref.shape)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("R,d", [(64, 4), (128, 4), (256, 3)])
def test_grid_route_emulated_matches_plain(emulator, R, d):
    y = _chain(d, R, R)
    got, done = _run(emulator, f"g{R}", y, 4)
    assert got is not None, done.stderr
    assert _grid(done) == 4
    _close(got, gram_chain_plain(torch.as_tensor(y)))


@pytest.mark.parametrize("sms", [1, 3, 64])
def test_grid_route_emulated_any_grid_size(emulator, sms):
    """The same bits on any grid: every output element is summed by one
    CTA in a fixed order, whatever CTA deals with its tile. 64 SMs give
    a grid of the 8 tiles a phase has at R = 64."""
    y = _chain(3, 64, 5)
    ref, _ = _run(emulator, "any4", y, 4)
    got, done = _run(emulator, f"any{sms}", y, sms)
    assert got is not None, done.stderr
    assert _grid(done) == min(sms, _tiles(64))
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    _close(got, gram_chain_plain(torch.as_tensor(y)))


def test_grid_route_emulated_is_deterministic(emulator):
    y = _chain(4, 128, 11)
    first, _ = _run(emulator, "det1", y, 4)
    again, _ = _run(emulator, "det2", y, 4)
    assert np.array_equal(first.view(np.uint32), again.view(np.uint32))


@pytest.mark.parametrize("R", [96, 32])
def test_grid_route_emulated_refuses_other_shapes(emulator, R):
    """R outside 64, 128, 256 is refused by the entry point (an error,
    never another route), as ``gram_route`` sends it to staged."""
    got, done = _run(emulator, f"no{R}", _chain(2, R, 1), 4)
    assert got is None and done.returncode == 3
    assert "error" in done.stderr
    assert gram_route(torch.float32, 2, R, 2) == "staged"


@pytest.mark.parametrize("dtype,d,R,n,route", [
    (torch.float32, 12, 64, 2, "grid"), (torch.float32, 12, 128, 2, "grid"),
    (torch.float32, 12, 256, 2, "grid"), (torch.float32, 12, 96, 2,
                                          "staged"),
    (torch.float64, 12, 256, 2, "staged"), (torch.float32, 12, 64, 3,
                                            "staged")])
def test_gram_route_table(dtype, d, R, n, route):
    """Route grid exactly at f32, n = 2 and the CN steps' RB; RB = 96 and
    f64 stay on staged."""
    assert gram_route(dtype, d, R, n) == route
    assert (route == "grid") == (R in GRID_RANKS and dtype == torch.float32
                                 and n == 2)
