"""B7's site-resident CUDA kernel (``ttnx_torch/csrc/als_sweep_site.cu``)
on the CPU, through a thread emulation of the card (``tests/cuda_emu``:
one thread per CUDA thread, 512 a block, barriers for ``__syncthreads``
and for the warp shuffles), held against the plain version — which
``test_torch_batched.py`` holds against ttnx's kernel. This checks the
kernel's index arithmetic, shared-memory layouts and reductions without a
card; the card tests (``test_torch_cuda.py``) check it compiled.

Needs g++ with C++20 (``<barrier>``) and skips without it. Tolerance 1e-4
relative to the largest entry, as on the card: f32 CG and the
Newton-Schulz gauge carry the rounding of products summed in another
order.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ttnx_torch.entry import batched_als_problem, flat_spectrum_stack
from ttnx_torch.kernels.als_sweep_fused import als_fwd_bwd_plain

ROOT = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
CSRC = ROOT / "ttnx_torch" / "csrc"
LAUNCH = "<<<B, kThreads, smem, st>>>"


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the CUDA kernel's emulation")
    work = tmp_path_factory.mktemp("site_emu")
    src = (CSRC / "als_sweep_site.cu").read_text()
    assert src.count(LAUNCH) == 1
    (work / "site.cpp").write_text(src.replace(LAUNCH, ""))
    exe = work / "emulate_site"
    done = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-I", str(EMU), "-I", str(CSRC),
         f'-DSITE_SOURCE="{work / "site.cpp"}"',
         str(EMU / "emulate_site.cpp"), "-o", str(exe), "-lpthread"],
        capture_output=True, text=True)
    if done.returncode and "barrier" in done.stderr and "No such file" in \
            done.stderr:
        pytest.skip("g++ has no C++20 <barrier>")
    assert done.returncode == 0, done.stderr[-3000:]
    return exe, work


@pytest.mark.parametrize("R,d,B,cg_iters,cg_polish", [
    (32, 4, 2, 6, 2), (64, 3, 1, 4, 0)])
def test_site_kernel_emulated_matches_plain(emulator, R, d, B, cg_iters,
                                            cg_polish):
    exe, work = emulator
    p = batched_als_problem(torch.device("cpu"), batch=1, rmax=R, d=d)
    rng = np.random.default_rng(R + d)
    rks = p["u_rks"]
    b = np.stack([flat_spectrum_stack(rng, rks, R) for _ in range(B)])
    x = b + 0.3 * np.stack([flat_spectrum_stack(rng, rks, R)
                            for _ in range(B)])
    A, masks = p["lhs_stack"].numpy(), p["masks"].numpy()
    for name, a in (("A", A), ("b", b), ("x", x), ("m", masks)):
        np.asarray(a, np.float32).tofile(work / f"{name}.bin")
    ns = (10, 4)
    subprocess.run([str(exe), str(work), str(B), str(d), str(R),
                    str(cg_iters), str(cg_polish), *map(str, ns)],
                   check=True, timeout=600)
    got = np.fromfile(work / "out.bin", np.float32).reshape(b.shape)
    ref = als_fwd_bwd_plain(
        *(torch.as_tensor(np.asarray(a, np.float32)) for a in (A, b, x,
                                                              masks)),
        cg_iters=cg_iters, cg_polish=cg_polish, ns_iters=ns).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
