"""Both routes of kernels B6 and B2 on the column-slab site update
(``ttnx_torch/csrc/env_chain_site.cu`` on ``env_site.cuh``) on the CPU,
through the thread emulation of CUDA blocks in ``tests/cuda_emu`` (one
thread per CUDA thread, 512 a block; route ``resident`` one block a
problem, route ``cluster`` one cluster of R / 4 blocks at once with partner
addresses mapped to the partner block's shared memory), held against the
plain versions ``env_chain_batched_plain``, ``right_env_chain_plain`` and
``left_env_chain_plain`` — which ``test_torch_kernels.py`` and
``test_torch_batched.py`` hold against ttnx's kernels. Both directions,
both env layouts (``raw`` for B6), small d, every instantiated (R, C). This checks the slabs' index
arithmetic, the shared-memory layouts, the pushes and the ping-pong
buffers without a card; the card tests (``test_torch_cuda.py``) check it
compiled. The layouts' shared-memory bytes are checked against their
Python twin ``env_chain.site_layout``.

Needs g++ with C++20 (``<barrier>``) and skips without it. Tolerance 1e-4
relative to the largest entry, as on the card: f32 products summed in
another order than the plain version's.
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ttnx_torch.kernels.env_chain import (env_chain_batched_plain,
                                          left_env_chain_plain,
                                          right_env_chain_plain, site_layout)

ROOT = Path(__file__).resolve().parents[1]
EMU = Path(__file__).resolve().parent / "cuda_emu"
CSRC = ROOT / "ttnx_torch" / "csrc"
SMEM = "extern __shared__ __align__(16) float env_smem[];"


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to run the CUDA kernel's emulation")
    work = tmp_path_factory.mktemp("env_emu")
    src = (CSRC / "env_chain_site.cu").read_text()
    assert src.count(SMEM) == 1
    src = src.replace(
        SMEM, "#define env_smem reinterpret_cast<float*>(emu_dynamic_smem())")
    src, launches = re.subn(r"<<<[^>]*>>>", "", src)
    assert launches == 1  # route resident's
    (work / "env.cpp").write_text(src)
    exe = work / "emulate_env"
    done = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-I", str(EMU), "-I", str(CSRC),
         f'-DENV_SOURCE="{work / "env.cpp"}"',
         str(EMU / "emulate_env.cpp"), "-o", str(exe), "-lpthread"],
        capture_output=True, text=True)
    if done.returncode and "barrier" in done.stderr and "No such file" in \
            done.stderr:
        pytest.skip("g++ has no C++20 <barrier>")
    assert done.returncode == 0, done.stderr[-3000:]
    return exe, work


def _problem(B, d, R, seed):
    """Seeded cores at full rank R: x and b (B, d, R, 2, R), A (d, 4, 2, 2,
    4), scaled so that the envs stay of order one along the chain."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, d, R, 2, R)) / np.sqrt(2 * R)
    b = rng.standard_normal((B, d, R, 2, R)) / np.sqrt(2 * R)
    A = rng.standard_normal((d, 4, 2, 2, 4)) / 4
    return (x.astype(np.float32), A.astype(np.float32),
            b.astype(np.float32))


def _run(emulator, tag, args, x, A, b):
    exe, work = emulator
    d = work / tag
    d.mkdir(exist_ok=True)
    for name, a in (("x", x), ("A", A), ("b", b)):
        a.tofile(d / f"{name}.bin")
    done = subprocess.run([str(exe), str(d), *map(str, args)], check=True,
                          timeout=600, capture_output=True, text=True)
    envs = np.fromfile(d / "envs.bin", np.float32)
    envs_b = np.fromfile(d / "envs_b.bin", np.float32)
    return envs, envs_b, done.stdout


def _close(got, ref):
    ref = ref.numpy()
    got = got.reshape(ref.shape)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("R,B,d", [(32, 2, 3), (64, 1, 2)])
@pytest.mark.parametrize("left", [False, True])
@pytest.mark.parametrize("raw", [False, True])
def test_resident_route_emulated_matches_plain(emulator, R, B, d, left, raw):
    x, A, b = _problem(B, d, R, 7 + left + 2 * raw)
    envs, envs_b, _ = _run(emulator, f"res{R}{int(left)}{int(raw)}",
                           ("resident", B, d, R, int(left), int(raw)),
                           x, A, b)
    ref, ref_b = env_chain_batched_plain(
        *(torch.as_tensor(a) for a in (x, A, b)), left=left, raw=raw)
    _close(envs, ref)
    _close(envs_b, ref_b)


@pytest.mark.parametrize("R,d", [(16, 4), (32, 3), (64, 2)])
@pytest.mark.parametrize("left", [False, True])
def test_cluster_route_emulated_matches_plain(emulator, R, d, left):
    x, A, b = _problem(1, d, R, R + left)
    envs, envs_b, _ = _run(emulator, f"cl{R}{int(left)}",
                           ("cluster", d, R, int(left), 0), x, A, b)
    plain = left_env_chain_plain if left else right_env_chain_plain
    ref, ref_b = plain(*(torch.as_tensor(a) for a in (x[0], A, b[0])))
    _close(envs, ref)
    _close(envs_b, ref_b)


def test_cluster_route_emulated_is_deterministic_and_raw(emulator):
    """Two runs give the same bits (no slab depends on another's sums,
    whatever order the emulated threads run in), and the raw layout is the
    public one transposed."""
    R, d = 16, 3
    x, A, b = _problem(1, d, R, 3)
    first = _run(emulator, "det1", ("cluster", d, R, 0, 0), x, A, b)
    again = _run(emulator, "det2", ("cluster", d, R, 0, 0), x, A, b)
    raw = _run(emulator, "det3", ("cluster", d, R, 0, 1), x, A, b)
    for f, a in zip(first[:2], again[:2]):
        assert np.array_equal(f.view(np.uint32), a.view(np.uint32))
    pub = first[0].reshape(d + 1, R, 4, R)
    assert np.array_equal(raw[0].reshape(d + 1, 4, R, R),
                          pub.transpose(0, 2, 1, 3))


def test_site_layout_matches_the_source(emulator):
    """The Python twin of the shared-memory layout gives the bytes the
    source's EnvLayout does, for every instantiated (R, S)."""
    *_, out = _run(emulator, "layout", ("cluster", 1, 16, 0, 0),
                   *_problem(1, 1, 16, 0))
    seen = re.findall(r"smem R (\d+) S (\d+) (\d+)", out)
    assert len(seen) == 5
    for R, S, nbytes in seen:
        assert site_layout(int(R), int(S))["bytes"] == int(nbytes)
