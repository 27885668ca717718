"""Every route of kernels B6, B2 and B8 on the column-slab site update
(``ttnx_torch/csrc/env_chain_site.cu`` on ``env_site.cuh``) on the CPU,
through the thread emulation of CUDA blocks in ``tests/cuda_emu`` (one
thread per CUDA thread, 512 a block; route ``resident`` one block a
problem, route ``cluster`` one cluster of R / 4 blocks at once with partner
addresses mapped to the partner block's shared memory), held against the
plain versions ``env_chain_batched_plain``, ``right_env_chain_plain``,
``left_env_chain_plain`` and (B8's route cluster: RA = 5, no rhs)
``env_chain_A_plain`` — which ``test_torch_kernels.py``,
``test_torch_batched.py`` and ``test_torch_dmrg.py`` hold against ttnx's
kernels. Both directions, both env layouts (``raw`` for B6), small d,
every instantiated (R, C). This checks the slabs' index
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

from ttnx_torch.kernels.env_chain import (env_A_route, env_chain_A_plain,
                                          env_chain_batched_plain,
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
    source's EnvLayout does, for every instantiated (R, S, RA, rhs): five
    of B2/B6 (RA = 4 with the rhs), three of B8 (RA = 5 without)."""
    *_, out = _run(emulator, "layout", ("cluster", 1, 16, 0, 0),
                   *_problem(1, 1, 16, 0))
    seen = re.findall(r"smem R (\d+) S (\d+) RA (\d+) rhs (\d+) (\d+)",
                      out)
    assert len(seen) == 8
    for R, S, RA, rhs, nbytes in seen:
        assert site_layout(int(R), int(S), int(RA), bool(int(rhs)))[
            "bytes"] == int(nbytes)
    assert site_layout(64, 4, 5, False)["bytes"] == 211664


def _problem_A(d, R, seed):
    """Seeded B8 inputs: x (d, R, 2, R) at full rank R, A (d, 5, 2, 2, 5),
    scaled so that the envs stay of order one along the chain."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((d, R, 2, R)) / np.sqrt(2 * R)
    A = rng.standard_normal((d, 5, 2, 2, 5)) / 5
    return x.astype(np.float32), A.astype(np.float32)


def _run_A(emulator, tag, d, R, left, x, A):
    exe, work = emulator
    w = work / tag
    w.mkdir(exist_ok=True)
    x.tofile(w / "x.bin")
    A.tofile(w / "A.bin")
    subprocess.run([str(exe), str(w), "clusterA", str(d), str(R),
                    str(int(left))], check=True, timeout=600,
                   capture_output=True, text=True)
    return np.fromfile(w / "envs.bin", np.float32)


@pytest.mark.parametrize("R,d", [(16, 4), (64, 2)])
@pytest.mark.parametrize("left", [False, True])
def test_operator_only_cluster_route_emulated_matches_plain(emulator, R, d,
                                                            left):
    """B8's route cluster (RA = 5, no rhs) on R / 4 blocks: 4 at R = 16,
    16 at R = 64, both directions."""
    x, A = _problem_A(d, R, 40 + R + left)
    got = _run_A(emulator, f"A{R}{int(left)}", d, R, left, x, A)
    ref = env_chain_A_plain(torch.as_tensor(x), torch.as_tensor(A),
                            left=left)
    _close(got, ref)


def test_operator_only_cluster_route_emulated_is_deterministic(emulator):
    x, A = _problem_A(3, 16, 8)
    first = _run_A(emulator, "Adet1", 3, 16, True, x, A)
    again = _run_A(emulator, "Adet2", 3, 16, True, x, A)
    assert np.array_equal(first.view(np.uint32), again.view(np.uint32))


@pytest.mark.parametrize("dtype,R,n,RA,route", [
    (torch.float32, 64, 2, 5, "cluster"), (torch.float32, 32, 2, 5,
                                           "cluster"),
    (torch.float32, 16, 2, 5, "cluster"), (torch.float64, 64, 2, 5,
                                           "staged"),
    (torch.float32, 64, 2, 4, "staged"), (torch.float32, 20, 2, 5,
                                          "staged")])
def test_env_A_route_table(dtype, R, n, RA, route):
    """B8's route cluster exactly at f32, n = 2, RA = 5 and R = 64, 32,
    16; f64 and other shapes stay on staged."""
    assert env_A_route(dtype, R, n, RA) == route
