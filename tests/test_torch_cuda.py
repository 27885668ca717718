"""The Hopper kernels B1-B4 against their plain versions on a CUDA card.

Every test here needs a card and skips without one. This file imports no
jax, so on a machine with a card and no jax it runs without the suite's
conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Shapes are deliberately ragged (not multiples of the 64-wide GEMM tiles)
so the edge masking of every kernel is exercised. Tolerances: 1e-10 in
float64; 1e-5 in float32 for B1/B2 and 1e-4 for B3/B4 (CG amplifies the
rounding of f32 products); relative to the largest entry.
"""

import numpy as np
import pytest
import torch

from ttnx_torch.kernels.env_chain import (left_env_chain_fused,
                                          left_env_chain_plain,
                                          right_env_chain_fused,
                                          right_env_chain_plain)
from ttnx_torch.kernels.gram import gram_chain_fused, gram_chain_plain
from ttnx_torch.kernels.local_cg import cg_solve_fused, cg_solve_plain
from ttnx_torch.kernels.local_cg_mf import cg_matfree_fused, cg_matfree_plain

DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, ref, tol):
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        err = float((g - r).abs().max())
        assert err <= tol * float(r.abs().max()), err


def _tol(dtype, loose=False):
    if dtype == torch.float64:
        return 1e-10
    return 1e-4 if loose else 1e-5


def _on(dev, dtype, *arrays):
    return [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays]


def _local(rng, R, RA, n=2):
    def env():
        e = np.zeros((R, RA, R))
        for w in range(RA):
            g = rng.standard_normal((R, R)) / np.sqrt(R)
            e[:, w] = g @ g.T + (np.eye(R) if w == 0 else 0.0)
        return e

    Ac = np.zeros((RA, n, n, RA))
    Ac[0, :, :, 0] = np.eye(n)
    for w in range(1, RA):
        s = rng.standard_normal((n, n)) * 0.1
        Ac[w, :, :, w] = s @ s.T
    mask = np.ones((R, n, R))
    mask[R - 3:] = 0.0
    mask[:, :, R - 2:] = 0.0
    rhs = rng.standard_normal((R, n, R)) * mask
    x0 = rng.standard_normal((R, n, R))
    return env(), Ac, env(), rhs, mask, x0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,R", [(5, 20), (4, 70)])
def test_gram_chain_kernel(cuda, dtype, d, R):
    y = np.random.default_rng(R).standard_normal((d, R, 2, R)) / np.sqrt(R)
    (yt,) = _on(cuda, dtype, y)
    before = gram_chain_fused.launches
    got = gram_chain_fused(yt)
    torch.cuda.synchronize()
    assert gram_chain_fused.launches == before + 1
    _close(got, gram_chain_plain(yt), _tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
def test_env_chain_kernel(cuda, dtype, left):
    rng = np.random.default_rng(3)
    d, R, RA, Rb = 4, 20, 3, 12
    x = rng.standard_normal((d, R, 2, R)) / np.sqrt(R)
    A = rng.standard_normal((d, RA, 2, 2, RA)) / RA
    b = rng.standard_normal((d, Rb, 2, Rb)) / np.sqrt(Rb)
    args = _on(cuda, dtype, x, A, b)
    kernel = left_env_chain_fused if left else right_env_chain_fused
    plain = left_env_chain_plain if left else right_env_chain_plain
    got = kernel(*args)
    torch.cuda.synchronize()
    _close(got, plain(*args), _tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_cg_solve_kernel(cuda, dtype, warm):
    rng = np.random.default_rng(5)
    M = 300
    g = rng.standard_normal((M, M)) / np.sqrt(M)
    K, rhs, x0 = _on(cuda, dtype, g @ g.T + np.eye(M),
                     rng.standard_normal(M), rng.standard_normal(M))
    kw = dict(x0=x0 if warm else None, iters=12)
    got = cg_solve_fused(K, rhs, **kw)
    torch.cuda.synchronize()
    _close(got, cg_solve_plain(K, rhs, **kw), _tol(dtype, loose=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("R,RA", [(20, 3), (40, 4)])
def test_cg_matfree_kernel(cuda, dtype, warm, R, RA):
    L, Ac, Renv, rhs, mask, x0 = _on(cuda, dtype, *_local(
        np.random.default_rng(R), R, RA))
    kw = dict(x0=x0 if warm else None, iters=10)
    got = cg_matfree_fused(L, Ac, Renv, rhs, mask, **kw)
    torch.cuda.synchronize()
    _close(got, cg_matfree_plain(L, Ac, Renv, rhs, mask, **kw),
           _tol(dtype, loose=True))


@pytest.mark.cuda
@pytest.mark.parametrize("rmax", [8, 24])
def test_cn_step_kernels_match_plain_f64(cuda, rmax):
    """Two f64 CN steps through the kernels equal the plain versions'
    (B3 at rank 8, B4 at rank 24)."""
    import ttnx_torch.solvers.als_scan as als
    import ttnx_torch.solvers.round_scan as rs
    from ttnx_torch.core.decomp import ttv_to_tensor
    from ttnx_torch.ops.operators import toeplitz_to_qtto
    from ttnx_torch.ops.qtt import qtt_sin

    d = 8
    hg = 1.0 / (2 ** d + 1)
    A = (-1.0 / hg ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, d, device=cuda)
    step, pack, unpack = rs.make_cn_step(
        A, 1e-6, rmax=rmax, dims=(2,) * d,
        u_rks=(1,) + (rmax,) * (d - 1) + (1,), sweep_count=2,
        solver="cg_fused", round_method="gram_chain", cg_iters=16)
    u0 = pack(qtt_sin(d, a=hg, b=1 - hg, device=cuda))
    got = step(step(u0))
    plain = {"gram_chain_fused": gram_chain_plain,
             "right_env_chain_fused": right_env_chain_plain,
             "left_env_chain_fused": left_env_chain_plain,
             "cg_solve_fused": cg_solve_plain,
             "cg_matfree_fused": cg_matfree_plain}
    saved = {}
    try:
        for name, fn in plain.items():
            mod = rs if name == "gram_chain_fused" else als
            saved[name] = (mod, getattr(mod, name))
            setattr(mod, name, fn)
        ref = step(step(u0))
    finally:
        for name, (mod, fn) in saved.items():
            setattr(mod, name, fn)
    # represented vectors, not cores: QR/eigh signs may differ
    _close(ttv_to_tensor(unpack(got)), ttv_to_tensor(unpack(ref)), 1e-10)
