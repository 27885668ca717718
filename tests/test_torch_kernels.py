"""Kernels B1-B4 of ttnx_torch: plain versions against the ttnx kernels,
the kernel-or-plain gate, and the C interface of the CUDA build.

The ttnx kernels run as ttnx's own tests run them on the CPU
(``interpret=True``). The ttnx env-chain and matrix-free CG kernels compute
their products in float32 whatever the input type, so the float64 cases
compare against their float64 reference twins in ttnx (the env scan and
the einsum ``'cg'`` local solve). Tolerances: f64 1e-10; f32 1e-5 for
B1/B2 and 1e-4 for B3/B4 after equal iteration counts (CG amplifies the
rounding of f32 products).

The Hopper kernels themselves are checked on a card by
tests/test_torch_cuda.py and by chip_smoke.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttnx.kernels.env_chain import (_env_chain_xla, left_env_chain_fused as
                                    j_left, right_env_chain_fused as j_right)
from ttnx.kernels.gram import gram_chain_fused as j_gram
from ttnx.kernels.local_cg import cg_solve_fused as j_cg
from ttnx.kernels.local_cg_mf import cg_matfree_fused as j_mf
from ttnx.solvers.als_scan import _local_solve_padded as j_local_solve

from ttnx_torch.kernels import _build, dispatch
from ttnx_torch.kernels.env_chain import (left_env_chain_fused,
                                          left_env_chain_plain,
                                          right_env_chain_fused,
                                          right_env_chain_plain)
from ttnx_torch.kernels.gram import gram_chain_fused, gram_chain_plain
from ttnx_torch.kernels.local_cg import cg_solve_fused, cg_solve_plain
from ttnx_torch.kernels.local_cg_mf import cg_matfree_fused, cg_matfree_plain
from ttnx_torch.solvers.als_scan import _local_solve_padded as t_local_solve

F64, F32 = np.float64, np.float32


def _t(a, dt):
    return torch.as_tensor(np.asarray(a, dtype=dt))


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol * float(np.max(np.abs(ref))), err


def _chain(rng, d, R, n=2, active=None):
    """Padded chain (d, R, n, R): zero outside the active rank block."""
    y = rng.standard_normal((d, R, n, R)) / np.sqrt(R)
    if active is not None:
        y[:, active:] = 0.0
        y[:, :, :, active:] = 0.0
    return y


def _env_problem(seed, d=6, R=8, RA=3, Rb=5, n=2):
    rng = np.random.default_rng(seed)
    x = _chain(rng, d, R, n, active=R - 2)
    A = rng.standard_normal((d, RA, n, n, RA)) / RA
    b = rng.standard_normal((d, Rb, n, Rb)) / np.sqrt(Rb)
    return x, A, b


def _local_problem(seed, R, RA=4, n=2, Rb=None):
    """SPD local operator from symmetric positive envs and a symmetric MPO
    core, with masks, rhs envs and a warm start."""
    rng = np.random.default_rng(seed)
    Rb = Rb or R

    def spd_env():
        out = np.zeros((R, RA, R))
        for w in range(RA):
            g = rng.standard_normal((R, R)) / np.sqrt(R)
            out[:, w, :] = g @ g.T + (np.eye(R) if w == 0 else 0.0)
        return out

    L, Renv = spd_env(), spd_env()
    Ac = np.zeros((RA, n, n, RA))
    Ac[0, :, :, 0] = np.eye(n)
    for w in range(1, RA):
        s = rng.standard_normal((n, n)) * 0.1
        Ac[w, :, :, w] = s @ s.T
    m_l = np.ones(R)
    m_l[R - R // 4:] = 0.0
    m_r = np.ones(R)
    m_r[R - R // 8:] = 0.0
    mask = m_l[:, None, None] * m_r[None, None, :] * np.ones((1, n, 1))
    Lb = rng.standard_normal((R, Rb))
    bc = rng.standard_normal((Rb, n, Rb))
    Rbe = rng.standard_normal((R, Rb))
    rhs = np.einsum("au,uiv,cv->aic", Lb, bc, Rbe) * mask
    x0 = rng.standard_normal((R, n, R)) * mask
    return dict(L=L, Ac=Ac, Renv=Renv, Lb=Lb, bc=bc, Rbe=Rbe, m_l=m_l,
                m_r=m_r, mask=mask, rhs=rhs, x0=x0)


def _spd(seed, M):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((M, M)) / np.sqrt(M)
    return g @ g.T + np.eye(M), rng.standard_normal(M), rng.standard_normal(M)


# ---------------------------------------------------------------------------
# B1: Gram chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt,tol", [(F64, 1e-10), (F32, 1e-5)])
@pytest.mark.parametrize("d,R", [(6, 16), (8, 32)])
def test_gram_chain_plain_vs_ttnx_kernel(dt, tol, d, R):
    y = _chain(np.random.default_rng(d + R), d, R, active=R - 3).astype(dt)
    ref = np.asarray(j_gram(jnp.asarray(y), interpret=True))
    _close(gram_chain_plain(_t(y, dt)).numpy(), ref, tol)


# ---------------------------------------------------------------------------
# B2: environment chains
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
def test_env_chain_plain_vs_ttnx_kernel_f32(left):
    x, A, b = (a.astype(F32) for a in _env_problem(3, d=3, R=16, Rb=16))
    j_fn = j_left if left else j_right
    ref = j_fn(jnp.asarray(x), jnp.asarray(A), jnp.asarray(b), interpret=True)
    t_fn = left_env_chain_plain if left else right_env_chain_plain
    got = t_fn(_t(x, F32), _t(A, F32), _t(b, F32))
    for g, r in zip(got, ref):
        _close(g.numpy(), np.asarray(r), 1e-5)


@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
@pytest.mark.parametrize("shape", [dict(R=8, RA=3, Rb=5),
                                   dict(R=16, RA=4, Rb=16)])
def test_env_chain_plain_vs_ttnx_f64(left, shape):
    x, A, b = _env_problem(4, **shape)
    ref = _env_chain_xla(jnp.asarray(x), jnp.asarray(A), jnp.asarray(b),
                         left)
    t_fn = left_env_chain_plain if left else right_env_chain_plain
    got = t_fn(_t(x, F64), _t(A, F64), _t(b, F64))
    for g, r in zip(got, ref):
        _close(g.numpy(), np.asarray(r), 1e-10)


# ---------------------------------------------------------------------------
# B3: dense CG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt,tol", [(F64, 1e-10), (F32, 1e-4)])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_cg_solve_plain_vs_ttnx_kernel(dt, tol, warm):
    K, rhs, x0 = (a.astype(dt) for a in _spd(5, 128))
    ref = j_cg(jnp.asarray(K), jnp.asarray(rhs),
               jnp.asarray(x0) if warm else None, iters=12, interpret=True)
    got = cg_solve_plain(_t(K, dt), _t(rhs, dt),
                         x0=_t(x0, dt) if warm else None, iters=12)
    _close(got.numpy(), np.asarray(ref), tol)


def test_cg_solve_converges():
    K, rhs, _ = _spd(6, 64)
    x = cg_solve_plain(_t(K, F64), _t(rhs, F64), iters=64)
    _close(x.numpy(), np.linalg.solve(K, rhs), 1e-10)


# ---------------------------------------------------------------------------
# B4: matrix-free CG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_cg_matfree_plain_vs_ttnx_kernel_f32(warm):
    p = {k: v.astype(F32) for k, v in _local_problem(7, R=32).items()}
    ref = j_mf(jnp.asarray(p["L"]), jnp.asarray(p["Ac"]),
               jnp.asarray(p["Renv"]), jnp.asarray(p["rhs"]),
               jnp.asarray(p["mask"]),
               jnp.asarray(p["x0"]) if warm else None, iters=10,
               interpret=True)
    got = cg_matfree_plain(_t(p["L"], F32), _t(p["Ac"], F32),
                           _t(p["Renv"], F32), _t(p["rhs"], F32),
                           _t(p["mask"], F32),
                           x0=_t(p["x0"], F32) if warm else None, iters=10)
    _close(got.numpy(), np.asarray(ref), 1e-4)


@pytest.mark.parametrize("R", [24, 32])
def test_cg_matfree_path_vs_ttnx_cg_f64(R):
    """The port's cg_fused local solve above M = 1024 (B4's plain version)
    against ttnx's float64 einsum CG on the same masked system."""
    p = _local_problem(8, R=R)
    args = ("L", "Ac", "Renv", "Lb", "bc", "Rbe", "m_l", "m_r")
    ref = j_local_solve(*(jnp.asarray(p[k]) for k in args),
                        v0=jnp.asarray(p["x0"]), solver="cg", cg_iters=10)
    got = t_local_solve(*(_t(p[k], F64) for k in args), v0=_t(p["x0"], F64),
                        solver="cg_fused", cg_iters=10)
    _close(got.numpy(), np.asarray(ref), 1e-10)


def test_dense_local_path_vs_ttnx_kernel_f64():
    """The port's cg_fused local solve at M <= 1024 (B3 on the assembled
    K) against ttnx's own cg_fused path."""
    p = _local_problem(9, R=12)
    args = ("L", "Ac", "Renv", "Lb", "bc", "Rbe", "m_l", "m_r")
    ref = j_local_solve(*(jnp.asarray(p[k]) for k in args),
                        v0=jnp.asarray(p["x0"]), solver="cg_fused",
                        cg_iters=10)
    got = t_local_solve(*(_t(p[k], F64) for k in args), v0=_t(p["x0"], F64),
                        solver="cg_fused", cg_iters=10)
    _close(got.numpy(), np.asarray(ref), 1e-10)


def test_matfree_equals_dense_cg():
    """B4's plain version and B3's plain version on the assembled K agree
    (same CG, same operator) on a small problem."""
    from ttnx_torch.solvers.als_scan import _assemble_K_padded

    p = _local_problem(10, R=8)
    L, Ac, Renv = (_t(p[k], F64) for k in ("L", "Ac", "Renv"))
    mask = _t(p["mask"], F64)
    K = _assemble_K_padded(L, Ac, Renv, mask)
    M = K.shape[0]
    dense = cg_solve_plain(K, _t(p["rhs"], F64).reshape(M),
                           x0=(_t(p["x0"], F64) * mask).reshape(M), iters=8)
    mf = cg_matfree_plain(L, Ac, Renv, _t(p["rhs"], F64), mask,
                          x0=_t(p["x0"], F64), iters=8)
    _close(mf.numpy().reshape(-1), dense.numpy(), 1e-10)


# ---------------------------------------------------------------------------
# The gate: CPU tensors take the plain version and launch nothing
# ---------------------------------------------------------------------------


def _gate_cases():
    x, A, b = (_t(a, F64) for a in _env_problem(11))
    K, rhs, x0 = (_t(a, F64) for a in _spd(12, 32))
    p = {k: _t(v, F64) for k, v in _local_problem(13, R=8).items()}
    mf = (p["L"], p["Ac"], p["Renv"], p["rhs"], p["mask"])
    return {
        "gram": (gram_chain_fused, gram_chain_plain, (x,), {}),
        "right": (right_env_chain_fused, right_env_chain_plain, (x, A, b),
                  {}),
        "left": (left_env_chain_fused, left_env_chain_plain, (x, A, b), {}),
        "cg": (cg_solve_fused, cg_solve_plain, (K, rhs),
               dict(x0=x0, iters=5)),
        "matfree": (cg_matfree_fused, cg_matfree_plain, mf,
                    dict(x0=p["x0"], iters=5)),
    }


@pytest.mark.parametrize("case", ["gram", "right", "left", "cg", "matfree"])
def test_cpu_tensor_takes_plain_version(case):
    wrapper, plain, args, kwargs = _gate_cases()[case]
    dispatch.reset_launch_counts()
    got, ref = wrapper(*args, **kwargs), plain(*args, **kwargs)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(g, r)
    assert all(v == 0 for v in dispatch.launch_counts().values())
    assert wrapper.launches == 0


def test_gate_rejects_other_devices_and_types():
    with pytest.raises(ValueError):
        dispatch.use_kernel(torch.empty(2, device="meta"))
    with pytest.raises(ValueError):
        dispatch.use_kernel(torch.empty(2), torch.empty(2, device="meta"))
    with pytest.raises(TypeError):
        dispatch.require_real("k", torch.empty(2, dtype=torch.complex128))
    with pytest.raises(TypeError):
        dispatch.require_real("k", torch.empty(2, dtype=torch.float32),
                              torch.empty(2, dtype=torch.float64))
    assert set(dispatch.launch_counts()) == {
        "gram_chain_fused", "right_env_chain_fused", "left_env_chain_fused",
        "cg_solve_fused", "cg_matfree_fused"}


def test_bicgstab_fused_names_missing_kernel():
    p = _local_problem(14, R=4)
    args = [_t(p[k], F64) for k in ("L", "Ac", "Renv", "Lb", "bc", "Rbe",
                                    "m_l", "m_r")]
    with pytest.raises(NotImplementedError, match="B10"):
        t_local_solve(*args, solver="bicgstab_fused")


# ---------------------------------------------------------------------------
# The C interface of the CUDA build
# ---------------------------------------------------------------------------


def _c_entries():
    """``{entry name: number of parameters}`` of every extern "C" function
    (macro-generated ones included) in ttnx_torch/csrc."""
    out = {}
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (ttnx_\w+)\(([^)]*)\)', text):
            out[m.group(1)] = len(m.group(2).split(","))
        macro = re.search(r'#define (TTNX_\w+)\((NAME[^)]*)\)\s*\\\s*'
                          r'extern "C" int NAME\(([^)]*)\)', text)
        if macro:
            nparams = len(macro.group(3).split(","))
            for m in re.finditer(macro.group(1) + r"\((ttnx_\w+)", text):
                out[m.group(1)] = nparams
    return out


def test_c_entries_match_ctypes_signatures():
    entries = _c_entries()
    want = {f"ttnx_{name}_{sfx}": len(args)
            for name, args in _build._SIGNATURES.items()
            for sfx in ("f32", "f64")}
    assert entries == want


def test_build_sources_and_flags():
    names = {p.name for p in _build._sources()}
    assert {"gram_chain.cu", "env_chain.cu", "local_cg.cu", "local_cg_mf.cu",
            "common.cuh"} <= names
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
