"""Kernels B1-B4 of ttnx_torch: plain versions against the ttnx kernels,
the dense-K local solves of 'cg_fused' and 'bicgstab_fused' (B3, B10)
against ttnx's, the kernel-or-plain gate, and the C interface of the CUDA
build (all kernels).

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
from ttnx_torch.kernels import env_chain, lanczos, local_cg
from ttnx_torch.kernels.env_chain import (env_chain_batched_plain,
                                          env_chain_fused_batched, env_route,
                                          left_env_chain_fused,
                                          left_env_chain_plain,
                                          right_env_chain_fused,
                                          right_env_chain_plain, site_layout)
from ttnx_torch.kernels.gram import gram_chain_fused, gram_chain_plain
from ttnx_torch.kernels.lanczos import (cluster_layout, lanczos_fused,
                                        lanczos_plain, lanczos_route)
from ttnx_torch.kernels.local_cg import (bicgstab_solve_fused,
                                         bicgstab_solve_plain,
                                         cg_cluster_smem, cg_route,
                                         cg_solve_fused, cg_solve_plain)
from ttnx_torch.kernels.local_cg_mf import (cg_matfree_batched_plain,
                                            cg_matfree_fused,
                                            cg_matfree_fused_batched,
                                            cg_matfree_plain, matfree_route)
from ttnx_torch.solvers.als_scan import _local_solve_padded as t_local_solve

from kernel_launches import launches

F64, F32 = np.float64, np.float32
T32 = torch.float32


def _t(a, dt):
    return torch.as_tensor(np.asarray(a, dtype=dt))


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    dt = np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(ref) \
        else np.float64
    got, ref = got.astype(dt), ref.astype(dt)
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
        "bicgstab": (bicgstab_solve_fused, bicgstab_solve_plain, (K, rhs),
                     dict(iters=5)),
    }


@pytest.mark.parametrize("case", ["gram", "right", "left", "cg", "matfree",
                                  "bicgstab"])
def test_cpu_tensor_takes_plain_version(case):
    wrapper, plain, args, kwargs = _gate_cases()[case]
    dispatch.reset_launch_counts()
    got, ref = wrapper(*args, **kwargs), plain(*args, **kwargs)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(g, r)
    assert all(v == 0 for v in dispatch.launch_counts().values())


@pytest.mark.parametrize("dtype,R,n,RA,route", [
    (torch.float32, 64, 2, 4, "cluster"),
    (torch.float32, 32, 2, 4, "cluster"),
    (torch.float64, 64, 2, 4, "streamed"),
    (torch.float64, 32, 2, 4, "streamed"),
    (torch.float32, 20, 2, 4, "streamed"),
    (torch.float32, 40, 2, 4, "streamed"),
    (torch.float32, 16, 2, 4, "streamed"),
    (torch.float32, 64, 2, 3, "streamed"),
    (torch.float32, 64, 3, 4, "streamed"),
])
def test_matfree_route_by_dtype_and_shape(dtype, R, n, RA, route):
    """B4/B5's kernel is chosen from dtype, (R, n, RA) and whether the
    wrapper holds one problem (B4, ``route``) or a batch (B5: ``resident``
    where B4 takes ``cluster``)."""
    assert matfree_route(dtype, R, n, RA) == route
    assert matfree_route(dtype, R, n, RA, batched=True) == (
        "resident" if route == "cluster" else route)


@pytest.mark.parametrize("batched", [False, True], ids=["B4", "B5"])
def test_cpu_tensors_at_resident_shape_take_plain(batched):
    """f32 at the resident kernel's shape (R = 32) on the CPU: the plain
    version, no launch, the recorded route untouched."""
    p = {k: _t(v, F32) for k, v in _local_problem(15, R=32).items()}
    args = [p["L"], p["Ac"], p["Renv"], p["rhs"], p["mask"]]
    x0 = p["x0"]
    wrapper, plain = cg_matfree_fused, cg_matfree_plain
    if batched:
        wrapper, plain = cg_matfree_fused_batched, cg_matfree_batched_plain
        for k in (0, 2, 3):
            args[k] = torch.stack([args[k], 2.0 * args[k]])
        x0 = torch.stack([x0, -x0])
    assert matfree_route(torch.float32, 32, 2, args[1].shape[0],
                         batched) == ("resident" if batched else "cluster")
    with launches(wrapper) as added:
        assert torch.equal(wrapper(*args, x0=x0, iters=3),
                           plain(*args, x0=x0, iters=3))
    assert added == {}


@pytest.mark.parametrize("dtype,M,route", [
    (T32, 512, "cluster"), (T32, 1, "cluster"), (T32, 509, "cluster"),
    (T32, 672, "cluster"), (T32, 673, "l2"), (T32, 1024, "l2"),
    (torch.float64, 512, "l2"), (torch.float64, 24, "l2")])
def test_cg_route_follows_dtype_and_size(dtype, M, route):
    """B3 chooses its CUDA kernel by dtype and M alone: f32 K whose rows
    fit a cluster of 8 CTAs' shared memory the cluster kernel, f64 and
    larger K the one-block L2 kernel."""
    assert cg_route(dtype, M) == route


def test_cg_cluster_route_shared_memory():
    """B3's cluster limit is where one CTA's share (its rows of K, full p
    and r, its slices of x and K p, two slot arrays) stops fitting 227 KB:
    135,744 bytes at the path's M = 512 (64 rows, 128 KB of K)."""
    assert cg_cluster_smem(512) == 135744
    assert local_cg.CG_CLUSTER_MAX_M == 672
    assert cg_cluster_smem(672) <= local_cg.SMEM_BLOCK < cg_cluster_smem(673)
    assert all(cg_cluster_smem(M) <= local_cg.SMEM_BLOCK
               for M in range(1, 673))


@pytest.mark.parametrize("dtype,M,route", [
    (T32, 1024, "cluster"), (T32, 1, "cluster"), (T32, 999, "cluster"),
    (T32, 1025, "l2"), (torch.float64, 1024, "l2"),
    (torch.float64, 16, "l2")])
def test_lanczos_route_follows_dtype_and_size(dtype, M, route):
    """B9 chooses its CUDA kernel by dtype and M alone: f32 at M <= 1024
    (a streamed row is 32 loads a lane) the cluster kernel, f64 and larger
    K the one-block L2 kernel."""
    assert lanczos_route(dtype, M) == route


def test_lanczos_cluster_layout():
    """B9's cluster route at its largest M, 1024, on 16 CTAs: 54 of a
    CTA's 64 rows of K resident at iters 8 (53 at 24), the rest streamed;
    the basis slice in shared memory up to iters 256; a layout for every
    M and iters the path can give, inside 227 KB."""
    lay = cluster_layout(1024, 8)
    assert (lay["resident"], lay["q_in_smem"]) == (54, True)
    assert lay["bytes"] == 228704 <= lanczos.SMEM_BLOCK
    assert cluster_layout(1024, 24)["resident"] == 53
    assert cluster_layout(1024, 256)["q_in_smem"]
    assert not cluster_layout(1024, 1024)["q_in_smem"]
    assert lanczos.CLUSTER_MAX_M == 1024
    for M in range(1, 1025, 7):
        for iters in (1, 8, 24, 32):
            lay = cluster_layout(M, iters)
            assert lay["bytes"] <= lanczos.SMEM_BLOCK
            assert lay["resident"] <= (M + 15) // 16


def test_cpu_tensors_take_plain_b3_b9():
    """f32 K at the cluster routes' sizes on the CPU: the plain versions,
    no launch filed under any route."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((40, 40))
    K = _t(g @ g.T / 40 + np.eye(40), F32)
    v = _t(rng.standard_normal(40) / np.sqrt(40), F32)
    assert cg_route(T32, 40) == lanczos_route(T32, 40) == "cluster"
    with launches(cg_solve_fused) as cg, launches(lanczos_fused) as lz:
        assert torch.equal(cg_solve_fused(K, v, x0=v, iters=3),
                           cg_solve_plain(K, v, x0=v, iters=3))
        for g_, r_ in zip(lanczos_fused(K, v, iters=3),
                          lanczos_plain(K, v, iters=3)):
            assert torch.equal(g_, r_)
    assert cg == lz == {}


@pytest.mark.parametrize("dtype,B,R,n,RA,Rb,route", [
    (T32, 1, 64, 2, 4, 64, "cluster"), (T32, 1, 32, 2, 4, 32, "cluster"),
    (T32, 1, 16, 2, 4, 16, "cluster"), (T32, 512, 64, 2, 4, 64, "resident"),
    (T32, 8, 32, 2, 4, 32, "resident"), (T32, 8, 16, 2, 4, 16, "staged"),
    (T32, 1, 20, 2, 3, 12, "staged"), (T32, 3, 64, 2, 4, 32, "staged"),
    (T32, 1, 64, 2, 5, 64, "staged"), (T32, 1, 24, 2, 4, 24, "staged"),
    (T32, 1, 32, 3, 4, 32, "staged"),
    (torch.float64, 1, 64, 2, 4, 64, "staged"),
    (torch.float64, 512, 64, 2, 4, 64, "staged")])
def test_env_route_by_dtype_and_shape(dtype, B, R, n, RA, Rb, route):
    """B2 and B6 choose their CUDA kernel by dtype, batch and shape alone:
    one f32 chain at ranks 16, 32, 64 the cluster, a batch at 32 or 64 the
    resident block, everything else (f64, other n, RA, Rb, R) the staged
    launches of ``env_chain.cu``."""
    assert env_route(dtype, B, R, n, RA, Rb) == route


def test_env_site_layouts_fit_one_block():
    """Every block shape of routes resident and cluster fits the 227 KB of
    one SM: 228,608 B at R = 64 with slabs of 8 (one block an SM)."""
    assert site_layout(64, 8)["bytes"] == 228608 <= env_chain.SMEM_BLOCK
    for R, S in env_chain.RESIDENT_SLAB.items():
        assert site_layout(R, S)["bytes"] <= env_chain.SMEM_BLOCK
    for R in env_chain.CLUSTER_RANKS:
        assert site_layout(R, 4)["bytes"] <= env_chain.SMEM_BLOCK


def test_env_A_site_layouts_fit_one_block():
    """B8's cluster layouts (RA = 5, no rhs) fit one SM at every rank of
    the route: 211,664 B at R = 64."""
    assert site_layout(64, 4, 5, False)["bytes"] == 211664
    for R in env_chain.CLUSTER_RANKS:
        assert site_layout(R, 4, 5, False)["bytes"] <= env_chain.SMEM_BLOCK


@pytest.mark.parametrize("kernel", ["B1", "B8"])
def test_cpu_tensors_at_grid_and_cluster_shapes_take_plain_b1_b8(kernel):
    """f32 at B1's route grid (RB = 64) and B8's route cluster (R = 16,
    RA = 5) shapes on the CPU: the plain versions, no launch filed under
    any route."""
    rng = np.random.default_rng(6)
    if kernel == "B1":
        wrapper, plain = gram_chain_fused, gram_chain_plain
        args, kw = (_t(rng.standard_normal((3, 64, 2, 64)) / 8, F32),), {}
    else:
        wrapper, plain = env_chain.env_chain_A_fused, \
            env_chain.env_chain_A_plain
        args = (_t(rng.standard_normal((3, 16, 2, 16)) / 4, F32),
                _t(rng.standard_normal((3, 5, 2, 2, 5)) / 5, F32))
        kw = {"left": True}
    with launches(wrapper) as added:
        assert torch.equal(wrapper(*args, **kw), plain(*args, **kw))
    assert added == {}


@pytest.mark.parametrize("batched", [False, True], ids=["B2", "B6"])
def test_cpu_tensors_at_site_shapes_take_plain_b2_b6(batched):
    """f32 at the new routes' shapes on the CPU: the plain versions, no
    launch filed under any route."""
    rng = np.random.default_rng(5)
    d, R = 3, 16
    x = _t(rng.standard_normal((2, d, R, 2, R)) / R, F32)
    A = _t(rng.standard_normal((d, 4, 2, 2, 4)) / 4, F32)
    b = _t(rng.standard_normal((2, d, R, 2, R)) / R, F32)
    if batched:
        wrapper, args = env_chain_fused_batched, (x, A, b)
        ref = env_chain_batched_plain(*args)
    else:
        wrapper, args = right_env_chain_fused, (x[0], A, b[0])
        ref = right_env_chain_plain(*args)
    with launches(wrapper) as added:
        for g_, r_ in zip(wrapper(*args), ref):
            assert torch.equal(g_, r_)
    assert added == {}


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
    with pytest.raises(TypeError):
        dispatch.require_mm_type("k", torch.empty(2, dtype=torch.float64))
    with pytest.raises(TypeError):
        dispatch.require_mm_type("k", torch.empty(2, dtype=torch.bfloat16),
                                 torch.empty(2, dtype=torch.float32))
    dispatch.require_mm_type("k", torch.empty(2, dtype=torch.bfloat16))
    assert set(dispatch.launch_counts()) == {
        "gram_chain_fused", "right_env_chain_fused", "left_env_chain_fused",
        "cg_solve_fused", "cg_matfree_fused", "cg_matfree_fused_batched",
        "env_chain_fused_batched", "als_fwd_bwd_fused_batched",
        "env_chain_A_fused", "lanczos_fused", "bicgstab_solve_fused",
        "two_site_merge", "matmul_chain", "merge_resplit_chain",
        "qr_batched"}


def _nonsymmetric_local(seed, R, cplx=False):
    """A masked local system with a non-symmetric MPO core (a skew part
    of 0.3 in the physical block), optionally with complex parts (the
    caller casts every operand to one complex type, as a sweep does)."""
    p = _local_problem(seed, R=R)
    rng = np.random.default_rng(seed + 100)
    skew = rng.standard_normal(p["Ac"].shape) * 0.3
    p["Ac"] = p["Ac"] + skew - np.swapaxes(skew, 1, 2)
    if cplx:
        for k in ("Ac", "Lb", "bc"):
            p[k] = p[k] + 0.2j * rng.standard_normal(p[k].shape)
    return p


@pytest.mark.parametrize("R,cplx", [(12, False), (24, False), (8, True)],
                         ids=["dense-K B10", "oversized matrix-free",
                              "complex matrix-free"])
def test_bicgstab_fused_local_path_vs_ttnx_f64(R, cplx):
    """The port's 'bicgstab_fused' local solve against ttnx's on the same
    masked non-symmetric system: B10 on the assembled K at M = 288 <= 1024,
    the matrix-free 'bicgstab' at M = 1152 and for complex dtypes (ttnx's
    routes exactly); f64/c128, 1e-10."""
    p = _nonsymmetric_local(14 + R, R, cplx)
    args = ("L", "Ac", "Renv", "Lb", "bc", "Rbe", "m_l", "m_r")
    dt = torch.complex128 if cplx else torch.float64
    jdt = jnp.complex128 if cplx else jnp.float64
    ref = j_local_solve(*(jnp.asarray(p[k], dtype=jdt) for k in args),
                        v0=jnp.asarray(p["x0"], dtype=jdt),
                        solver="bicgstab_fused", cg_iters=12)
    got = t_local_solve(*(torch.as_tensor(p[k]).to(dt) for k in args),
                        v0=_t(p["x0"], F64).to(dt), solver="bicgstab_fused",
                        cg_iters=12)
    _close(got.numpy(), np.asarray(ref), 1e-10)


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
        for macro in re.finditer(r'#define (TTNX_\w+)\((NAME[^)]*)\)\s*'
                                 r'\\\s*extern "C" int NAME\(([^)]*)\)',
                                 text):
            nparams = len(macro.group(3).split(","))
            for m in re.finditer(macro.group(1) + r"\((ttnx_\w+)", text):
                out[m.group(1)] = nparams
    return out


def test_c_entries_match_ctypes_signatures():
    entries = _c_entries()
    want = {f"ttnx_{name}_{sfx}": len(args)
            for name, (args, suffixes) in _build._SIGNATURES.items()
            for sfx in suffixes}
    assert entries == want
    assert {sfx for _, suffixes in _build._SIGNATURES.values()
            for sfx in suffixes} == {"f32", "f64", "bf16"}


def test_build_sources_and_flags():
    names = {p.name for p in _build._sources()}
    assert {"gram_chain.cu", "env_chain.cu", "local_cg.cu", "local_cg_mf.cu",
            "local_cg_site.cu", "als_sweep_fused.cu", "als_sweep_site.cu",
            "lanczos.cu", "contraction.cu", "common.cuh",
            "site_engine.cuh"} <= names
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
