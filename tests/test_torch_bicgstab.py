"""Kernel B10 (dense-K BiCGStab) and its path, the convection–diffusion
Crank–Nicolson step of ttnx_torch, against ttnx on the same numpy-built
inputs, on the CPU (plain versions of the kernels).

The ttnx kernel runs as ttnx's own tests run it (``interpret=True``).
Tolerances: f64 1e-10; f32 1e-4 (BiCGStab amplifies the rounding of f32
products); relative to the largest entry or, for states, in the 2-norm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ttnx
from ttnx.core.algebra import add_op as j_add_op
from ttnx.core.decomp import ttv_to_tensor as j_dense
from ttnx.kernels.local_cg import bicgstab_solve_fused as j_bicgstab
from ttnx.ops.qtt import qtto_to_matrix
from ttnx.solvers import round_scan as j_rs

from ttnx_torch.core.decomp import ttv_to_tensor as t_dense
from ttnx_torch.entry import (convection_cn_operators, convection_cn_step,
                              dense_cn_reference, three_mode_state)
from ttnx_torch.kernels import local_cg
from ttnx_torch.kernels.local_cg import (bicgstab_route, bicgstab_solve_fused,
                                         bicgstab_solve_plain, cluster_smem)


def _nonsymmetric(seed, M):
    """Diagonally dominant non-symmetric K and a rhs."""
    rng = np.random.default_rng(seed)
    K = rng.standard_normal((M, M)) / np.sqrt(M) + 2.0 * np.eye(M)
    return K, rng.standard_normal(M)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol * float(np.max(np.abs(ref))), err


def _rel(got, ref):
    got, ref = np.asarray(got).reshape(-1), np.asarray(ref).reshape(-1)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("dt,tol", [(np.float64, 1e-10), (np.float32, 1e-4)])
@pytest.mark.parametrize("M", [24, 128])
def test_bicgstab_plain_vs_ttnx_kernel(dt, tol, M):
    K, rhs = (a.astype(dt) for a in _nonsymmetric(M, M))
    ref = j_bicgstab(jnp.asarray(K), jnp.asarray(rhs), iters=12,
                     interpret=True)
    got = bicgstab_solve_plain(torch.as_tensor(K), torch.as_tensor(rhs),
                               iters=12)
    assert got.dtype == (torch.float64 if dt == np.float64
                         else torch.float32)
    _close(got.numpy(), np.asarray(ref), tol)


@pytest.mark.parametrize("dtype,M,route", [
    (torch.float32, 512, "cluster"), (torch.float32, 1, "cluster"),
    (torch.float32, 5, "cluster"), (torch.float32, 668, "cluster"),
    (torch.float32, 669, "l2"), (torch.float32, 999, "l2"),
    (torch.float64, 512, "l2"), (torch.float64, 24, "l2")])
def test_bicgstab_route_follows_dtype_and_size(dtype, M, route):
    """B10 chooses its CUDA kernel by dtype and M alone: f32 K whose rows
    fit a cluster of 8 CTAs' shared memory (227 KB a CTA) the cluster
    kernel, f64 and larger K the one-block L2 kernel."""
    assert bicgstab_route(dtype, M) == route


def test_cluster_route_shared_memory():
    """The cluster route's limit is where one CTA's share (its rows of K
    and of the five sliced vectors, full p and s, four slot arrays) stops
    fitting 227 KB: 136,576 bytes at the path's M = 512 (64 rows, 128 KB
    of K)."""
    assert cluster_smem(512) == 136576
    assert local_cg.CLUSTER_MAX_M == 668
    assert cluster_smem(668) <= local_cg.SMEM_BLOCK < cluster_smem(669)
    assert all(cluster_smem(M) <= local_cg.SMEM_BLOCK
               for M in range(1, 669))


def test_bicgstab_converges_to_dense_solve():
    K, rhs = _nonsymmetric(1, 64)
    x = bicgstab_solve_fused(torch.as_tensor(K), torch.as_tensor(rhs),
                             iters=48)
    _close(x.numpy(), np.linalg.solve(K, rhs), 1e-10)


def test_bicgstab_guards_zero_denominators():
    """A zero rhs makes every inner product zero: the guarded divisions
    give 0 and the solution stays exactly zero; zero iterations return
    the cold start."""
    K, _ = _nonsymmetric(2, 16)
    K = torch.as_tensor(K)
    zero = torch.zeros(16, dtype=torch.float64)
    assert torch.equal(bicgstab_solve_plain(K, zero, iters=5), zero)
    assert torch.equal(bicgstab_solve_plain(K, torch.ones(16,
                                                          dtype=K.dtype),
                                            iters=0), zero)


def _ttnx_convection_step(d, rmax, h, c, dtype, iters):
    hg = 1.0 / (2 ** d + 1)
    A = j_add_op(
        (-1.0 / hg ** 2) * ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d),
        (c / (2 * hg)) * ttnx.toeplitz_to_qtto(0.0, 1.0, -1.0, d))
    return j_rs.make_cn_step(
        A, h, rmax=rmax, dims=(2,) * d,
        u_rks=(1,) + (rmax,) * (d - 1) + (1,), dtype=dtype, sweep_count=2,
        solver="bicgstab_fused", round_method="gram_chain",
        precision="highest", cg_iters=iters)


@pytest.mark.parametrize("tdt,jdt,tol", [
    (torch.float64, jnp.float64, 1e-10), (torch.float32, jnp.float32, 1e-4)],
    ids=["f64", "f32"])
def test_convection_cn_step_matches_ttnx(tdt, jdt, tol):
    """Two steps of convection_cn_step (d=6, rmax=8, 24 BiCGStab
    iterations) against ttnx's make_cn_step with solver='bicgstab_fused'
    (its Pallas kernel in interpret mode) from the same three-mode state,
    compared as dense vectors."""
    d, rmax, h, c, iters = 6, 8, 1e-5, 1e2, 24
    hg = 1.0 / (2 ** d + 1)
    u0 = three_mode_state(d, hg, "cpu")
    step, pack, unpack = convection_cn_step(torch.device("cpu"), rmax=rmax,
                                            d=d, h=h, c=c, dtype=tdt,
                                            bicg_iters=iters)
    u = pack(u0)
    for _ in range(2):
        u = step(u)
    got = t_dense(unpack(u)).double().numpy()
    j_step, j_pack, j_unpack = _ttnx_convection_step(d, rmax, h, c, jdt,
                                                     iters)
    v = j_pack(ttnx.TTVector([jnp.asarray(core.numpy())
                              for core in u0.cores]))
    for _ in range(2):
        v = j_step(v)
    ref = np.asarray(j_dense(j_unpack(v)), np.float64)
    assert _rel(got, ref) <= tol


def test_convection_operators_match_ttnx_generator():
    """The oracle's exact tridiagonal operators against the dense matrix of
    ttnx's QTT generator (the orientation of the convection term)."""
    d, h, c = 5, 1e-4, 30.0
    hg = 1.0 / (2 ** d + 1)
    A = j_add_op(
        (-1.0 / hg ** 2) * ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d),
        (c / (2 * hg)) * ttnx.toeplitz_to_qtto(0.0, 1.0, -1.0, d))
    lhs, rhs = convection_cn_operators(d, hg, h, c)
    _close(((rhs - lhs) / h).toarray(), np.asarray(qtto_to_matrix(A)),
           1e-12)
    _close((rhs + lhs).toarray(), 2 * np.eye(2 ** d), 1e-15)


def test_convection_cn_step_matches_dense_reference():
    """Three f64 steps at d=8, rmax=8 against the sparse-LU oracle; the
    convection moves the state by ~1e-2 over them."""
    d, h, c = 8, 1e-5, 1e2
    hg = 1.0 / (2 ** d + 1)
    u0 = three_mode_state(d, hg, "cpu")
    step, pack, unpack = convection_cn_step(torch.device("cpu"), rmax=8, d=d,
                                            h=h, c=c, dtype=torch.float64)
    u = pack(u0)
    for _ in range(3):
        u = step(u)
    start = t_dense(u0).reshape(-1).numpy()
    ref = dense_cn_reference(d, hg, h, c, start, 3)
    assert _rel(ref, start) > 1e-3
    assert _rel(t_dense(unpack(u)).reshape(-1).numpy(), ref) <= 1e-8
