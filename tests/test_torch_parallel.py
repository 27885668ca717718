"""The mesh half of ttnx_torch.parallel.batch and the multichip dry run,
in float64 on the CPU: the port on a pool of 4 gloo ranks
(``test_torch_comm``), ttnx on 4 of the conftest's virtual devices, the
same numpy inputs on both sides.

Mirrors ``tests/test_scan_parallel.py::TestParallel`` (mesh shapes and
validation, the batched linear solve against ttnx's and its accuracy) and
``tests/test_batched_solvers.py::test_dp_sharded_equals_unsharded`` (the
dp-sharded batched DMRG against the unsharded loop and ttnx's, energies at
1e-8 and masks exactly), then runs ``entry.dryrun_multichip`` on the 4
ranks. Solutions are compared as dense vectors (1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ttnx
from ttnx.core.decomp import ttv_to_tensor
from ttnx.parallel import batch as jbatch
from ttnx.solvers.als_scan import (als_linsolve_scan, pack_op, pack_tt,
                                   rank_masks)

import ttnx_torch.parallel
from ttnx_torch.parallel.batch import batched_dmrg_eig_sweeps

from test_torch_comm import WORLD, start_pool


@pytest.fixture(scope="module")
def pool():
    p = start_pool()
    yield p
    p.close()


def _cores(x):
    return [np.asarray(c) for c in x.cores]


def _vec(x):
    return np.asarray(ttv_to_tensor(x)).reshape(-1)


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_mesh_shapes(pool):
    outs = pool.run("test_torch_comm:make_mesh_body", 2, 2)
    assert outs == [((2, 2), ("dp", "tp"))] * WORLD
    outs = pool.run("test_torch_comm:make_mesh_body", None, 1)
    assert outs == [((WORLD, 1), ("dp", "tp"))] * WORLD


def test_mesh_validation(pool):
    assert pool.run("test_torch_comm:make_mesh_body", 3, 3) == \
        ["ValueError"] * WORLD
    with pytest.raises(ValueError):
        jbatch.make_mesh(dp=3, tp=3)


def test_batched_solve_matches_ttnx(pool, key):
    d = 6
    h = 1.0 / (2 ** d + 1)
    A = (ttnx.id_tto(d)
         + 1e-5 / h ** 2 * ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d))
    keys = jax.random.split(key, 4)
    bs = [ttnx.qtt_sin(d, lam=k + 1) for k in range(4)]
    x0s = [ttnx.rand_tt(keys[k], (2,) * d, rmax=6, normalise=True)
           for k in range(4)]
    outs = pool.run("test_torch_comm:linsolve_body", (2, 2), _cores(A),
                    [_cores(b) for b in bs], [_cores(x) for x in x0s], 4)
    for other in outs[1:]:  # the whole list on every rank
        np.testing.assert_array_equal(np.stack(outs[0]), np.stack(other))
    # ttnx's single-problem scan solve, which ttnx's own test holds its
    # batched_als_linsolve to
    for got, b, x0 in zip(outs[0], bs, x0s):
        ref = als_linsolve_scan(A, b, x0, sweep_count=4, rmax=6)
        assert _rel(got, _vec(ref)) < 1e-10


def test_batched_solve_accuracy(pool, key):
    d = 6
    keys = jax.random.split(key, 8)
    bs = [ttnx.qtt_sin(d, lam=0.5 * (k + 1)) for k in range(8)]
    x0s = [ttnx.rand_tt(keys[k], (2,) * d, rmax=4, normalise=True)
           for k in range(8)]
    outs = pool.run("test_torch_comm:linsolve_body", (4, 1),
                    _cores(ttnx.id_tto(d)), [_cores(b) for b in bs],
                    [_cores(x) for x in x0s], 4)
    for got, b in zip(outs[0], bs):
        assert _rel(got, _vec(b)) < 1e-11


def test_dp_sharded_equals_unsharded(pool):
    """Eight XXZ chains over a field sweep (d = 6, rank-4 starts from numpy
    seeds, rmax 8), one DMRG sweep each, sharded over dp = 4."""
    d, rmax, tol = 6, 8, 1e-10
    lams = (0.0, 0.4, 0.9, 0.0, 0.4, 0.9, 0.0, 0.4)
    ops = [ttnx.heisenberg_xyz_tto(d, jx=1.0, jy=1.0, jz=0.5, lam=lam,
                                   field="z") for lam in lams]
    A = np.stack([np.asarray(pack_op(H, max(H.ranks))) for H in ops])
    rng = np.random.default_rng(7)
    xs, ms = [], []
    for _ in lams:
        cores = []
        rks = (1, 2, 4, 4, 4, 2, 1)
        for k in range(d):
            q, _ = np.linalg.qr(rng.standard_normal((rks[k] * 2, rks[k + 1])))
            cores.append(q.reshape(rks[k], 2, rks[k + 1]))
        x = ttnx.TTVector([jnp.asarray(c) for c in cores])
        xs.append(np.asarray(pack_tt(x, rmax)))
        ms.append(np.asarray(rank_masks(x.ranks, rmax)))
    x_batch, m_batch = np.stack(xs), np.stack(ms)
    outs = pool.run("test_torch_comm:dmrg_dp_body", (4, 1), A, x_batch,
                    m_batch, tol)
    m_dist, E_dist = outs[0]
    _, m_ref, E_ref = batched_dmrg_eig_sweeps(
        torch.as_tensor(A), torch.as_tensor(x_batch),
        torch.as_tensor(m_batch), tol, tol, n_sweeps=1)
    np.testing.assert_allclose(E_dist, E_ref.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(m_dist, m_ref.numpy())
    j_tol = jnp.float64(tol)
    _, j_m, j_E = jbatch.batched_dmrg_eig_sweeps(
        jnp.asarray(A), jnp.asarray(x_batch), jnp.asarray(m_batch), j_tol,
        j_tol, n_sweeps=1)
    np.testing.assert_allclose(E_dist, np.asarray(j_E), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(m_dist, np.asarray(j_m))


def test_dryrun_multichip_on_four_ranks(pool):
    """Every leg of the dry run under ttnx's threshold, on every rank (the
    function raises on a miss)."""
    outs = pool.run("test_torch_comm:dryrun_body")
    limits = dict(vs_unsharded_err=1e-6, cn_gram_err=1e-6,
                  cn_gram_chain_err=1e-6, dp_dmrg_err=1e-8,
                  dp_tdvp_err=1e-10, tsqr_err=1e-5, tsvd_err=1e-5,
                  pipe_round_err=1e-10)
    for errs in outs:
        assert set(errs) == set(limits)
        assert all(errs[k] < lim for k, lim in limits.items())
    assert outs[0]["vs_unsharded_err"] == 0.0


def test_ttnx_parallel_names_resolve_on_the_port():
    names = [n for n in dir(ttnx.parallel) if not n.startswith("_")
             and callable(getattr(ttnx.parallel, n))]
    assert len(names) == 9
    missing = [n for n in names if not hasattr(ttnx_torch.parallel, n)]
    assert not missing, missing
