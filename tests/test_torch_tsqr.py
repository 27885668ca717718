"""Distributed TSQR, CholeskyQR2 and TSVD of ttnx_torch against ttnx's, in
float64 on the CPU: ttnx's on 4 of the conftest's virtual devices, the
port's on a pool of 4 gloo ranks (``test_torch_comm``), the same numpy
matrix row-sharded over ``dp`` on both sides.

The factors are sign-pinned (R's diagonal and the first column of Vt
non-negative), so ``q``, ``r``, ``u``, ``s`` and ``vt`` are compared entry
by entry at 1e-12, besides the reconstructions and orthogonality that
``tests/test_tsqr.py`` checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from ttnx.parallel import tsqr as jts
from ttnx.parallel.batch import make_mesh as j_make_mesh

from test_torch_comm import start_pool

TOL = 1e-12


@pytest.fixture(scope="module")
def pool():
    p = start_pool()
    yield p
    p.close()


def _ttnx(fn, a, shape=(4, 1), **kw):
    mesh = j_make_mesh(*shape, devices=jax.devices()[:4])
    a_sh = jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("dp", None)))
    return [np.asarray(o) for o in getattr(jts, fn)(a_sh, mesh, **kw)]


def _port(pool, fn, a, shape=(4, 1), **kw):
    outs = pool.run("test_torch_comm:tsqr_body", shape, fn, a, kw)
    for other in outs[1:]:  # whole outputs on every rank
        for x, y in zip(outs[0], other):
            np.testing.assert_array_equal(x, y)
    return outs[0]


def _close(got, ref, tol=TOL):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.max(np.abs(g - r)) <= tol, np.max(np.abs(g - r))


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_tsqr_matches_ttnx(pool, rng, shape):
    m, k = 64, 8
    a = rng.standard_normal((m, k))
    q, r = _port(pool, "tsqr", a, shape)
    assert np.allclose(q @ r, a, atol=1e-10)
    assert np.allclose(q.T @ q, np.eye(k), atol=1e-10)
    assert np.all(np.diagonal(r) >= 0)
    _close((q, r), _ttnx("tsqr", a, shape))


def test_tsqr_rejects_short_blocks(pool, rng):
    a = rng.standard_normal((64, 32))  # 16 rows a rank < k = 32
    assert pool.run("test_torch_comm:tsqr_body", (4, 1), "tsqr",
                    a) == ["ValueError"] * 4
    with pytest.raises(ValueError):
        _ttnx("tsqr", a)


def test_cholesky_qr2_short_blocks(pool, rng):
    # local blocks are not tall (64/4 = 16 rows < k = 32): TSQR refuses,
    # CholeskyQR2 covers the (r*n, r) unfolding
    m, k = 64, 32
    a = rng.standard_normal((m, k))
    q, r = _port(pool, "cholesky_qr2", a)
    assert np.allclose(q @ r, a, atol=1e-9)
    assert np.allclose(q.T @ q, np.eye(k), atol=1e-12)
    assert np.all(np.diagonal(r) >= 0)
    _close((q, r), _ttnx("cholesky_qr2", a))


@pytest.mark.parametrize("m,k", [(64, 8), (64, 32)])
def test_tsvd_matches_ttnx(pool, rng, m, k):
    # (64, 32) has short blocks: the panel is CholeskyQR2
    a = rng.standard_normal((m, k))
    u, s, vt = _port(pool, "tsvd", a)
    assert np.allclose((u * s[None, :]) @ vt, a, atol=1e-9)
    assert np.allclose(u.T @ u, np.eye(k), atol=1e-10)
    assert np.allclose(s, np.linalg.svd(a, compute_uv=False), atol=1e-10)
    assert np.all(vt[:, 0] >= 0)
    _close((u, s, vt), _ttnx("tsvd", a))


def test_distributed_truncate_bond(pool, rng):
    m, k, r_true = 64, 8, 3
    a = (rng.standard_normal((m, r_true)) @ rng.standard_normal((r_true, k))
         + 1e-9 * rng.standard_normal((m, k)))
    left, right, keep = _port(pool, "distributed_truncate_bond", a,
                              rel_tol=1e-6)
    assert keep.sum() == r_true
    assert left.shape == (m, k) and right.shape == (k, k)
    assert np.linalg.norm(left @ right - a) < 1e-6
    ref = _ttnx("distributed_truncate_bond", a, rel_tol=1e-6)
    np.testing.assert_array_equal(keep, ref[2])
    _close((left, right), ref[:2])
    # the max_bond cap wins over the tail rule
    _, _, k2 = _port(pool, "distributed_truncate_bond", a, rel_tol=0.0,
                     max_bond=2)
    assert k2.sum() == 2


def test_distributed_orthogonalize_core(pool, rng):
    Rl, n, Rr = 32, 2, 8  # Rl*n = 64 rows -> 16 a rank >= Rr
    core = rng.standard_normal((Rl, n, Rr))
    outs = pool.run("test_torch_comm:orth_core_body", (4, 1), core)
    q_core, transfer = outs[0]
    qm = q_core.reshape(Rl * n, Rr)
    assert np.allclose(qm @ transfer, core.reshape(Rl * n, Rr), atol=1e-10)
    assert np.allclose(qm.T @ qm, np.eye(Rr), atol=1e-10)
    mesh = j_make_mesh(4, 1, devices=jax.devices()[:4])
    core_sh = jax.device_put(jnp.asarray(core.reshape(Rl * n, Rr)),
                             NamedSharding(mesh, P("dp", None)))
    jq, jt = jts.distributed_orthogonalize_core(core_sh.reshape(Rl, n, Rr),
                                                mesh)
    _close((q_core, transfer), (np.asarray(jq), np.asarray(jt)))
