"""The port's collectives and local ranks on the CPU, and the rank bodies of
the distributed parity tests.

This module imports neither jax nor ttnx: the ranks of
``ttnx_torch.parallel.launch.RankPool`` import it to run the ``*_body``
functions below (``pool.run("test_torch_comm:<name>", ...)``), for this
file and for ``test_torch_tsqr.py``, ``test_torch_round_dist.py`` and
``test_torch_parallel.py``. Each of those files starts one pool of 4 gloo
ranks (one torch thread each) for the whole module, with the meshes (1, 4),
(2, 2) and (4, 1) built on every rank; every call into a pool waits at most
``POOL_TIMEOUT`` seconds, so a hung collective fails one test.

Here: ``psum``, ``psum_scatter`` and ``all_gather`` on both axes of the (2,
2) mesh against numpy sums and concatenations in axis order (exact: small
integers in float64), the route each takes (``"gloo"`` on CPU tensors), and
the pool's failure handling: a rank that raises while the others wait in a
collective fails the call at once with its traceback, a body that outlives
the timeout fails it, and the next call starts a fresh group.
"""

import time

import numpy as np
import pytest
import torch

from ttnx_torch.parallel.comm import (all_gather, axis_index, axis_size,
                                      psum, psum_scatter, route)
from ttnx_torch.parallel.launch import RankPool

WORLD = 4
MESHES = ((1, 4), (2, 2), (4, 1))
POOL_TIMEOUT = 120.0


def start_pool():
    """The 4-rank CPU pool of a distributed test module."""
    return RankPool(WORLD, device="cpu", meshes=MESHES, timeout=POOL_TIMEOUT)


def coords(rank, shape):
    """``(dp, tp)`` coordinates of ``rank`` in a row-major mesh."""
    return divmod(rank, shape[1])


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# Rank bodies (run on every rank; arguments and results are numpy)
# ---------------------------------------------------------------------------


def comm_body(ctx, shape, axis, xs):
    """This rank's ``xs[rank]`` through the three collectives of ``axis``."""
    mesh = ctx.meshes[shape]
    x = _t(xs[ctx.rank]).to(ctx.device)
    return (axis_index(mesh, axis), axis_size(mesh, axis),
            route(mesh, axis, x), psum(x, mesh, axis),
            psum_scatter(x, mesh, axis, dim=1), all_gather(x, mesh, axis,
                                                           dim=2))


def fail_body(ctx):
    """Rank 1 raises; the others wait in a collective it never joins."""
    if ctx.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return psum(torch.ones(3), ctx.meshes[(1, WORLD)], "tp")


def sleep_body(ctx, seconds):
    time.sleep(seconds)
    return ctx.rank


def tsqr_body(ctx, shape, fn, a, kw=None):
    """``tsqr``/``cholesky_qr2``/``tsvd``/``distributed_truncate_bond`` of
    ``a`` row-sharded over ``dp``; the sharded first output gathered;
    ``"ValueError"`` if it raises one."""
    from ttnx_torch.parallel import tsqr as ts

    mesh = ctx.meshes[shape]
    try:
        out = getattr(ts, fn)(ts.shard_rows(_t(a), mesh), mesh, **(kw or {}))
    except ValueError:
        return "ValueError"
    return (all_gather(out[0], mesh, "dp"),) + tuple(out[1:])


def orth_core_body(ctx, shape, core):
    """``distributed_orthogonalize_core`` with the unfolding of ``core``
    row-sharded over ``dp``."""
    from ttnx_torch.parallel.tsqr import (distributed_orthogonalize_core,
                                          shard_rows)

    mesh = ctx.meshes[shape]
    Rl, n, Rr = core.shape
    block = shard_rows(_t(core).reshape(Rl * n, Rr), mesh).reshape(-1, n, Rr)
    q, r = distributed_orthogonalize_core(block, mesh)
    return all_gather(q, mesh, "dp"), r


def round_body(ctx, shape, kind, y, masks_y, masks_out, R_out):
    """The tp rounding ``kind`` of ``y`` (``"gram"``, ``"gram_chain"`` or,
    for a stack of two chains, ``"pair"``); ``"ValueError"`` if it raises
    one."""
    from ttnx_torch.parallel import round_dist as rd

    mesh = ctx.meshes[shape]
    try:
        y_loc = rd.shard_chain(_t(y), mesh)
        if kind == "gram":
            return rd.gram_round_dist(y_loc, _t(masks_y), R_out,
                                      _t(masks_out), mesh)
        if kind == "gram_chain":
            return rd.gram_chain_round_dist(y_loc, R_out, _t(masks_out),
                                            mesh)
        return rd.gram_chain_round_dist_pair(y_loc, R_out, _t(masks_out),
                                             mesh)
    except ValueError:
        return "ValueError"


def local_block_raises_body(ctx, shape, y):
    """``gram_chain_round_dist`` of ``y`` passed as this rank's block."""
    from ttnx_torch.parallel.round_dist import gram_chain_round_dist

    mesh = ctx.meshes[shape]
    R = y.shape[1]
    try:
        gram_chain_round_dist(_t(y)[..., :R // axis_size(mesh, "tp")], 2,
                              torch.ones(y.shape[0] + 1, 2), mesh)
    except ValueError:
        return "ValueError"
    return "no error"


def cn_dist_body(ctx, shape, d, rmax, h, steps, kw):
    """``steps`` of ``make_cn_step_dist`` on the Dirichlet heat problem
    from ``qtt_sin`` (ttnx's ``TestCNStepDist`` set-up); returns the stack
    and the dense state."""
    from ttnx_torch.core.decomp import ttv_to_tensor
    from ttnx_torch.ops.operators import toeplitz_to_qtto
    from ttnx_torch.ops.qtt import qtt_sin
    from ttnx_torch.parallel.round_dist import make_cn_step_dist

    mesh = ctx.meshes[shape]
    hg = 1.0 / (2 ** d + 1)
    A = (-1.0 / hg ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, d,
                                            device="cpu")
    u_rks = (1,) + (rmax,) * (d - 1) + (1,)
    step, pack, unpack = make_cn_step_dist(A, h, rmax, (2,) * d, u_rks,
                                           mesh, **kw)
    u = pack(qtt_sin(d, a=hg, b=1 - hg, device="cpu"))
    for _ in range(steps):
        u = step(u)
    return u, ttv_to_tensor(unpack(u)).reshape(-1)


def make_mesh_body(ctx, dp, tp):
    from ttnx_torch.parallel.batch import make_mesh

    try:
        mesh = make_mesh(dp, tp, device="cpu")
    except ValueError:
        return "ValueError"
    return tuple(mesh.shape), mesh.mesh_dim_names


def linsolve_body(ctx, shape, A_cores, b_list, x0_list, sweep_count,
                  rmax=None):
    """``batched_als_linsolve`` of numpy cores; the dense solutions."""
    from ttnx_torch.core.decomp import ttv_to_tensor
    from ttnx_torch.parallel.batch import batched_als_linsolve
    from ttnx_torch.utils.convert import (ttoperator_from_numpy,
                                          ttvector_from_numpy)

    A = ttoperator_from_numpy(A_cores, device="cpu")
    bs = [ttvector_from_numpy(c, device="cpu") for c in b_list]
    x0s = [ttvector_from_numpy(c, device="cpu") for c in x0_list]
    outs = batched_als_linsolve(ctx.meshes[shape], A, bs, x0s,
                                sweep_count=sweep_count, rmax=rmax)
    return [ttv_to_tensor(x).reshape(-1) for x in outs]


def dmrg_dp_body(ctx, shape, A_batch, x_batch, m_batch, tol):
    """dp-sharded ``batched_dmrg_eig_sweeps`` (one sweep); the masks and
    energies gathered along ``dp``."""
    from ttnx_torch.parallel.batch import (batched_dmrg_eig_sweeps,
                                           shard_batch)

    mesh = ctx.meshes[shape]
    A, x, m = shard_batch(mesh, _t(A_batch), _t(x_batch), _t(m_batch))
    _, m_out, E = batched_dmrg_eig_sweeps(A, x, m, tol, tol, n_sweeps=1)
    return all_gather(m_out, mesh, "dp"), all_gather(E, mesh, "dp")


def dryrun_body(ctx):
    from ttnx_torch.entry import dryrun_multichip

    return dryrun_multichip(ctx.device)


# ---------------------------------------------------------------------------
# Tests of the collectives and the pool
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool():
    p = start_pool()
    yield p
    p.close()


def _inputs():
    rng = np.random.default_rng(0)
    return [rng.integers(-50, 50, size=(3, 4, 2)).astype(np.float64)
            for _ in range(WORLD)]


@pytest.mark.parametrize("axis", ["dp", "tp"])
def test_collectives_on_a_mesh_axis(pool, axis):
    shape = (2, 2)
    xs = _inputs()
    outs = pool.run("test_torch_comm:comm_body", shape, axis, xs)
    for rank, (idx, size, rt, s, sc, g) in enumerate(outs):
        dp, tp = coords(rank, shape)
        members = ([r for r in range(WORLD) if coords(r, shape)[1] == tp]
                   if axis == "dp" else
                   [r for r in range(WORLD) if coords(r, shape)[0] == dp])
        assert (idx, size, rt) == ((dp if axis == "dp" else tp), 2, "gloo")
        want = sum(xs[r] for r in members)
        np.testing.assert_array_equal(s, want)
        np.testing.assert_array_equal(sc, np.split(want, 2, axis=1)[idx])
        np.testing.assert_array_equal(
            g, np.concatenate([xs[r] for r in members], axis=2))


def test_a_failing_rank_fails_the_call_and_the_next_call_restarts(pool):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        pool.run("test_torch_comm:fail_body", timeout=60)
    assert time.monotonic() - t0 < 30
    assert pool.run("test_torch_comm:sleep_body", 0) == list(range(WORLD))


def test_a_call_past_its_timeout_fails():
    with RankPool(2, device="cpu", timeout=60) as small:
        ranks = list(small._procs)
        with pytest.raises(RuntimeError, match="timed out"):
            small.run("test_torch_comm:sleep_body", 30, timeout=2)
        assert not any(p.is_alive() for p in ranks)
