"""The tp-sharded Gram and Gram-chain rounding and the distributed CN step
of ttnx_torch against ttnx's, in float64 on the CPU: ttnx's on 4 of the
conftest's virtual devices, the port's on a pool of 4 gloo ranks
(``test_torch_comm``), on the same numpy chains.

Rounded chains carry eigh gauges, so the packages are compared through the
represented dense tensors (1e-10); the port's sharded Gram-chain rounding
is also held stack for stack to its own single-device ``tt_round_gram``
(the same eigh in one library), as ttnx's tests hold ttnx's. ttnx's own
tests hold its ``gram_chain_round_dist`` to its ``tt_round_gram`` at 1e-10,
so that cheaper twin is ttnx's side here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import ttnx
from ttnx.core.algebra import add_op, matvec, scale_op
from ttnx.core.canonical import orthogonalize, tt_round
from ttnx.core.decomp import ttv_to_tensor
from ttnx.core.tt import id_tto, r_and_d_to_rks
from ttnx.parallel import round_dist as jrd
from ttnx.parallel.batch import make_mesh as j_make_mesh
from ttnx.solvers.als_scan import pack_op, pack_tt, rank_masks, unpack_tt
from ttnx.solvers.round_scan import matvec_padded, round_masks, tt_round_gram

from ttnx_torch.parallel.round_dist import (
    tp_rounding_worthwhile as t_worthwhile)
from ttnx_torch.solvers.round_scan import tt_round_gram as t_round_gram

from test_torch_comm import start_pool

TOL = 1e-10


@pytest.fixture(scope="module")
def pool():
    p = start_pool()
    yield p
    p.close()


def _mesh(shape):
    return j_make_mesh(*shape, devices=jax.devices()[:4])


def _dense(stack, rks):
    return np.asarray(ttv_to_tensor(unpack_tt(jnp.asarray(stack),
                                              rks))).reshape(-1)


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _problem(d=8, rmax=8):
    """ttnx's ``tests/test_round_dist.py`` chain: (I + 0.05 T) applied to
    the sine, padded to ``RA * rmax``; numpy arrays."""
    A = add_op(id_tto(d), scale_op(0.05, ttnx.toeplitz_to_qtto(
        2.0, -1.0, -1.0, d)))
    u = orthogonalize(ttnx.qtt_sin(d), 0)
    RA = max(A.ranks)
    dims = (2,) * d
    u_rks = r_and_d_to_rks(u.ranks, dims, rmax=rmax)
    masks_u = np.asarray(rank_masks(u_rks, rmax))
    masks_A = np.zeros((d + 1, RA))
    for i, r in enumerate(A.ranks):
        masks_A[i, :r] = 1.0
    masks_big = np.stack([np.outer(masks_A[i], masks_u[i]).reshape(-1)
                          for i in range(d + 1)])
    big = np.asarray(matvec_padded(pack_op(A, RA), pack_tt(u, rmax)))
    out_rks = round_masks([min(a * b, RA * rmax)
                           for a, b in zip(A.ranks, u_rks)], rmax, dims)
    ref = np.asarray(ttv_to_tensor(tt_round(matvec(A, u),
                                            max_bond=rmax))).reshape(-1)
    return dict(big=big, masks_big=masks_big, out_rks=out_rks, rmax=rmax,
                masks_out=np.asarray(rank_masks(out_rks, rmax)), ref=ref)


@pytest.fixture(scope="module")
def prob():
    return _problem()


def _round(pool, shape, kind, p, y=None):
    outs = pool.run("test_torch_comm:round_body", shape, kind,
                    p["big"] if y is None else y, p["masks_big"],
                    p["masks_out"], p["rmax"])
    for other in outs[1:]:  # the rounded chain whole on every rank
        np.testing.assert_array_equal(outs[0], other)
    return outs[0]


def test_gram_round_dist_matches_ttnx(pool, prob):
    got = _dense(_round(pool, (1, 4), "gram", prob), prob["out_rks"])
    assert _rel(got, prob["ref"]) < TOL
    mesh = _mesh((1, 4))
    y_sh = jrd.shard_chain(jnp.asarray(prob["big"]), mesh, "tp")
    with mesh:
        j_out = jax.jit(lambda y: jrd.gram_round_dist(
            y, jnp.asarray(prob["masks_big"]), prob["rmax"],
            jnp.asarray(prob["masks_out"]), mesh))(y_sh)
    assert _rel(got, _dense(j_out, prob["out_rks"])) < TOL


@pytest.mark.parametrize("kind", ["gram", "gram_chain"])
def test_tp_2_and_4_give_the_same_tensor(pool, prob, kind):
    vals = [_dense(_round(pool, shape, kind, prob), prob["out_rks"])
            for shape in ((2, 2), (1, 4))]
    np.testing.assert_allclose(vals[0], vals[1], rtol=0, atol=TOL)
    assert _rel(vals[0], prob["ref"]) < TOL


@pytest.mark.parametrize("kind", ["gram", "gram_chain", "pair"])
def test_indivisible_rank_raises(pool, prob, kind):
    R = prob["big"].shape[1]
    bad = prob["big"][:, :R - 2, :, :R - 2]  # 30 % 4 != 0
    y = np.stack([bad, bad]) if kind == "pair" else bad
    assert _round(pool, (1, 4), kind, prob, y) == "ValueError"
    with pytest.raises(ValueError):
        jrd.gram_round_dist(jnp.asarray(bad), prob["masks_big"],
                            prob["rmax"], prob["masks_out"], _mesh((1, 4)))


def test_a_local_block_of_an_indivisible_rank_raises(pool, prob):
    R = prob["big"].shape[1]
    outs = pool.run("test_torch_comm:local_block_raises_body", (1, 4),
                    prob["big"][:, :R - 2, :, :R - 2])
    assert outs == ["ValueError"] * 4


def _chain(d=5, rmax=3):
    """ttnx's ``TestGramChainDist`` chain (R = 12): numpy arrays."""
    A = add_op(id_tto(d), scale_op(0.1, ttnx.toeplitz_to_qtto(
        -2.0, 1.0, 1.0, d)))
    u = orthogonalize(ttnx.qtt_sin(d), 0)
    RA = max(A.ranks)
    dims = (2,) * d
    u_rks = r_and_d_to_rks((1,) + (rmax,) * (d - 1) + (1,), dims, rmax=rmax)
    big = matvec_padded(pack_op(A, RA), pack_tt(u, rmax))
    out_rks = round_masks([min(a * b, RA * rmax)
                           for a, b in zip(A.ranks, u_rks)], rmax, dims)
    masks_out = rank_masks(out_rks, rmax)
    ref = tt_round_gram(big, rmax, masks_out)
    return dict(big=np.asarray(big), masks_big=None, rmax=rmax,
                masks_out=np.asarray(masks_out), out_rks=out_rks,
                ref=_dense(ref, out_rks))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_gram_chain_matches_ttnx_and_the_single_device_rounding(pool,
                                                                shape):
    c = _chain()
    got = _round(pool, shape, "gram_chain", c)
    assert _rel(_dense(got, c["out_rks"]), c["ref"]) < TOL
    single = t_round_gram(torch.tensor(c["big"]), c["rmax"],
                          torch.tensor(c["masks_out"])).numpy()
    np.testing.assert_allclose(got, single, rtol=0, atol=TOL)


def test_pair_equals_two_singles(pool, rng):
    d, R, R_out = 5, 8, 4
    rks = r_and_d_to_rks((1,) + (R,) * (d - 1) + (1,), (2,) * d, rmax=R)
    ys = []
    for _ in range(2):
        y = np.zeros((d, R, 2, R))
        for k in range(d):
            y[k, :rks[k], :, :rks[k + 1]] = rng.standard_normal(
                (rks[k], 2, rks[k + 1])) / np.sqrt(2 * rks[k + 1])
        ys.append(y)
    out_rks = round_masks(rks, R_out, (2,) * d)
    c = dict(masks_big=None, rmax=R_out,
             masks_out=np.asarray(rank_masks(out_rks, R_out)))
    pair = _round(pool, (2, 2), "pair", c, np.stack(ys))
    for q in range(2):
        single = _round(pool, (2, 2), "gram_chain", c, ys[q])
        np.testing.assert_array_equal(pair[q], single)
        ref = _dense(tt_round_gram(jnp.asarray(ys[q]), R_out,
                                   jnp.asarray(c["masks_out"])), out_rks)
        assert _rel(_dense(single, out_rks), ref) < TOL


@pytest.mark.parametrize("force_tp", [True, None])
@pytest.mark.parametrize("round_method", ["gram", "gram_chain"])
def test_cn_step_dist_matches_ttnx(pool, force_tp, round_method):
    d, rmax, h, steps = 8, 8, 1e-7, 3
    kw = dict(sweep_count=3, force_tp=force_tp, round_method=round_method)
    outs = pool.run("test_torch_comm:cn_dist_body", (1, 4), d, rmax, h,
                    steps, kw)
    for other in outs[1:]:  # every rank steps the same state
        np.testing.assert_array_equal(outs[0][0], other[0])
    hg = 1.0 / (2 ** d + 1)
    A = (-1.0 / hg ** 2) * ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d)
    mesh = _mesh((1, 4))
    with mesh:
        sf, pack, unpack = jrd.make_cn_step_dist(
            A, h, rmax, (2,) * d, (1,) + (rmax,) * (d - 1) + (1,), mesh,
            **kw)
        u = pack(ttnx.qtt_sin(d, a=hg, b=1 - hg))
        for _ in range(steps):
            u = sf(u)
    ref = np.asarray(ttv_to_tensor(unpack(u))).reshape(-1)
    assert _rel(outs[0][1], ref) < TOL


@pytest.mark.parametrize("RA,rmax", [(4, 16), (4, 128), (8, 64), (3, 8)])
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_tp_rounding_worthwhile_is_ttnx_s(RA, rmax, p):
    assert t_worthwhile(RA, rmax, p) == jrd.tp_rounding_worthwhile(RA, rmax,
                                                                   p)
    assert t_worthwhile(RA, rmax, p, overhead_x=1.1) == \
        jrd.tp_rounding_worthwhile(RA, rmax, p, overhead_x=1.1)
