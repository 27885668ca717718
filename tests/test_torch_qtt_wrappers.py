"""Slice 13 of ttnx_torch: the multi-dimensional QTT wrappers against ttnx
on the CPU, in float64.

Mirrors TestMultiDim and TestMultiDimContracts of tests/test_ops_qtt.py:
``QTTVector``/``QTTOperator`` and their metadata, ``check_compat``, the
serial <-> interleaved reorders (adjacent-site SVD swaps), sampling and
read-out, and the numpy bridges ``qttvector_from_numpy`` /
``qttoperator_from_numpy``, which hand both packages the same QTT objects.
The swaps' SVD gauges differ between LAPACK builds, so the two packages
are compared on dense arrays and ranks, never on raw cores: within 1e-10
relative to the largest entry (the reference tests' own tolerances, 1e-12
to 1e-8, hold against the closed forms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import ttnx
from ttnx.core.tt import TTVector as JVec

import ttnx_torch as tx
from ttnx_torch.utils.convert import (qttoperator_from_numpy,
                                      qttvector_from_numpy, to_numpy)

CPU = torch.device("cpu")
PARITY = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for torch and for the BLAS under numpy, scipy and JAX's
    CPU LAPACK while this module runs: its many small factorizations each
    open a parallel region, and beside the other test workers on a shared
    host their spinning threads slowed a 3 s case to 600 s."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(saved)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _agree(got, ref, tol=PARITY):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol * max(float(np.max(np.abs(ref))), 1e-300), err


def arrays(jq, tq, tol=PARITY):
    """``qttv_to_array`` of a ttnx and a port QTTVector, held to each
    other; returns the port's."""
    ta = _np(tx.qttv_to_array(tq))
    _agree(ta, _np(ttnx.qttv_to_array(jq)), tol)
    return ta


def both_fn(f, n_dims, bits, ordering, **kw):
    return (ttnx.function_to_qttv(f, n_dims, bits, ordering=ordering, **kw),
            tx.function_to_qttv(f, n_dims, bits, ordering=ordering,
                                device=CPU, **kw))


def rand_cores(rng, N, r):
    rks = ttnx.r_and_d_to_rks([1] + [r] * (N - 1) + [1], (2,) * N, rmax=r)
    return [rng.standard_normal((rks[k], 2, rks[k + 1])) for k in range(N)]


def dense(t):
    return _np(tx.ttv_to_tensor(t)).reshape(-1)


def grid(d):
    n = 2 ** d
    return np.arange(n) / (n - 1)


class TestMultiDim:
    def test_wrapper_validation(self, rng):
        cores = rand_cores(rng, 6, 2)
        q = qttvector_from_numpy(cores, 2, 3, "serial", device=CPU)
        assert q.n_dims == 2 and q.bits_per_dim == 3
        x = q.tt()
        assert type(x) is tx.TTVector
        with pytest.raises(ValueError):
            tx.QTTVector(x, 2, 2, "serial")
        with pytest.raises(ValueError):
            tx.QTTVector(x, 2, 3, "weird")
        bad = tx.TTVector([torch.ones(1, 4, 2, dtype=torch.float64),
                           torch.ones(2, 4, 1, dtype=torch.float64)])
        with pytest.raises(ValueError):
            tx.QTTVector(bad, 1, 2, "serial")

    def test_check_compat(self, rng):
        x = tx.TTVector(qttvector_from_numpy(rand_cores(rng, 6, 2), 2, 3,
                                             "serial", device=CPU).cores)
        a = tx.QTTVector(x, 2, 3, "serial")
        with pytest.raises(ValueError):
            tx.check_compat(a, tx.QTTVector(x, 3, 2, "serial"))
        with pytest.raises(ValueError):
            tx.check_compat(a, tx.QTTVector(x, 2, 3, "interleaved"))
        tx.check_compat(a, a)
        tx.check_compat(a, x)  # a plain TT is always compatible

    def test_arithmetic_keeps_metadata(self, rng):
        c1, c2 = rand_cores(rng, 4, 2), rand_cores(rng, 4, 2)
        a = qttvector_from_numpy(c1, 2, 2, "serial", device=CPU)
        b = qttvector_from_numpy(c2, 2, 2, "serial", device=CPU)
        c = a + 2.0 * b
        assert isinstance(c, tx.QTTVector) and c.ordering == "serial"
        jc = (ttnx.QTTVector(JVec([jnp.asarray(v) for v in c1]), 2, 2,
                             "serial")
              + 2.0 * ttnx.QTTVector(JVec([jnp.asarray(v) for v in c2]), 2,
                                     2, "serial"))
        _agree(dense(c.tt()), np.asarray(ttnx.ttv_to_tensor(jc.tt()))
               .reshape(-1))
        for other in (-a, a / 4.0, a - b, a.astype(torch.float32),
                      a.copy(), a.conj(), a.to(CPU), a.with_ot(a.ot)):
            assert isinstance(other, tx.QTTVector)
            assert (other.n_dims, other.bits_per_dim, other.ordering) \
                == (2, 2, "serial")
        assert not isinstance(a + b.tt(), tx.QTTVector)
        assert "QTTVector" in repr(a)

    def test_function_to_qttv_serial(self):
        def f(c):
            return np.sin(np.pi * c[..., 0]) * np.cos(np.pi * c[..., 1])

        arr = arrays(*both_fn(f, 2, 4, "serial"))
        xs = grid(4)
        assert np.allclose(arr, np.sin(np.pi * xs)[:, None]
                           * np.cos(np.pi * xs)[None, :], atol=1e-10)

    def test_function_to_qttv_interleaved_round_trip(self):
        def f(c):
            return np.exp(-((c[..., 0] - 0.5) ** 2 + (c[..., 1] - 0.3) ** 2))

        serial = arrays(*both_fn(f, 2, 3, "serial"))
        inter = arrays(*both_fn(f, 2, 3, "interleaved"))
        assert np.allclose(serial, inter, atol=1e-10)

    def test_function_to_qttv_pointwise_f(self):
        # f of one coordinate vector (not vectorized) takes the loop
        def f(c):
            assert np.ndim(c) == 1
            return float(c[0] + 2 * c[1])

        arrays(*both_fn(f, 2, 2, "interleaved"))
        with pytest.raises(ValueError):
            tx.function_to_qttv(f, 2, 2, ordering="weird", device=CPU)

    def test_reorder_round_trip(self):
        def f(c):
            return 1.0 / (1.0 + c[..., 0] + 2 * c[..., 1])

        jq, q = both_fn(f, 2, 4, "serial")
        qi = tx.reorder(q, "interleaved")
        assert qi.ordering == "interleaved"
        assert arrays(ttnx.reorder(jq, "interleaved"), qi).shape == (16, 16)
        assert np.allclose(_np(tx.qttv_to_array(qi)),
                           _np(tx.qttv_to_array(q)), atol=1e-10)
        back = tx.reorder(qi, "serial")
        assert np.allclose(dense(back.tt()), dense(q.tt()), atol=1e-10)

    def test_reorder_same_ordering_is_copy(self):
        jq, q = both_fn(lambda c: c[..., 0] + c[..., 1], 2, 3, "serial")
        q2 = tx.reorder(q, "serial")
        assert q2.ordering == "serial" and q2 is not q
        assert np.allclose(dense(q2.tt()), dense(q.tt()))
        with pytest.raises(ValueError):
            tx.reorder(q, "weird")
        with pytest.raises(TypeError):
            tx.reorder(q.tt(), "serial")

    def test_interleaved_separable_rank(self):
        # a separable function: the serial ordering has rank 1 across the
        # dimension boundary
        def f(c):
            return np.sin(np.pi * c[..., 0]) * np.sin(np.pi * c[..., 1])

        jq, q = both_fn(f, 2, 4, "serial", tol=1e-10)
        assert q.ranks[4] == 1 and q.ranks == jq.ranks

    def test_operator_wrapper_matvec(self, rng):
        d = 3
        lap = tx.laplacian(2 * d, device=CPU)
        A = tx.QTTOperator(lap, 2, d, "serial")
        cores = rand_cores(rng, 2 * d, 2)
        x = qttvector_from_numpy(cores, 2, d, "serial", device=CPU)
        y = A @ x
        assert isinstance(y, tx.QTTVector)
        ref = _np(ttnx.qtt_to_vector(ttnx.laplacian(2 * d) @ JVec(
            [jnp.asarray(c) for c in cores])))
        _agree(_np(tx.qtt_to_vector(y.tt())), ref)
        assert isinstance(A @ A, tx.QTTOperator)
        assert isinstance(A * x, tx.QTTVector)
        assert isinstance(2.0 * A, tx.QTTOperator)
        assert isinstance(A + A, tx.QTTOperator)
        assert isinstance(A - A, tx.QTTOperator)
        assert type(A @ x.tt()) is tx.TTVector
        assert type(A @ lap) is tx.TTOperator
        assert isinstance(A.astype(torch.float32), tx.QTTOperator)
        with pytest.raises(ValueError):
            A @ tx.QTTVector(x.tt(), 3, 2, "serial")
        with pytest.raises(TypeError):
            A @ 3.0


class TestMultiDimContracts:
    """The multi-dimensional contract: ordering-independent algebra,
    reorder round trips, hadamard, compression and rank growth that keep
    the metadata."""

    def test_dot_norm_arithmetic_ordering_independent(self):
        def f1(c):
            return np.exp(-c[..., 0]) * (1.0 + c[..., 1])

        def f2(c):
            return np.cos(np.pi * c[..., 0]) * (1.0 + 2.0 * c[..., 1])

        bits = 4
        _, q1_il = both_fn(f1, 2, bits, "interleaved")
        jq2, q2_il = both_fn(f2, 2, bits, "interleaved")
        _, q1_sr = both_fn(f1, 2, bits, "serial")
        _, q2_sr = both_fn(f2, 2, bits, "serial")
        arr1 = _np(tx.qttv_to_array(q1_il))
        arr2 = arrays(jq2, q2_il)
        dot_ref = float(np.sum(arr1 * arr2))
        norm_ref = float(np.sqrt(np.sum(arr1 ** 2)))
        for a, b in ((q1_il, q2_il), (q1_sr, q2_sr)):
            assert np.isclose(float(tx.dot(a.tt(), b.tt())), dot_ref,
                              rtol=1e-10)
            assert np.isclose(float(tx.norm(a.tt())), norm_ref, rtol=1e-10)
        assert np.isclose(float(tx.norm(q1_il.tt())) ** 2,
                          float(tx.dot(q1_il.tt(), q1_il.tt())), rtol=1e-10)
        for got, ref in ((q1_il + q2_il, arr1 + arr2),
                         (q1_sr + q2_sr, arr1 + arr2),
                         (q1_il - q2_il, arr1 - arr2),
                         (3.5 * q1_il, 3.5 * arr1), (q1_sr * 3.5, 3.5 * arr1),
                         (q1_il / 2.0, arr1 / 2.0)):
            assert np.allclose(_np(tx.qttv_to_array(got)), ref, atol=1e-12)

    def test_reorder_3d_round_trip_and_cross_validation(self):
        def f(c):
            return (np.cos(np.pi * c[..., 0]) * np.sin(2 * np.pi * c[..., 1])
                    * np.exp(-c[..., 2]))

        bits = 3
        jq_sr, q_sr = both_fn(f, 3, bits, "serial")
        _, q_il = both_fn(f, 3, bits, "interleaved")
        arr_sr = arrays(jq_sr, q_sr)
        arr_il = _np(tx.qttv_to_array(q_il))
        assert np.allclose(arr_sr, arr_il, atol=1e-12)
        q_il_r = tx.reorder(q_sr, "interleaved")
        assert q_il_r.ordering == "interleaved"
        assert q_il_r.n_dims == 3 and q_il_r.bits_per_dim == bits
        assert q_il_r.ranks == ttnx.reorder(jq_sr, "interleaved").ranks
        assert np.allclose(_np(tx.qttv_to_array(q_il_r)), arr_il, atol=1e-10)
        q_il_t = tx.reorder(q_sr, "interleaved", threshold=1e-14)
        assert q_il_t.ranks == ttnx.reorder(jq_sr, "interleaved",
                                            threshold=1e-14).ranks
        assert np.allclose(_np(tx.qttv_to_array(q_il_t)), arr_il, atol=1e-10)
        q_sr_r = tx.reorder(q_il, "serial")
        assert q_sr_r.ordering == "serial"
        assert np.allclose(_np(tx.qttv_to_array(q_sr_r)), arr_sr, atol=1e-10)
        q_rt = tx.reorder(tx.reorder(q_sr, "interleaved"), "serial")
        assert np.allclose(_np(tx.qttv_to_array(q_rt)), arr_sr, atol=1e-10)
        assert np.isclose(float(tx.norm(q_il_r.tt())),
                          float(tx.norm(q_sr.tt())), rtol=1e-10)

    @pytest.mark.parametrize("ordering", ["serial", "interleaved"])
    def test_hadamard_2d_and_identity(self, ordering):
        # incl. the identity sin^2 + cos^2 = 1 in each coordinate product
        bits = 4

        def f1(c):
            return np.sin(np.pi * c[..., 0]) * np.sin(np.pi * c[..., 1])

        def f2(c):
            return np.cos(np.pi * c[..., 0]) * np.cos(np.pi * c[..., 1])

        jq1, q1 = both_fn(f1, 2, bits, ordering)
        jq2, q2 = both_fn(f2, 2, bits, ordering)
        h12 = q1.hadamard(q2)
        assert isinstance(h12, tx.QTTVector) and h12.ordering == ordering
        assert h12.n_dims == 2 and h12.bits_per_dim == bits
        arr = arrays(jq1.hadamard(jq2), h12)
        assert np.allclose(arr, _np(tx.qttv_to_array(q1))
                           * _np(tx.qttv_to_array(q2)), atol=1e-12)
        arr_sum = _np(tx.qttv_to_array(q1.hadamard(q1) + q2.hadamard(q2)))
        xs = grid(bits)
        ref = (np.sin(np.pi * xs[:, None]) ** 2
               * np.sin(np.pi * xs[None, :]) ** 2
               + np.cos(np.pi * xs[:, None]) ** 2
               * np.cos(np.pi * xs[None, :]) ** 2)
        assert np.allclose(arr_sum, ref, atol=1e-12)

    @pytest.mark.parametrize("ordering", ["serial", "interleaved"])
    def test_hadamard_3d(self, ordering):
        bits = 3

        def f1(c):
            return (np.sin(np.pi * c[..., 0]) * np.sin(np.pi * c[..., 1])
                    * np.sin(np.pi * c[..., 2]))

        def f2(c):
            return np.exp(-c[..., 0] - c[..., 1] - c[..., 2])

        jq1, q1 = both_fn(f1, 3, bits, ordering)
        jq2, q2 = both_fn(f2, 3, bits, ordering)
        h12 = q1.hadamard(q2)
        assert isinstance(h12, tx.QTTVector)
        assert h12.ordering == ordering and h12.n_dims == 3
        arr = arrays(jq1.hadamard(jq2), h12)
        assert np.allclose(arr, _np(tx.qttv_to_array(q1))
                           * _np(tx.qttv_to_array(q2)), atol=1e-12)

    def test_separable_serial_rank1_after_compress(self):
        bits = 6
        jq, q = both_fn(lambda c: np.exp(-c[..., 0]) * np.exp(-c[..., 1]), 2,
                        bits, "serial")
        q_c = q.compress(10, truncerr=1e-12)
        assert q_c.ranks[bits] == 1  # the cross-dimension bond
        assert max(q_c.ranks) == 1  # exp is rank 1 in QTT
        assert q_c.ranks == jq.compress(10, truncerr=1e-12).ranks
        xs = grid(bits)
        assert np.allclose(_np(tx.qttv_to_array(q_c)),
                           np.exp(-xs[:, None]) * np.exp(-xs[None, :]),
                           atol=1e-10)

    def test_compress_preserves_metadata(self):
        bits = 5

        def f(c):
            return (np.sin(2 * np.pi * c[..., 0])
                    * np.sin(2 * np.pi * c[..., 1]))

        jq, q = both_fn(f, 2, bits, "interleaved")
        q_c = q.compress(8, truncerr=1e-12)
        assert isinstance(q_c, tx.QTTVector)
        assert q_c.ordering == "interleaved"
        assert q_c.n_dims == 2 and q_c.bits_per_dim == bits
        assert max(q_c.ranks) <= 8
        assert np.allclose(arrays(jq.compress(8, truncerr=1e-12), q_c),
                           _np(tx.qttv_to_array(q)), atol=1e-8)
        assert isinstance(q.orthogonalize(3), tx.QTTVector)
        assert np.allclose(_np(tx.qttv_to_array(q.orthogonalize(3))),
                           _np(tx.qttv_to_array(q)), atol=1e-12)
        _agree(q.entanglement_entropy(), np.asarray(jq.entanglement_entropy()))

    def test_increase_ranks_preserves_metadata_and_values(self):
        bits = 4
        jq, q = both_fn(lambda c: np.exp(-c[..., 0]) * np.exp(-c[..., 1]), 2,
                        bits, "serial")
        q_up = q.increase_ranks(4, noise=0.0)
        assert isinstance(q_up, tx.QTTVector)
        assert (q_up.ordering, q_up.n_dims, q_up.bits_per_dim) == (
            q.ordering, q.n_dims, q.bits_per_dim)
        assert max(q.ranks) < max(q_up.ranks) <= 4
        assert q_up.ranks == jq.increase_ranks(4, noise=0.0).ranks
        assert np.allclose(_np(tx.qttv_to_array(q_up)),
                           _np(tx.qttv_to_array(q)), atol=1e-12)


def test_qtt_bridges_carry_ttnx_objects():
    """ttnx QTT objects, passed as numpy cores plus metadata, come out as
    the same QTT objects of the port."""
    jq = ttnx.function_to_qttv(lambda c: c[..., 0] * np.exp(c[..., 1]), 2, 3,
                               ordering="interleaved")
    q = qttvector_from_numpy([np.array(c) for c in jq.cores], jq.n_dims,
                             jq.bits_per_dim, jq.ordering, jq.ot, device=CPU)
    assert (q.n_dims, q.bits_per_dim, q.ordering, q.ot) == (
        jq.n_dims, jq.bits_per_dim, jq.ordering, jq.ot)
    arrays(jq, q, 0.0)
    jA = ttnx.qtt_laplacian(2, 4, ordering="serial")
    A = qttoperator_from_numpy([np.array(c) for c in jA.cores], 2, 4,
                               "serial", device=CPU, dtype=torch.float64)
    assert isinstance(A, tx.QTTOperator) and A.ordering == "serial"
    _agree(_np(tx.qtto_to_matrix(A)), _np(ttnx.qtto_to_matrix(jA)), 0.0)
    assert all(np.array_equal(a, np.asarray(b))
               for a, b in zip(to_numpy(q), jq.cores))
