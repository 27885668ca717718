"""Slice 13 of ttnx_torch: the QTT constructor library against ttnx on the
CPU, in float64 (complex128 for the Fourier MPO).

Mirrors tests/test_ops_operators.py, the grid, encoding and splitting
cases of tests/test_ops_qtt.py, tests/test_fourier.py and
tests/test_interpolation.py: each case builds the same object in both
packages (random inputs from numpy seeds, fed to both), holds the port to
the reference test's closed form with that test's tolerance, and holds
port and ttnx to each other on gauge-free quantities (dense matrices and
grid vectors) within 1e-12 relative to the largest entry unless the case
says otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import ttnx
from ttnx.core.tt import TTVector as JVec

import ttnx_torch as tx
from ttnx_torch.core.canonical import tt_compress
from ttnx_torch.ops import fourier as t_fourier
from ttnx_torch.ops import qtt as t_qtt
from ttnx_torch.utils.convert import ttvector_from_numpy

CPU = torch.device("cpu")
PARITY = 1e-12


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
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol * scale, err


def mats(j_op, t_op):
    """Dense matrices of the ttnx and the port operator, held to each
    other; returns the port's."""
    jm, tm = _np(ttnx.qtto_to_matrix(j_op)), _np(tx.qtto_to_matrix(t_op))
    _agree(tm, jm)
    return tm


def vecs(j_tt, t_tt, tol=PARITY):
    """Grid vectors of a ttnx and a port QTT, held to each other."""
    jv, tv = _np(ttnx.qtt_to_vector(j_tt)), _np(tx.qtt_to_vector(t_tt))
    _agree(tv, jv, tol)
    return tv


def rand_cores(rng, dims, rmax, orthogonal=False):
    """Cores of a random normalized TT (numpy), ranks feasibility-clamped,
    left-orthonormal when ``orthogonal``."""
    rks = ttnx.r_and_d_to_rks([1] + [rmax] * (len(dims) - 1) + [1], dims,
                              rmax=rmax)
    cores = []
    for k, n in enumerate(dims):
        c = rng.standard_normal((rks[k], n, rks[k + 1])) / np.sqrt(
            n * rks[k + 1])
        if orthogonal:
            q, _ = np.linalg.qr(c.reshape(rks[k] * n, rks[k + 1]))
            c = q.reshape(rks[k], n, -1)
        cores.append(c)
    return cores


def both(cores):
    """The same TT in both packages."""
    return (JVec([jnp.asarray(c) for c in cores]),
            ttvector_from_numpy(cores, device=CPU))


def tridiag(n, alpha, beta, gamma):
    """alpha*I + beta*superdiag + gamma*subdiag."""
    m = alpha * np.eye(n)
    m += beta * np.diag(np.ones(n - 1), 1)
    m += gamma * np.diag(np.ones(n - 1), -1)
    return m


def grid(d):
    n = 2 ** d
    return np.arange(n) / (n - 1)


def bitrev_perm(d):
    return [int(f"{i:0{d}b}"[::-1], 2) for i in range(2 ** d)]


# ---------------------------------------------------------------------------
# Operators (tests/test_ops_operators.py)
# ---------------------------------------------------------------------------


class TestToeplitz:
    @pytest.mark.parametrize("d", [2, 3, 5])
    def test_general(self, d):
        a, b, g = 2.0, -1.0, 0.5
        m = mats(ttnx.toeplitz_to_qtto(a, b, g, d),
                 tx.toeplitz_to_qtto(a, b, g, d, device=CPU))
        assert np.allclose(m, tridiag(2 ** d, a, b, g))

    def test_ranks(self):
        op = tx.toeplitz_to_qtto(1, 2, 3, 4, device=CPU)
        assert op.ranks == ttnx.toeplitz_to_qtto(1, 2, 3, 4).ranks \
            == (1, 3, 3, 3, 1)

    def test_shift(self):
        m = mats(ttnx.shift(3), tx.shift(3, device=CPU))
        assert np.allclose(m, tridiag(8, 0, 1, 0))

    def test_gradient(self):
        m = mats(ttnx.gradient(3), tx.gradient(3, device=CPU))
        assert np.allclose(m, tridiag(8, 1, 0, -1))

    def test_laplacian_dd(self):
        d = 6
        m = mats(ttnx.laplacian(d), tx.laplacian(d, device=CPU))
        assert np.allclose(m, tridiag(2 ** d, 2, -1, -1))


def _bc_matrix(n, first, last):
    m = tridiag(n, 2, -1, -1)
    m[0, 0] = first
    m[-1, -1] = last
    return m


class TestLaplacianBCs:
    @pytest.mark.parametrize("bc,first,last", [("DN", 2, 1), ("ND", 1, 2),
                                               ("NN", 1, 1)])
    def test_bc(self, bc, first, last):
        d = 6
        name = f"laplacian_{bc}"
        m = mats(getattr(ttnx, name)(d), getattr(tx, name)(d, device=CPU))
        assert np.allclose(m, _bc_matrix(2 ** d, first, last))

    def test_periodic(self):
        d = 5
        n = 2 ** d
        ref = tridiag(n, 2, -1, -1)
        ref[0, -1] = -1
        ref[-1, 0] = -1
        m = mats(ttnx.laplacian_P(d), tx.laplacian_P(d, device=CPU))
        assert np.allclose(m, ref)

    def test_inverse_dn(self):
        d = 5
        a = mats(ttnx.laplacian_DN(d), tx.laplacian_DN(d, device=CPU))
        ainv = mats(ttnx.inv_laplacian_DN(d),
                    tx.inv_laplacian_DN(d, device=CPU))
        assert np.allclose(a @ ainv, np.eye(2 ** d))

    @pytest.mark.parametrize("name", ["laplacian_DN", "laplacian_ND",
                                      "laplacian_NN", "laplacian_P"])
    def test_min_dim_guard(self, name):
        with pytest.raises(ValueError):
            getattr(ttnx, name)(3)
        with pytest.raises(ValueError):
            getattr(tx, name)(3, device=CPU)


class TestProlongations:
    def test_square_prolongation_entries(self):
        # the reference pins a few entries against its half-width oracle
        d = 3
        p = mats(ttnx.qtto_prolongation(d),
                 tx.qtto_prolongation(d, device=CPU))
        n = 2 ** (d - 1)
        oracle = np.zeros((2 * n, n))
        oracle[0, 0] = 0.5
        for k in range(n):
            oracle[2 * k + 1, k] = 1.0
        for k in range(n - 1):
            oracle[2 * k + 2, k] += 0.5
            oracle[2 * k + 2, k + 1] += 0.5
        for i, j in ((0, 0), (0, 2), (0, 3), (1, 0)):
            assert p[i, j] == oracle[i, j]

    def test_constant_prolongation(self):
        d = 3
        P = tx.qtto_constant_prolongation(d, device=CPU)
        jP = ttnx.qtto_constant_prolongation(d)
        assert P.N == jP.N == d + 1
        # through the rectangular matvec on each basis vector
        for col in range(2 ** d):
            out = vecs(jP @ ttnx.qtt_basis_vector(d, col),
                       P @ tx.qtt_basis_vector(d, col, device=CPU))
            expect = np.zeros(2 ** (d + 1))
            expect[2 * col] = 1.0
            expect[2 * col + 1] = 1.0
            assert np.allclose(out, expect)

    def test_linear_prolongation(self):
        d = 4
        u = np.random.default_rng(3).standard_normal(2 ** d)
        ju = ttnx.ttv_decomp(u.reshape((2,) * d))
        tu = tx.ttv_decomp(u.reshape((2,) * d), device=CPU)
        fine = vecs(ttnx.qtto_linear_prolongation(d) @ ju,
                    tx.qtto_linear_prolongation(d, device=CPU) @ tu)
        n = u.size
        expect = np.zeros(2 * n)
        for al in range(n):
            expect[2 * al] = u[al]
            expect[2 * al + 1] += 0.5 * u[al]
            if al + 1 < n:
                expect[2 * al + 1] += 0.5 * u[al + 1]
        assert np.allclose(fine, expect)

    def test_linear_prolongation_single_site(self):
        jm = _np(ttnx.qtto_to_matrix(ttnx.qtto_linear_prolongation(1)))
        tm = _np(tx.qtto_to_matrix(tx.qtto_linear_prolongation(
            1, device=CPU)))
        _agree(tm, jm)


def _kron_chain(mats_):
    out = mats_[0]
    for m in mats_[1:]:
        out = np.kron(out, m)
    return out


def _dense_pair_sum(P1, P2, d):
    H = np.zeros((2 ** d, 2 ** d), dtype=np.result_type(P1.dtype, P2.dtype))
    for i in range(d - 1):
        chain = [np.eye(2)] * d
        chain[i], chain[i + 1] = P1, P2
        H = H + _kron_chain(chain)
    return H


def _dense_field_sum(P, d):
    H = np.zeros((2 ** d, 2 ** d), dtype=P.dtype)
    for i in range(d):
        chain = [np.eye(2)] * d
        chain[i] = P
        H = H + _kron_chain(chain)
    return H


class TestSpinChains:
    def test_pauli_matrices(self):
        x, y, z = (tx.pauli_matrix(a) for a in "xyz")
        assert np.allclose(x @ x, np.eye(2))
        assert np.allclose(y @ y, np.eye(2))
        assert np.allclose(x @ y - y @ x, 2j * z)
        for a in "xyz":
            assert np.array_equal(tx.pauli_matrix(a), ttnx.pauli_matrix(a))

    @pytest.mark.parametrize("mu", ["x", "y", "z"])
    def test_pauli_sum(self, mu):
        d = 5
        H = mats(ttnx.pauli_sum_tto(mu, d), tx.pauli_sum_tto(mu, d,
                                                             device=CPU))
        assert np.allclose(H, _dense_field_sum(tx.pauli_matrix(mu), d))

    def test_pauli_sum_single_site(self):
        H = mats(ttnx.pauli_sum_tto("z", 1), tx.pauli_sum_tto("z", 1,
                                                              device=CPU))
        assert np.allclose(H, tx.pauli_matrix("z"))

    @pytest.mark.parametrize("pair", [("x", "x"), ("z", "z"), ("x", "z"),
                                      ("y", "y")])
    def test_pauli_pair_sum(self, pair):
        d = 4
        H = mats(ttnx.pauli_pair_sum_tto(*pair, d),
                 tx.pauli_pair_sum_tto(*pair, d, device=CPU))
        P1, P2 = (tx.pauli_matrix(a) for a in pair)
        assert np.allclose(H, _dense_pair_sum(P1, P2, d))

    def test_yy_real_trick(self):
        # the rank-3 YY MPO is real although sigma_y is complex
        assert not tx.pauli_pair_sum_tto("y", "y", 4, device=CPU).is_complex

    def test_heisenberg_xyz(self):
        d = 5
        jx, jy, jz, lam = 0.7, -0.3, 1.1, 0.25
        kw = dict(jx=jx, jy=jy, jz=jz, lam=lam, field="x")
        H = mats(ttnx.heisenberg_xyz_tto(d, **kw),
                 tx.heisenberg_xyz_tto(d, **kw, device=CPU))
        P = tx.pauli_matrix
        ref = (jx * _dense_pair_sum(P("x"), P("x"), d)
               + jy * _dense_pair_sum(P("y"), P("y"), d)
               + jz * _dense_pair_sum(P("z"), P("z"), d)
               + lam * _dense_field_sum(P("x"), d))
        assert np.allclose(H, ref)
        assert tx.heisenberg_xyz_tto(d, device=CPU).ranks == (1, 5, 5, 5, 5,
                                                              1)

    def test_derived_models(self):
        d = 4
        X, Y, Z = (tx.pauli_matrix(a) for a in "xyz")
        Hi = mats(ttnx.ising_tto(d, J=1.0, h=0.5),
                  tx.ising_tto(d, J=1.0, h=0.5, device=CPU))
        assert np.allclose(
            Hi, _dense_pair_sum(Z, Z, d) + 0.5 * _dense_field_sum(X, d))
        Hxxz = mats(ttnx.xxz_tto(d, J=1.0, delta=0.5),
                    tx.xxz_tto(d, J=1.0, delta=0.5, device=CPU))
        assert np.allclose(Hxxz, _dense_pair_sum(X, X, d)
                           + _dense_pair_sum(Y, Y, d)
                           + 0.5 * _dense_pair_sum(Z, Z, d))
        Hxxx = mats(ttnx.xxx_tto(d), tx.xxx_tto(d, device=CPU))
        assert np.allclose(Hxxx, _dense_pair_sum(X, X, d)
                           + _dense_pair_sum(Y, Y, d)
                           + _dense_pair_sum(Z, Z, d))
        Hxy = mats(ttnx.xy_tto(d, jx=0.3, jy=0.9),
                   tx.xy_tto(d, jx=0.3, jy=0.9, device=CPU))
        assert np.allclose(Hxy, 0.3 * _dense_pair_sum(X, X, d)
                           + 0.9 * _dense_pair_sum(Y, Y, d))


class TestQttLaplacian:
    def test_1d(self):
        bits = 5
        q = tx.qtt_laplacian(1, bits, bc="DD", device=CPU)
        m = mats(ttnx.qtt_laplacian(1, bits, bc="DD"), q)
        h = 1.0 / (2 ** bits - 1)
        assert np.allclose(m, tridiag(2 ** bits, 2, -1, -1) / h ** 2)
        assert isinstance(q, tx.QTTOperator)

    def test_2d_serial(self):
        bits = 3
        q = tx.qtt_laplacian(2, bits, ordering="serial", bc="DD", device=CPU)
        m = mats(ttnx.qtt_laplacian(2, bits, ordering="serial", bc="DD"), q)
        n = 2 ** bits
        lap1 = tridiag(n, 2, -1, -1) * (n - 1) ** 2
        assert np.allclose(m, np.kron(lap1, np.eye(n))
                           + np.kron(np.eye(n), lap1))
        assert q.ordering == "serial"
        assert q.n_dims == 2 and q.bits_per_dim == bits

    def test_2d_interleaved_matches_serial(self):
        # the swap network's SVD gauges differ between the packages: the
        # interleaved dense matrices agree to the reference's 1e-8
        bits = 4
        qs = tx.qtt_laplacian(2, bits, ordering="serial", bc="DN",
                              device=CPU)
        qi = tx.qtt_laplacian(2, bits, ordering="interleaved", bc="DN",
                              device=CPU)
        jqi = ttnx.qtt_laplacian(2, bits, ordering="interleaved", bc="DN")
        scale = float(np.max(np.abs(_np(tx.qtto_to_matrix(qs)))))
        _agree(_np(tx.qtto_to_matrix(qi)), _np(ttnx.qtto_to_matrix(jqi)),
               1e-8 / scale)
        back = t_qtt.reorder_op(qi, "serial")
        assert np.allclose(_np(tx.qtto_to_matrix(back)),
                           _np(tx.qtto_to_matrix(qs)), atol=1e-8)

    def test_nn_multidim_supported(self):
        # rank-1 NN boundaries allow n_dims > 1
        q = tx.qtt_laplacian(2, 4, ordering="serial", bc="NN", device=CPU)
        m = mats(ttnx.qtt_laplacian(2, 4, ordering="serial", bc="NN"), q)
        n = 2 ** 4
        lap1 = _bc_matrix(n, 1, 1) * (n - 1) ** 2
        assert np.allclose(m, np.kron(lap1, np.eye(n))
                           + np.kron(np.eye(n), lap1))

    def test_validates(self):
        for kw in (dict(ordering="weird"), dict(bc="PP")):
            with pytest.raises(ValueError):
                tx.qtt_laplacian(2, 4, device=CPU, **kw)
        with pytest.raises(ValueError):
            tx.qtt_laplacian(0, 4, device=CPU)


# ---------------------------------------------------------------------------
# Grids, encodings and splitting (tests/test_ops_qtt.py)
# ---------------------------------------------------------------------------


class TestGrids:
    def test_index_maps(self):
        assert tx.index_to_point([0, 0, 0]) == 0.0
        assert tx.index_to_point([1, 1, 1]) == 1.0
        assert np.isclose(tx.index_to_point([1, 0, 0]), 4 / 7)
        assert tx.tuple_to_index([1, 0, 1]) == 5
        for bits in ([0, 1, 1, 0], [1, 1, 0, 1, 0]):
            assert tx.index_to_point(bits) == ttnx.index_to_point(bits)
            assert tx.tuple_to_index(bits) == ttnx.tuple_to_index(bits)

    def test_gauss_chebyshev_lobatto(self):
        x, w = tx.gauss_chebyshev_lobatto(5, shifted=True)
        assert np.isclose(x[0], 1.0) and np.isclose(x[-1], 0.0)
        assert np.all((0 <= x) & (x <= 1))
        assert w[0] == w[-1]
        for shifted in (True, False):
            for a, b in zip(tx.gauss_chebyshev_lobatto(9, shifted),
                            ttnx.gauss_chebyshev_lobatto(9, shifted)):
                assert np.array_equal(a, b)

    def test_tensor_to_grid_is_reshape(self):
        t = np.arange(8).reshape(2, 2, 2)
        assert np.array_equal(_np(tx.tensor_to_grid(t)), np.arange(8))
        assert np.array_equal(_np(tx.tensor_to_grid(torch.as_tensor(t))),
                              _np(ttnx.tensor_to_grid(t)))


class TestEncodings:
    @pytest.mark.parametrize("d", [2, 3, 6])
    def test_qtt_sin(self, d):
        v = vecs(ttnx.qtt_sin(d, lam=2.0), tx.qtt_sin(d, lam=2.0,
                                                      device=CPU))
        assert np.allclose(v, np.sin(2.0 * np.pi * grid(d)), atol=1e-12)

    def test_qtt_sin_interval(self):
        d, a, b = 5, -1.0, 2.0
        v = vecs(ttnx.qtt_sin(d, a=a, b=b, lam=0.7),
                 tx.qtt_sin(d, a=a, b=b, lam=0.7, device=CPU))
        assert np.allclose(v, np.sin(0.7 * np.pi * (a + (b - a) * grid(d))),
                           atol=1e-12)

    @pytest.mark.parametrize("d", [2, 3, 6])
    def test_qtt_cos(self, d):
        v = vecs(ttnx.qtt_cos(d, lam=3.0), tx.qtt_cos(d, lam=3.0,
                                                      device=CPU))
        assert np.allclose(v, np.cos(3.0 * np.pi * grid(d)), atol=1e-12)

    def test_qtt_exp(self):
        d = 6
        v = vecs(ttnx.qtt_exp(d, alpha=1.3, beta=-0.2),
                 tx.qtt_exp(d, alpha=1.3, beta=-0.2, device=CPU))
        assert np.allclose(v, np.exp(1.3 * grid(d) - 0.2), atol=1e-12)

    def test_qtt_polynom(self):
        d = 6
        coef = [1.0, -2.0, 0.5, 3.0]  # 1 - 2x + 0.5x^2 + 3x^3
        v = vecs(ttnx.qtt_polynom(coef, d), tx.qtt_polynom(coef, d,
                                                           device=CPU))
        x = grid(d)
        assert np.allclose(v, coef[0] + coef[1] * x + coef[2] * x ** 2
                           + coef[3] * x ** 3, atol=1e-12)

    def test_qtt_polynom_interval(self):
        d, coef, a, b = 5, [0.0, 1.0, 1.0], 1.0, 3.0
        x = a + (b - a) * grid(d)
        v = vecs(ttnx.qtt_polynom(coef, d, a=a, b=b),
                 tx.qtt_polynom(coef, d, a=a, b=b, device=CPU))
        assert np.allclose(v, x + x ** 2, atol=1e-11)

    def test_qtt_chebyshev(self):
        d, n = 6, 4
        v = vecs(ttnx.qtt_chebyshev(n, d), tx.qtt_chebyshev(n, d,
                                                            device=CPU))
        x_nodes, _ = tx.gauss_chebyshev_lobatto(2 ** d, shifted=True)
        theta = np.arccos(np.clip(2 * x_nodes - 1, -1, 1))
        assert np.allclose(v, np.cos(n * theta), atol=1e-12)

    def test_qtt_basis_vector(self):
        d = 4
        for pos in [0, 5, 15]:
            v = vecs(ttnx.qtt_basis_vector(d, pos, val=2.5),
                     tx.qtt_basis_vector(d, pos, val=2.5, device=CPU))
            e = np.zeros(16)
            e[pos] = 2.5
            assert np.allclose(v, e)

    def test_qtt_trapezoidal(self):
        d = 4
        v = vecs(ttnx.qtt_trapezoidal(d), tx.qtt_trapezoidal(d, device=CPU))
        assert np.allclose(v, np.ones(16) / (2 ** d - 1))

    def test_function_to_qtt(self):
        d = 6

        def f(x):
            return np.sin(np.pi * x) * np.exp(x)

        v = vecs(ttnx.function_to_qtt(f, d), tx.function_to_qtt(f, d,
                                                                device=CPU))
        assert np.allclose(v, f(grid(d)), atol=1e-12)
        assert tx.function_to_qtt(f, d, device=CPU).ranks \
            == ttnx.function_to_qtt(f, d).ranks
        _agree(_np(tx.function_to_tensor(f, d, device=CPU)),
               _np(ttnx.function_to_tensor(f, d)))

    def test_function_to_qtt_scalar_f(self):
        # a function of one float (not vectorized) takes the loop
        d = 4

        def f(x):
            return float(np.cos(x)) if np.ndim(x) == 0 else None

        vecs(ttnx.function_to_qtt(f, d), tx.function_to_qtt(f, d,
                                                            device=CPU))

    def test_function_to_qtt_uniform(self):
        # little-endian encoding: the big-endian read-out returns the grid
        # values bit-reversed
        d = 5

        def f(x):
            return x ** 2

        t = tx.function_to_qtt_uniform(f, d, device=CPU)
        v = vecs(ttnx.function_to_qtt_uniform(f, d), t)
        xs = np.arange(2 ** d) / 2 ** d
        assert np.allclose(v, (xs ** 2)[bitrev_perm(d)], atol=1e-12)
        assert np.allclose(_np(tx.qtt_to_function(t)), v)


class TestSplitting:
    def test_to_qtt_round_trip(self, rng):
        a = rng.standard_normal((4, 8))
        qtt = tx.to_qtt(tx.ttv_decomp(a, device=CPU), [[2, 2], [2, 2, 2]])
        jqtt = ttnx.to_qtt(ttnx.ttv_decomp(a), [[2, 2], [2, 2, 2]])
        assert qtt.dims == (2, 2, 2, 2, 2) and qtt.ranks == jqtt.ranks
        merged = tx.to_ttv(qtt, [2, 3])
        assert np.allclose(_np(tx.ttv_to_tensor(merged)), a)
        # big-endian: the flattened values agree with the original C order
        _agree(_np(tx.ttv_to_tensor(qtt)).reshape(-1), a.reshape(-1))

    def test_to_qtt_threshold(self, rng):
        cores = rand_cores(rng, (4, 4, 4), 2)
        jx, x = both(cores)
        q = tx.to_qtt(x, [[2, 2]] * 3, threshold=1e-13)
        assert q.ranks == ttnx.to_qtt(jx, [[2, 2]] * 3,
                                      threshold=1e-13).ranks
        back = tx.to_ttv(q, [2, 2, 2])
        _agree(_np(tx.ttv_to_tensor(back)), _np(ttnx.ttv_to_tensor(jx)))

    def test_to_qtt_validates(self, rng):
        x = both(rand_cores(rng, (4, 4), 2))[1]
        with pytest.raises(ValueError):
            tx.to_qtt(x, [[2, 2]])
        with pytest.raises(ValueError):
            tx.to_qtt(x, [[2, 3], [2, 2]])
        with pytest.raises(ValueError):
            tx.to_ttv(x, [3])


# ---------------------------------------------------------------------------
# Fourier (tests/test_fourier.py)
# ---------------------------------------------------------------------------


def test_dft_matrix_small():
    # F = W @ P_bitrev with W = (1/sqrt(N)) exp(-2i pi k n / N)
    d = 4
    N = 2 ** d
    F = mats(ttnx.fourier_qtto(d, K=25), tx.fourier_qtto(d, K=25, device=CPU))
    k = np.arange(N)
    W = np.exp(-2j * np.pi * np.outer(k, k) / N) / np.sqrt(N)
    assert np.linalg.norm(F[:, bitrev_perm(d)] - W) / np.linalg.norm(W) \
        < 1e-10


def test_dft_unitary_and_conjugate_sign():
    d = 5
    N = 2 ** d
    Fm = mats(ttnx.fourier_qtto(d, sign=-1.0),
              tx.fourier_qtto(d, sign=-1.0, device=CPU))
    Fp = mats(ttnx.fourier_qtto(d, sign=1.0),
              tx.fourier_qtto(d, sign=1.0, device=CPU))
    assert np.linalg.norm(Fm.conj().T @ Fm - np.eye(N)) < 1e-8
    assert np.linalg.norm(Fp - Fm.conj()) < 1e-10


def test_dft_spectral_recovery():
    # d = 10, K = 50: the little-endian uniform encoding in, the spectrum
    # read plainly out
    d, K, r = 10, 50, 12
    N = 2 ** d
    rng = np.random.default_rng(1234)
    coeffs = rng.standard_normal(r) + 1j * rng.standard_normal(r)

    def f(x):
        x = np.atleast_1d(x)
        return (coeffs[None, :] * np.exp(2j * np.pi * np.arange(r)[None, :]
                                         * x[:, None])).sum(1)

    F = tx.fourier_qtto(d, K=K, sign=-1.0, normalize=True, device=CPU)
    y = tt_compress(F @ tx.function_to_qtt_uniform(f, d, device=CPU),
                       100)
    jF = ttnx.fourier_qtto(d, K=K, sign=-1.0, normalize=True)
    jy = ttnx.tt_compress(jF @ ttnx.function_to_qtt_uniform(f, d), 100)
    spec = vecs(jy, y, 1e-10)
    scale = np.sqrt(N)
    assert np.linalg.norm(spec[:r] - scale * coeffs) / (
        scale * np.linalg.norm(coeffs)) < 1e-8
    assert np.linalg.norm(spec[r:]) / np.linalg.norm(spec) < 1e-10


def test_dft_rank():
    K = 12
    F = tx.fourier_qtto(6, K=K, device=CPU)
    assert max(F.ranks) == K + 1 and F.ranks == ttnx.fourier_qtto(6,
                                                                  K=K).ranks
    assert F.dtype == torch.complex128


def test_dft_single_site():
    mats(ttnx.fourier_qtto(1, K=4), tx.fourier_qtto(1, K=4, device=CPU))
    with pytest.raises(ValueError):
        tx.fourier_qtto(0, device=CPU)


def test_reverse_qtt_bits():
    d = 4
    u = np.random.default_rng(0).standard_normal(2 ** d)
    rev = tx.reverse_qtt_bits(tx.ttv_decomp(u.reshape((2,) * d), device=CPU))
    v = vecs(ttnx.reverse_qtt_bits(ttnx.ttv_decomp(u.reshape((2,) * d))),
             rev)
    # site reversal = the bit-reversal permutation of the grid index
    assert np.allclose(v, u[bitrev_perm(d)])


def test_uniform_sampler_is_little_endian():
    d = 3
    v = vecs(ttnx.function_to_qtt_uniform(lambda x: x, d),
             tx.function_to_qtt_uniform(lambda x: x, d, device=CPU))
    assert np.allclose(v, (np.arange(8) / 8)[bitrev_perm(d)])


def test_single_frequency_spike():
    d = 6

    def f(x):
        return np.exp(2j * np.pi * 3 * x)

    spec = vecs(ttnx.fourier_qtto(d, K=25) @ ttnx.function_to_qtt_uniform(
        f, d), tx.fourier_qtto(d, K=25, device=CPU)
        @ tx.function_to_qtt_uniform(f, d, device=CPU))
    expect = np.zeros(2 ** d, dtype=complex)
    expect[3] = np.sqrt(2.0 ** d)
    assert np.linalg.norm(spec - expect) < 1e-8


def test_lagrange_helpers_match():
    from ttnx.ops.fourier import _lagrange_eval_matrix as j_lagrange

    for K in (4, 25):
        grid_t, w_t = t_fourier.cheb_lobatto_lagrange(K)
        grid_j, w_j = ttnx.ops.fourier.cheb_lobatto_lagrange(K)
        assert np.array_equal(grid_t, grid_j) and np.array_equal(w_t, w_j)
        xs = np.concatenate([grid_t[:3], np.linspace(0, 1, 7)])
        assert np.array_equal(t_fourier._lagrange_eval_matrix(grid_t, w_t, xs),
                              j_lagrange(grid_j, w_j, xs))


# ---------------------------------------------------------------------------
# Interpolation (tests/test_interpolation.py)
# ---------------------------------------------------------------------------


class TestInterpolation:
    def test_1d_structure(self):
        numbits, N = 8, 5
        tt = tx.interpolating_qtt(lambda x: np.sin(2 * np.pi * x), numbits,
                                  N, device=CPU)
        assert tt.N == numbits
        assert tt.ranks[0] == 1 and tt.ranks[-1] == 1
        assert all(d == 2 for d in tt.dims)
        assert max(tt.ranks) == N
        for k, c in enumerate(tt.cores):
            assert tuple(c.shape) == (tt.ranks[k], 2, tt.ranks[k + 1])

    def test_validation(self):
        with pytest.raises(ValueError):
            tx.interpolating_qtt(np.sin, 1, 4, device=CPU)
        with pytest.raises(ValueError):
            tx.interpolating_qtt(np.sin, 4, 1, device=CPU)

    def test_1d_value_correctness(self):
        numbits, N = 8, 16

        def f(x):
            return np.sin(2 * np.pi * x)

        tt = tx.interpolating_qtt(f, numbits, N, device=CPU)
        vals = _np(tx.ttv_to_tensor(tt)).reshape(-1)
        _agree(vals, _np(ttnx.qtt_to_vector(ttnx.interpolating_qtt(
            f, numbits, N))))
        xs = np.arange(2 ** numbits) / 2 ** numbits
        assert np.max(np.abs(vals - f(xs))) < 1e-10

    def test_interval_scaling(self):
        numbits, N, a, b = 7, 14, -2.0, 3.0

        def f(x):
            return np.exp(-x) + x ** 2

        tt = tx.interpolating_qtt(f, numbits, N, a=a, b=b, device=CPU)
        vals = _np(tx.ttv_to_tensor(tt)).reshape(-1)
        _agree(vals, _np(ttnx.qtt_to_vector(ttnx.interpolating_qtt(
            f, numbits, N, a=a, b=b))))
        xs = a + (b - a) * np.arange(2 ** numbits) / 2 ** numbits
        assert np.max(np.abs(vals - f(xs))) < 1e-9

    def test_rank_revealing_compresses_polynomial(self):
        # a degree-3 polynomial has exact QTT rank 4: the full-rank N = 12
        # cascade rounds down to it with no loss of accuracy
        numbits = 8

        def f(x):
            return 1.0 + x - 2 * x ** 2 + 0.5 * x ** 3

        tt = tx.lagrange_rank_revealing(f, numbits, 12, rel_tol=1e-12,
                                        device=CPU)
        jtt = ttnx.lagrange_rank_revealing(f, numbits, 12, rel_tol=1e-12)
        assert max(tt.ranks) <= 4 and tt.ranks == jtt.ranks
        vals = _np(tx.ttv_to_tensor(tt)).reshape(-1)
        _agree(vals, _np(ttnx.qtt_to_vector(jtt)), 1e-10)
        xs = np.arange(2 ** numbits) / 2 ** numbits
        assert np.max(np.abs(vals - f(xs))) < 1e-10

    def test_max_bond_cap(self):
        def f(x):
            return np.cos(20 * x)

        tt = tx.lagrange_rank_revealing(f, 8, 14, rel_tol=0.0, max_bond=3,
                                        device=CPU)
        assert max(tt.ranks) <= 3
        _agree(_np(tx.qtt_to_vector(tt)), _np(ttnx.qtt_to_vector(
            ttnx.lagrange_rank_revealing(f, 8, 14, rel_tol=0.0,
                                         max_bond=3))), 1e-10)
