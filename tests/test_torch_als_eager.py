"""The eager ALS tier of ttnx_torch (``solvers/als.py``) against ttnx on the
CPU, in float64.

Mirrors tests/test_als.py (the environments, the linear solve, the
eigensolve with its rank schedule, the generalized eigensolve and the
warm-start lock of the scan tier) and adds the pieces the reference tests
reach only inside the drivers: the local operators one by one, the LOBPCG
branch (real and through the complex embedding), a pencil with a
non-trivial metric and the dtype rule. Inputs are numpy arrays from seeds
(or ttnx's deterministic constructors), fed to both packages through
``ttnx_torch.utils.convert``. Tolerances: port against ttnx 1e-10 with
dense local solves and 1e-8 on energies through LOBPCG; each package
against the dense spectrum at the reference test's own tolerance. States
are compared as dense vectors up to sign (QR and eigh signs are a gauge),
never as raw cores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import ttnx
from ttnx.core.tt import TTOperator as JOp
from ttnx.core.tt import TTVector as JVec
from ttnx.solvers import als as ja

import ttnx_torch as tx
from ttnx_torch.solvers import als as ta
from ttnx_torch.utils.convert import ttoperator_from_numpy, ttvector_from_numpy

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread while this module runs: its
    many small factorizations beside the other test workers otherwise
    spin threads against each other."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(saved)


def vec(tt):
    if isinstance(tt, JVec):
        return np.asarray(ttnx.ttv_to_tensor(tt)).reshape(-1)
    return tx.ttv_to_tensor(tt).reshape(-1).numpy()


def mat(j_op):
    return np.asarray(ttnx.qtto_to_matrix(j_op))


def rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def close_up_to_sign(got, ref, tol):
    err = min(np.linalg.norm(got - ref), np.linalg.norm(got + ref))
    assert err <= tol * np.linalg.norm(ref), err


def rand_cores(rng, d, r, orthogonal=False, complex_=False):
    """Normalized random TT cores (numpy), left-orthonormal when
    ``orthogonal``, as ``rand_tt(..., normalise=True)`` builds them."""
    rks = ttnx.r_and_d_to_rks([1] + [r] * (d - 1) + [1], (2,) * d, rmax=r)
    cores = []
    for k in range(d):
        shape = (rks[k], 2, rks[k + 1])
        c = rng.standard_normal(shape)
        if complex_:
            c = c + 1j * rng.standard_normal(shape)
        c = c / np.sqrt(2 * rks[k + 1])
        if orthogonal:
            q, _ = np.linalg.qr(c.reshape(rks[k] * 2, rks[k + 1]))
            c = q.reshape(rks[k], 2, -1)
        cores.append(c)
    return cores


def both(obj):
    """``(ttnx object, port copy)`` of a ttnx TT or of numpy cores."""
    if isinstance(obj, JOp):
        return obj, ttoperator_from_numpy([np.array(c) for c in obj.cores],
                                          device=CPU)
    if isinstance(obj, JVec):
        return obj, ttvector_from_numpy([np.array(c) for c in obj.cores],
                                        device=CPU)
    return (JVec([jnp.asarray(c) for c in obj]),
            ttvector_from_numpy(obj, device=CPU))


# ---------------------------------------------------------------------------
# Environments and local operators
# ---------------------------------------------------------------------------


def test_right_env_shapes(rng):
    d = 4
    _, A = both(ttnx.heisenberg_xyz_tto(d))
    _, x = both(rand_cores(rng, d, 2))
    R = ta.init_right_envs(x, A)
    for i in range(1, d):
        assert R[i].shape == (x.ranks[i], A.ranks[i], x.ranks[i])


def test_local_matrix_symmetric_for_symmetric_A(rng):
    d = 4
    _, A = both(ttnx.laplacian(d))
    _, x = both(rand_cores(rng, d, 2))
    x = tx.orthogonalize(x, 0)
    R = ta.init_right_envs(x, A)
    K = ta.local_matrix(torch.ones((1, 1, 1), dtype=torch.float64),
                        A.cores[0], R[1]).numpy()
    assert np.allclose(K, K.T, atol=1e-12)


@pytest.mark.parametrize("complex_", [False, True])
def test_env_updates_and_local_operators_match_ttnx(rng, complex_):
    """Every environment update, the dense local matrix, the local rhs and
    the matrix-free local product, on random cores (1e-12)."""
    r, ra, rb = 3, 4, 2
    dt = np.complex128 if complex_ else np.float64

    def arr(*shape):
        a = rng.standard_normal(shape)
        return (a + 1j * rng.standard_normal(shape)).astype(dt) if complex_ \
            else a

    xc, Ac, bc = arr(r, 2, r), arr(ra, 2, 2, ra), arr(rb, 2, rb)
    L, R, V = arr(r, ra, r), arr(r, ra, r), arr(r, 2, r)
    Lb, Rb = arr(r, rb), arr(r, rb)
    pairs = [
        (ja.update_left_env(L, xc, Ac), ta.update_left_env, (L, xc, Ac)),
        (ja.update_right_env(R, xc, Ac), ta.update_right_env, (R, xc, Ac)),
        (ja.update_left_env_b(Lb, xc, bc), ta.update_left_env_b,
         (Lb, xc, bc)),
        (ja.update_right_env_b(Rb, xc, bc), ta.update_right_env_b,
         (Rb, xc, bc)),
        (ja.local_matrix(L, Ac, R), ta.local_matrix, (L, Ac, R)),
        (ja.local_rhs(Lb, bc, Rb), ta.local_rhs, (Lb, bc, Rb)),
        (ja.local_matvec(L, Ac, R, V), ta.local_matvec, (L, Ac, R, V)),
    ]
    for ref, fn, args in pairs:
        got = fn(*[torch.as_tensor(a) for a in args]).numpy()
        assert got.shape == np.asarray(ref).shape
        assert np.abs(got - np.asarray(ref)).max() <= 1e-12 * np.abs(
            np.asarray(ref)).max()


# ---------------------------------------------------------------------------
# Linear solve
# ---------------------------------------------------------------------------


def test_readme_quickstart(rng):
    """README quick-start #3: d = 6, A = I, b = qtt_sin, 4 sweeps."""
    d = 6
    jA, A = both(ttnx.id_tto(d))
    jb, b = both(ttnx.qtt_sin(d))
    jx0, x0 = both(rand_cores(rng, d, 4))
    x = ta.als_linsolve(A, b, x0, sweep_count=4)
    assert rel(vec(x), vec(b)) < 1e-12
    assert rel(vec(x), vec(ja.als_linsolve(jA, jb, jx0, sweep_count=4))) \
        < 1e-10


def _laplace_system(rng, d=5, r=6):
    jA, A = both(ttnx.laplacian(d))
    u = np.asarray(ttnx.qtt_to_vector(ttnx.function_to_qtt(
        lambda x: np.sin(np.pi * x), d)))
    jb, b = both(ttnx.ttv_decomp((mat(jA) @ u).reshape((2,) * d),
                                 tol=1e-14))
    jx0, x0 = both(rand_cores(rng, d, r))
    return (jA, jb, jx0), (A, b, x0), u


def dense_residual(jA, x, jb):
    return rel(mat(jA) @ vec(x), vec(jb))


def test_laplacian_system(rng):
    (jA, jb, jx0), (A, b, x0), u = _laplace_system(rng)
    x, info = ta.als_linsolve(A, b, x0, sweep_count=6, return_info=True)
    xj, info_j = ja.als_linsolve(jA, jb, jx0, sweep_count=6,
                                 return_info=True)
    # a TT residual norm resolves only to sqrt(eps) |A x|, so the returned
    # ones are held to that floor and the dense residual to 1e-9
    assert info["residual"] < 1e-6 and info_j["residual"] < 1e-6
    assert dense_residual(jA, x, jb) < 1e-9
    assert rel(vec(x), u) < 1e-8
    assert rel(vec(x), vec(xj)) < 1e-10
    assert x.ranks == xj.ranks


@pytest.mark.parametrize("sweeps", [1, 3, 6])
def test_residual_decreases_with_sweeps(rng, sweeps):
    """Odd counts end after a forward half sweep, as in ttnx."""
    (jA, jb, jx0), (A, b, x0), _ = _laplace_system(rng, r=5)
    x1 = ta.als_linsolve(A, b, x0, sweep_count=1)
    x = ta.als_linsolve(A, b, x0, sweep_count=sweeps)
    # one forward half sweep already reaches rounding level at d = 5
    assert dense_residual(jA, x, jb) <= max(dense_residual(jA, x1, jb),
                                            1e-12)
    xj = ja.als_linsolve(jA, jb, jx0, sweep_count=sweeps)
    assert rel(vec(x), vec(xj)) < 1e-10


def test_complex_rhs(rng):
    d = 4
    jA, A = both(ttnx.id_tto(d).astype(jnp.complex128))
    jb, b = both(rand_cores(rng, d, 2, complex_=True))
    jx0, x0 = both([c.astype(np.complex128)
                    for c in rand_cores(rng, d, 4)])
    x = ta.als_linsolve(A, b, x0, sweep_count=4)
    assert x.dtype == torch.complex128
    assert np.allclose(vec(x), vec(b), atol=1e-10)
    assert rel(vec(x), vec(ja.als_linsolve(jA, jb, jx0, sweep_count=4))) \
        < 1e-10


@pytest.mark.parametrize("dtypes,want", [
    ((torch.float32, torch.float32, torch.float32), torch.float32),
    ((torch.float32, torch.float64, torch.float32), torch.float64),
    ((torch.float64, torch.float32, torch.complex64), torch.complex128),
])
def test_dtype_follows_result_type(rng, dtypes, want):
    """The solve runs in ``jnp.result_type`` of A, b and x0 under x64:
    float32 stays float32."""
    d = 4
    _, A = both(ttnx.laplacian(d))
    _, b = both(ttnx.qtt_sin(d))
    _, x0 = both(rand_cores(rng, d, 2))
    A, b, x0 = (t.astype(dt) for t, dt in zip((A, b, x0), dtypes))
    assert ta.als_linsolve(A, b, x0).dtype == want
    assert ta.als_eigsolve(A, x0)[1].dtype == torch.promote_types(
        dtypes[0], dtypes[2])


# ---------------------------------------------------------------------------
# Eigensolve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op,r,sweeps,tol", [
    ("laplacian", 6, 4, 1e-10), ("heisenberg", 8, 6, 1e-8)])
def test_ground_state(rng, op, r, sweeps, tol):
    d = 6
    j_op = ttnx.laplacian(d) if op == "laplacian" else \
        ttnx.heisenberg_xyz_tto(d, jx=1.0, jy=1.0, jz=1.0)
    jA, A = both(j_op)
    jx0, x0 = both(rand_cores(rng, d, r, orthogonal=True))
    E, x = ta.als_eigsolve(A, x0, sweep_schedule=[sweeps])
    Ej, xj = ja.als_eigsolve(jA, jx0, sweep_schedule=[sweeps])
    w0 = np.linalg.eigvalsh(mat(jA))[0]
    assert abs(E[-1] - w0) < tol
    # eigenvalue history is non-increasing (variational)
    assert all(E[i + 1] <= E[i] + 1e-10 for i in range(len(E) - 1))
    # a local K with a degenerate lowest eigenvalue lets the two eigh pick
    # different vectors mid-history: the ends are compared
    assert abs(E[-1] - Ej[-1]) <= 1e-10 * abs(w0)
    close_up_to_sign(vec(x), vec(xj), 1e-8)


def test_rank_schedule(rng):
    """Rank growth by zero padding matches ttnx; with noise (a
    ``torch.Generator`` here, a PRNG key there) each reaches the ground
    energy."""
    d = 6
    jA, A = both(ttnx.laplacian(d))
    jx0, x0 = both(rand_cores(rng, d, 2, orthogonal=True))
    w0 = np.linalg.eigvalsh(mat(jA))[0]
    kw = dict(sweep_schedule=[2, 4], rmax_schedule=[2, 6])
    E, x = ta.als_eigsolve(A, x0, noise_schedule=[0.0, 0.0], **kw)
    Ej, _ = ja.als_eigsolve(jA, jx0, noise_schedule=[0.0, 0.0], **kw)
    assert max(x.ranks) <= 6 and len(E) == len(Ej)
    assert abs(E[-1] - Ej[-1]) <= 1e-10 * abs(w0)
    E, x = ta.als_eigsolve(A, x0, noise_schedule=[0.0, 1e-6],
                           generator=torch.Generator().manual_seed(1), **kw)
    assert max(x.ranks) <= 6 and abs(E[-1] - w0) < 1e-8


def test_schedule_validation(rng):
    _, A = both(ttnx.laplacian(4))
    _, x0 = both(rand_cores(rng, 4, 2))
    with pytest.raises(ValueError):
        ta.als_eigsolve(A, x0, sweep_schedule=[2, 3], rmax_schedule=[2])
    with pytest.raises(ValueError):  # noise without a generator
        ta.als_eigsolve(A, x0, sweep_schedule=[1, 2], rmax_schedule=[2, 4],
                        noise_schedule=[0.0, 1e-3])


@pytest.mark.parametrize("complex_", [False, True])
def test_lobpcg_branch(rng, complex_):
    """``it_solver=True`` above ``itslv_thresh`` takes LOBPCG (complex
    Hermitian through the real embedding); energies 1e-8 from ttnx's
    ``lobpcg_standard`` and from the port's dense-``eigh`` sweeps (rank 4
    does not reach the chain's ground state)."""
    d = 6
    j_op = ttnx.heisenberg_xyz_tto(d, jx=1.0, jy=0.7, jz=0.4)
    if complex_:
        j_op = j_op.astype(jnp.complex128)
    jA, A = both(j_op)
    cores = rand_cores(rng, d, 4, orthogonal=True)
    if complex_:
        cores = [c.astype(np.complex128) for c in cores]
    jx0, x0 = both(cores)
    kw = dict(sweep_schedule=[4], it_solver=True, itslv_thresh=8,
              maxiter=200, linsolv_tol=1e-10)
    E, x = ta.als_eigsolve(A, x0, **kw)
    Ej, xj = ja.als_eigsolve(jA, jx0, **kw)
    E_dense, _ = ta.als_eigsolve(A, x0, sweep_schedule=[4])
    assert np.abs(E - Ej).max() <= 1e-8 * abs(E[-1])
    assert abs(E[-1] - E_dense[-1]) <= 1e-8 * abs(E[-1])
    v, vj = vec(x), vec(xj)
    overlap = abs(np.vdot(v, vj)) / (np.linalg.norm(v) * np.linalg.norm(vj))
    assert overlap >= 1 - 1e-8


def test_lobpcg_port_matches_jax(rng):
    """``core.linalg.lobpcg_standard`` is JAX's: same iteration count, same
    eigenpair (1e-10), on a shifted random symmetric matrix."""
    from jax.experimental.sparse.linalg import lobpcg_standard
    from ttnx_torch.core.linalg import lobpcg_standard as port

    m = 120
    G = rng.standard_normal((m, m))
    K = 0.5 * (G + G.T) + np.diag(np.linspace(0.0, 4.0, m))
    S = np.abs(K).sum(0).max() * np.eye(m) - K
    X = rng.standard_normal((m, 1))
    th, U, it = lobpcg_standard(jnp.asarray(S), jnp.asarray(X), m=100,
                                tol=1e-9)
    th2, U2, it2 = port(torch.as_tensor(S), torch.as_tensor(X), m=100,
                        tol=1e-9)
    assert int(it) == it2
    assert abs(float(th[0]) - float(th2[0])) <= 1e-10 * abs(float(th[0]))
    close_up_to_sign(U2[:, 0].numpy(), np.asarray(U)[:, 0], 1e-8)


# ---------------------------------------------------------------------------
# Generalized eigensolve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric,d", [("identity", 5), ("scaled", 4),
                                      ("laplacian", 4)])
def test_gen_eigsolve(rng, metric, d):
    """``A x = lambda S x`` with S = I (the eigensolve), 2 I (E0 / 2) and
    I + 0.1 laplacian (against scipy's dense pencil); the Cholesky
    reduction on the device against ttnx's host scipy.linalg.eigh."""
    import scipy.linalg

    jA, A = both(ttnx.laplacian(d))
    j_S = {"identity": ttnx.id_tto(d), "scaled": 2.0 * ttnx.id_tto(d),
           "laplacian": ttnx.id_tto(d) + 0.1 * ttnx.laplacian(d)}[metric]
    jS, S = both(j_S)
    jx0, x0 = both(rand_cores(rng, d, 4, orthogonal=True))
    E, x = ta.als_gen_eigsolv(A, S, x0, sweep_schedule=[4])
    Ej, xj = ja.als_gen_eigsolv(jA, jS, jx0, sweep_schedule=[4])
    w0 = scipy.linalg.eigh(mat(jA), mat(jS), eigvals_only=True)[0]
    assert abs(E[-1] - w0) < 1e-8
    assert np.abs(E - Ej).max() <= 1e-10 * abs(w0)
    close_up_to_sign(vec(x), vec(xj), 1e-8)


def test_gen_eigmin_normalization(rng):
    """The local pencil's eigenvector has ``x^H S x = 1`` and its
    eigenvalue is scipy's (1e-12), on one site with trivial environments."""
    import scipy.linalg

    m = 12
    G, H = rng.standard_normal((m, m)), rng.standard_normal((m, m))
    K, S = G + G.T, H @ H.T + m * np.eye(m)
    one = torch.ones((1, 1, 1), dtype=torch.float64)
    lam, x = ta._local_gen_eigmin(
        one, torch.as_tensor(K).reshape(1, m, m, 1), one, one,
        torch.as_tensor(S).reshape(1, m, m, 1), one,
        torch.zeros((1, m, 1), dtype=torch.float64))
    xs = x.reshape(-1).numpy()
    assert abs(xs @ S @ xs - 1.0) <= 1e-12
    assert abs(lam - scipy.linalg.eigh(K, S, eigvals_only=True)[0]) <= 1e-12


# ---------------------------------------------------------------------------
# The scan tier's warm-start lock (tests/test_als.py:169)
# ---------------------------------------------------------------------------


def test_warm_started_cg_halves_iterations():
    """Every scan-ALS local CG starts from the transported current iterate,
    so ``cg_iters=12`` matches the direct 'lu' solve to 1e-9."""
    from ttnx_torch.solvers.als_scan import (als_sweeps, pack_op, pack_tt,
                                             rank_masks, unpack_tt)

    d, rmax = 6, 8
    hg = 1.0 / (2 ** d + 1)
    A = (-1.0 / hg ** 2) * tx.toeplitz_to_qtto(2.0, -1.0, -1.0, d,
                                               device=CPU)
    lhs = tx.add_op(tx.id_tto(d, device=CPU), tx.scale_op(-5e-7, A))
    lhs_stack = pack_op(lhs, max(lhs.ranks))
    u_rks = tx.r_and_d_to_rks((1,) + (rmax,) * (d - 1) + (1,), (2,) * d,
                              rmax=rmax)
    masks = rank_masks(u_rks, rmax, device=CPU)
    b = pack_tt(tx.qtt_sin(d, a=hg, b=1 - hg, device=CPU), rmax)

    def dense(stack):
        return vec(unpack_tt(stack, u_rks))

    ref = dense(als_sweeps(lhs_stack, b, b, masks, 2, solver="lu"))
    warm12 = dense(als_sweeps(lhs_stack, b, b, masks, 2, solver="cg",
                              cg_iters=12))
    assert rel(warm12, ref) < 1e-9
