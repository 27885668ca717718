"""The device cross of ttnx_torch (``cross/device.py``) against ttnx on the
CPU, in float64.

Mirrors tests/test_cross_device.py except its ``TestRemoteSafeInverse``
and ``TestGramSVDSubstitute``, which test TPU-only forms the port leaves
behind. ttnx draws its starting index sets from a JAX key, which torch
cannot reproduce, so the parity tests replay ttnx's key splits in JAX and
feed the same sets to the port's sweep functions (``_maxvol_sweeps``,
``_dmrg_sweeps``). Tolerances: maxvol rows identical; TT evaluation 1e-12;
the sweeps' dense tensors and validation histories 1e-10 of ttnx's; the
accuracy contracts as in the reference tests (separable Gaussian 1e-8,
Wishart rel-L2 1e-4); a batched run equal to per-problem runs fed the same
sets to 1e-10; a complex function through the DMRG cross to 1e-8 (ROADMAP
C.9, held against the function, not against ttnx).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from ttnx.core.decomp import ttv_to_tensor as j_dense
from ttnx.cross import device as jd
from ttnx.cross.cross import _evaluate_tt

from ttnx_torch.core.decomp import ttv_to_tensor
from ttnx_torch.cross import device as td

CPU = torch.device("cpu")

SIGMA = 2 * np.array([
    [1.0, 0.3, 0.2, 0.1, 0.18],
    [0.3, 1.2, 0.25, 0.15, 0.22],
    [0.2, 0.25, 0.9, 0.2, 0.28],
    [0.1, 0.15, 0.2, 1.1, 0.19],
    [0.18, 0.22, 0.28, 0.19, 1.05],
])
P = (5 + 2) / 2
W_DOMAIN = [np.linspace(0.0, 2.0, 8)] * 5
W_GRID = np.linspace(0.0, 2.0, 8)
W_SEED = 2026
W_ARGS = {"maxvol": dict(rank=8, n_iters=4, n_val=1500),
          "dmrg": dict(rank=8, n_iters=3, n_val=1500)}
MAKERS = {"maxvol": (jd.maxvol_cross_device, td.maxvol_cross_device),
          "dmrg": (jd.dmrg_cross_device, td.dmrg_cross_device)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread while this module runs."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(saved)


def wishart_jax(X):
    M = jnp.eye(5)[None] + jnp.asarray(SIGMA)[None] * X[:, None, :]
    return jnp.linalg.det(M) ** (-P)


def wishart_torch(X):
    M = torch.eye(5, dtype=X.dtype) + torch.as_tensor(SIGMA) * X[..., None, :]
    return torch.linalg.det(M) ** (-P)


def wishart_idx(indices):
    return wishart_torch(torch.as_tensor(W_GRID)[indices])


def rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def dense_batch(cores, k):
    from ttnx_torch.core.tt import TTVector

    return ttv_to_tensor(TTVector([c[k] for c in cores])).numpy()


# ---------------------------------------------------------------------------
# ttnx's starting sets, replayed from its keys
# ---------------------------------------------------------------------------


def _randint_cols(keys, rows, highs):
    if not highs:
        return np.zeros((rows, 0), dtype=np.int64)
    return np.stack([np.asarray(jax.random.randint(k, (rows,), 0, h,
                                                   dtype=jnp.int32))
                     for k, h in zip(keys, highs)], axis=1).astype(np.int64)


def _validation(key, Is, n_val):
    vkey = jax.random.split(key, len(Is))
    return _randint_cols(vkey, n_val, Is)


def maxvol_sets(key, Is, Rs, n_val):
    """``maxvol_cross_device``'s ``rsets`` and ``Xv`` for ``key``."""
    N = len(Is)
    keys = jax.random.split(key, N + 1)
    rsets = [_randint_cols([keys[c] for c in range(j + 1, N)], Rs[j + 1],
                           Is[j + 1:]) for j in range(N - 1)]
    rsets.append(np.zeros((1, 0), dtype=np.int64))
    return rsets, _validation(keys[N], Is, n_val)


def dmrg_sets(key, Is, Rs, n_val):
    """``dmrg_cross_device``'s ``Il``, ``Ig`` and ``Xv`` for ``key``."""
    N = len(Is)
    keys = jax.random.split(key, 2 * N + 1)
    empty = np.zeros((1, 0), dtype=np.int64)
    Il = [empty] + [_randint_cols([jax.random.fold_in(keys[k], j)
                                   for j in range(k)], Rs[k], Is[:k])
                    for k in range(1, N)]
    Ig = [_randint_cols([jax.random.fold_in(keys[N + k], j)
                         for j in range(N - 1 - k)], Rs[k + 1], Is[k + 1:])
          for k in range(N - 1)] + [empty]
    return Il, Ig, _validation(keys[2 * N], Is, n_val)


def port_sweep(method, f_idx, Is, rank, n_iters, sets, n_val):
    """The port's sweep function on ttnx's sets, stacked along a batch
    axis: ``sets`` one tuple of numpy sets per problem."""
    Rs = td._cap_ranks([1] + [rank] * (len(Is) - 1) + [1], Is, rank)

    def stack(parts):
        return torch.as_tensor(np.stack(parts))

    cols = list(zip(*sets))
    Xv = stack(cols[-1]) if n_val else None
    if method == "maxvol":
        rsets = [stack(p) for p in zip(*cols[0])]
        return td._maxvol_sweeps(f_idx, Is, Rs, rsets, Xv, n_iters, 1.05,
                                 100, torch.float64)
    Il = [stack(p) for p in zip(*cols[0])]
    Ig = [stack(p) for p in zip(*cols[1])]
    return td._dmrg_sweeps(f_idx, Is, Rs, Il, Ig, Xv, n_iters, 1.05, 100,
                           torch.float64)


def replayed(method, key, Is, rank, n_val):
    Rs = td._cap_ranks([1] + [rank] * (len(Is) - 1) + [1], Is, rank)
    sets = maxvol_sets if method == "maxvol" else dmrg_sets
    return sets(key, Is, Rs, n_val)


# ---------------------------------------------------------------------------
# maxvol_fixed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,r", [(40, 5), (100, 12), (17, 16), (64, 8)])
def test_maxvol_fixed_rows_equal_ttnx(n, r):
    """The rows equal ttnx's for every problem of a stack and for each one
    alone, and meet the dominance contract."""
    rng = np.random.default_rng(n * 100 + r)
    a = rng.standard_normal((3, n, r))
    stacked = td.maxvol_fixed(torch.as_tensor(a), 1.05, maxiter=200)
    assert stacked.dtype == torch.int64 and stacked.shape == (3, r)
    for b in range(3):
        ref = np.asarray(jd.maxvol_fixed(jnp.asarray(a[b]), 1.05,
                                         maxiter=200))
        one = td.maxvol_fixed(torch.as_tensor(a[b]), 1.05, maxiter=200)
        assert np.array_equal(one.numpy(), ref)
        assert np.array_equal(stacked[b].numpy(), ref)
        rows = one.numpy()
        assert len(np.unique(rows)) == r
        assert np.max(np.abs(a[b] @ np.linalg.inv(a[b][rows]))) <= 1.05 + 1e-8


@pytest.mark.parametrize("maxiter", [1, 3, 11])
def test_maxvol_fixed_stops_at_maxiter_and_freezes(maxiter):
    """A swap budget that ends inside a block of CHECK_EVERY swaps gives
    ttnx's rows; a problem that is dominant from the start (the identity
    on top) keeps its rows while the others swap."""
    rng = np.random.default_rng(maxiter)
    n, r = 48, 6
    a = rng.standard_normal((3, n, r))
    a[1] = np.vstack([np.eye(r), 0.5 * rng.uniform(-1, 1, (n - r, r)) / r])
    got = td.maxvol_fixed(torch.as_tensor(a), 1.05, maxiter=maxiter).numpy()
    for b in range(3):
        ref = np.asarray(jd.maxvol_fixed(jnp.asarray(a[b]), 1.05,
                                         maxiter=maxiter))
        assert np.array_equal(got[b], ref)
    assert np.array_equal(got[1], np.arange(r))


def test_maxvol_fixed_short_matrix():
    rows = td.maxvol_fixed(torch.eye(3, dtype=torch.float64), 1.05)
    assert np.array_equal(np.sort(rows.numpy()), [0, 1, 2])
    rows = td.maxvol_fixed(torch.eye(3, dtype=torch.float64).expand(2, 3, 3))
    assert rows.shape == (2, 3)


def test_maxvol_fixed_complex_dominance():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((30, 4)) + 1j * rng.standard_normal((30, 4))
    rows = td.maxvol_fixed(torch.as_tensor(a), 1.05, maxiter=200).numpy()
    ref = np.asarray(jd.maxvol_fixed(jnp.asarray(a), 1.05, maxiter=200))
    assert np.array_equal(rows, ref)
    assert np.max(np.abs(a @ np.linalg.inv(a[rows]))) <= 1.05 + 1e-8


def test_pinv_matches_numpy():
    """The start matrix's pseudo-inverse (through thin_svd) on a regular
    and a singular block."""
    rng = np.random.default_rng(5)
    M = rng.standard_normal((8, 8)) + 2 * np.eye(8)
    Ms = np.outer(rng.standard_normal(6), rng.standard_normal(6))
    for m in (M, Ms):
        got = td._pinv(torch.as_tensor(m)[None])[0].numpy()
        assert np.allclose(got, np.linalg.pinv(m), atol=1e-9)


# ---------------------------------------------------------------------------
# TT evaluation and the index evaluator
# ---------------------------------------------------------------------------


def test_evaluate_tt_indices_matches_host():
    rng = np.random.default_rng(1234)
    cores = [rng.standard_normal((1, 4, 3)), rng.standard_normal((3, 5, 2)),
             rng.standard_normal((2, 4, 1))]
    idx = np.stack([rng.integers(0, 4, 50), rng.integers(0, 5, 50),
                    rng.integers(0, 4, 50)], axis=1)
    got = td.evaluate_tt_indices([torch.as_tensor(c) for c in cores],
                                 torch.as_tensor(idx)).numpy()
    ref = _evaluate_tt(cores, idx)
    assert np.allclose(got, ref, atol=1e-12)
    jref = np.asarray(jd.evaluate_tt_indices([jnp.asarray(c) for c in cores],
                                             jnp.asarray(idx)))
    assert np.allclose(got, jref, atol=1e-12)
    # a batch of two TTs at their own index rows
    twice = [torch.as_tensor(np.stack([c, 2 * c])) for c in cores]
    both = td.evaluate_tt_indices(twice, torch.as_tensor(np.stack([idx,
                                                                   idx])))
    assert np.allclose(both[0].numpy(), ref, atol=1e-12)
    assert np.allclose(both[1].numpy(), 8 * ref, atol=1e-12)


def test_index_evaluator_maps_indices_to_grid_points():
    g = [np.linspace(0, 1, 4), np.linspace(-1, 0, 3)]
    f_idx = td.index_evaluator(lambda X: X[..., 0] + 10 * X[..., 1], g,
                               device=CPU)
    idx = torch.tensor([[0, 0], [3, 2], [1, 1]])
    want = [g[0][i] + 10 * g[1][j] for i, j in idx.tolist()]
    assert np.allclose(f_idx(idx).numpy(), want, atol=1e-15)
    assert f_idx(idx[None].expand(2, 3, 2)).shape == (2, 3)


# ---------------------------------------------------------------------------
# The sweeps on ttnx's own starting sets (the Wishart Laplace transform)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["maxvol", "dmrg"])
def wishart(request):
    """ttnx's device cross of the 5-D Wishart integrand (the reference
    test's settings) and the port's sweep on the sets replayed from ttnx's
    key."""
    method = request.param
    args = W_ARGS[method]
    Is = [8] * 5
    jmaker, _ = MAKERS[method]
    j_idx = jd.index_evaluator(wishart_jax, W_DOMAIN)
    key = jax.random.PRNGKey(W_SEED)
    j_cores, j_eps = jax.jit(jmaker(j_idx, Is, args["rank"],
                                    n_iters=args["n_iters"],
                                    n_val=args["n_val"]))(key)
    sets = replayed(method, key, Is, args["rank"], args["n_val"])
    cores, eps = port_sweep(method, lambda i: wishart_idx(i), Is,
                            args["rank"], args["n_iters"], [sets],
                            args["n_val"])
    from ttnx.core.tt import TTVector as JVec

    return dict(method=method, j_dense=np.asarray(j_dense(JVec(j_cores))),
                j_eps=np.asarray(j_eps), cores=cores, eps=eps.numpy()[0])


def test_sweep_on_replayed_sets_matches_ttnx(wishart):
    got = dense_batch(wishart["cores"], 0)
    ref = wishart["j_dense"]
    assert np.max(np.abs(got - ref)) <= 1e-10 * np.max(np.abs(ref))
    assert np.allclose(wishart["eps"], wishart["j_eps"], rtol=0, atol=1e-10)


def test_wishart_accuracy_contract(wishart):
    """rel-L2 < 1e-4 on 200 fresh points (reference
    test_tt_cross_interpolation.jl:147-186)."""
    rng = np.random.default_rng(2027)
    idx = np.stack([rng.integers(0, 8, 200) for _ in range(5)], axis=1)
    ys = wishart_idx(torch.as_tensor(idx)).numpy()
    cores = [c[0] for c in wishart["cores"]]
    yhat = td.evaluate_tt_indices(cores, torch.as_tensor(idx)).numpy()
    assert rel(yhat, ys) < 1e-4
    assert wishart["eps"][-1] < 1e-4


# ---------------------------------------------------------------------------
# Accuracy contracts through the public entry points
# ---------------------------------------------------------------------------


def gaussian(X):
    return torch.exp(-(X ** 2).sum(-1))


@pytest.mark.parametrize("method", ["maxvol", "dmrg"])
def test_device_cross_separable_gaussian(method):
    g = np.linspace(-1, 1, 12)
    tt, eps = td.tt_cross_device(gaussian, [g] * 4, rank=3, n_iters=3,
                                 n_val=300, method=method, device=CPU)
    xs = np.stack(np.meshgrid(*[g] * 4, indexing="ij"), axis=-1)
    expect = np.exp(-np.sum(xs ** 2, axis=-1))
    assert rel(ttv_to_tensor(tt).numpy(), expect) < 1e-8
    assert eps.shape == (3,) and eps[-1] < 1e-8
    assert tt.ranks == (1, 3, 3, 3, 1)


@pytest.mark.parametrize("method", ["maxvol", "dmrg"])
def test_generator_draws_the_starting_sets(method):
    """One seed gives one result; each problem of a batch draws its own
    sets; without ``n_val`` the histories are zero."""
    g = torch.as_tensor(np.linspace(0.2, 1.5, 10))

    def f_idx(indices):
        return torch.exp(-(g[indices] ** 2).sum(-1))

    maker = MAKERS[method][1]
    run = maker(f_idx, [10] * 3, rank=2, n_iters=2, batch=3)
    c1, e1 = run(torch.Generator().manual_seed(3))
    c2, _ = run(torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(c1, c2))
    assert e1.shape == (3, 2) and not e1.any()
    single = maker(f_idx, [10] * 3, rank=2, n_iters=2, n_val=50)
    cores, eps = single(torch.Generator().manual_seed(3))
    assert cores[1].dim() == 3 and eps.shape == (2,)


@pytest.mark.parametrize("method", ["maxvol", "dmrg"])
def test_batched_run_equals_per_problem_runs(method):
    """A batch of parameters (the vmap parameter sweep of BASELINE config
    5) equals per-problem runs fed the same sets, each from its own key."""
    g = torch.as_tensor(np.linspace(0.2, 1.5, 10))
    thetas = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64)
    Is, rank, n_val = [10] * 3, 2, 100

    def f_idx(indices):
        return torch.exp(-thetas[:, None] * (g[indices] ** 2).sum(-1))

    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    sets = [replayed(method, k, Is, rank, n_val) for k in keys]
    cores_b, eps_b = port_sweep(method, f_idx, Is, rank, 2, sets, n_val)
    for k in range(3):
        def one(indices, th=thetas[k]):
            return torch.exp(-th * (g[indices] ** 2).sum(-1))

        cores_1, eps_1 = port_sweep(method, one, Is, rank, 2, [sets[k]],
                                    n_val)
        for cb, c1 in zip(cores_b, cores_1):
            assert np.allclose(cb[k].numpy(), c1[0].numpy(), rtol=0,
                               atol=1e-10)
        assert abs(float(eps_b[k, -1] - eps_1[0, -1])) <= 1e-10
        assert float(eps_b[k, -1]) < 1e-10


def test_adaptive_rank_escalation():
    """The first stage that meets tol ends the schedule; a tol out of reach
    runs to its last stage."""
    g = np.linspace(-1, 1, 10)
    tt, eps, rank = td.tt_cross_device_adaptive(gaussian, [g] * 3, tol=1e-8,
                                                rank_schedule=(2, 4, 8),
                                                device=CPU)
    assert rank == 2 and eps[-1] < 1e-8

    def coupled(X):
        return torch.exp(-(X ** 2).sum(-1)) / (
            1.1 + torch.prod(torch.sin(3 * X), dim=-1))

    tt2, eps2, rank2 = td.tt_cross_device_adaptive(coupled, [g] * 3,
                                                   tol=1e-12,
                                                   rank_schedule=(2, 4),
                                                   device=CPU)
    assert rank2 == 4 and max(tt2.ranks) == 4
    assert eps2[-1] < 0.5


@pytest.mark.parametrize("method", ["maxvol", "dmrg"])
def test_complex_function_is_reproduced(method):
    """A rank-2 complex separable function on a real grid: the R->L
    terminal core takes ``sb @ q`` (ROADMAP C.9), so the DMRG cross
    reproduces the function."""
    g = np.linspace(0.0, np.pi, 7)

    def f(X):
        return (torch.prod(torch.sin(X), dim=-1)
                + 1j * torch.prod(torch.cos(X), dim=-1))

    tt, eps = td.tt_cross_device(f, [g] * 3, rank=2, n_iters=3, n_val=200,
                                 method=method, device=CPU)
    xs = np.stack(np.meshgrid(*[g] * 3, indexing="ij"), axis=-1)
    expect = np.prod(np.sin(xs), -1) + 1j * np.prod(np.cos(xs), -1)
    assert tt.is_complex
    assert rel(ttv_to_tensor(tt).numpy(), expect) < 1e-8
    assert eps[-1] < 1e-8
