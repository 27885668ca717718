"""The host-driven cross of ttnx_torch (``cross/cross.py``, ``cross/maxvol.py``)
against ttnx on the CPU, in float64 and complex128.

Mirrors tests/test_cross.py, tests/test_cross_complex.py and the cross
cases of tests/test_coverage_extras.py. Each case runs the same black box
through both packages on the same seed: the port's dense tensor must be
within 1e-12 of ttnx's (relative to its largest entry), and each result
within the reference test's own tolerance of the function. ``tt_integrate``
is held to ttnx at 1e-12 and to the closed forms at the reference
tolerances; ``maxvol`` gives ttnx's rows exactly.
"""

import numpy as np
import pytest
import torch
from scipy.special import erf
from threadpoolctl import threadpool_limits

import ttnx.cross.cross as jc
from ttnx.cross.maxvol import maxvol as j_maxvol

import ttnx_torch.cross.cross as tc
from ttnx_torch.cross.maxvol import maxvol as t_maxvol

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread while this module runs."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(saved)


def dense(cores):
    """The dense tensor of numpy TT cores."""
    out = np.ones((1, 1))
    dims = []
    for c in cores:
        c = np.asarray(c)
        dims.append(c.shape[1])
        out = (out @ c.reshape(c.shape[0], -1)).reshape(-1, c.shape[2])
    return out.reshape(dims)


def port_dense(tt):
    assert all(c.device.type == "cpu" for c in tt.cores)
    return dense([c.numpy() for c in tt.cores])


def dense_eval(f, domain):
    mesh = np.meshgrid(*domain, indexing="ij")
    X = np.stack([m.reshape(-1) for m in mesh], axis=1)
    return np.asarray(f(X)).reshape([len(d) for d in domain])


def relerr(full, exact):
    return np.linalg.norm(full - exact) / max(np.linalg.norm(exact),
                                              np.finfo(float).eps)


def both(f, domain, alg_name, alg_kw, **kw):
    """The cross of ``f`` through ttnx and through the port (same seed);
    returns both dense tensors after holding them to each other."""
    j_tt = jc.tt_cross(f, domain, getattr(jc, alg_name)(**alg_kw), **kw)
    t_tt = tc.tt_cross(f, domain, getattr(tc, alg_name)(**alg_kw),
                       device=CPU, **kw)
    ref = dense(j_tt.cores)
    got = port_dense(t_tt)
    assert t_tt.ranks == j_tt.ranks
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))
    return got, t_tt


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def test_cap_ranks():
    assert tc._cap_ranks([1, 10, 10, 10, 1], [2, 2, 2, 2], 500) == [
        1, 2, 4, 2, 1]
    assert tc._cap_ranks([1, 10, 10, 1], [4, 4, 4], 3) == [1, 3, 3, 1]


@pytest.mark.parametrize("shape", [(40, 5), (100, 12), (17, 16), (9, 9)])
def test_maxvol_rows_equal_ttnx(shape):
    rng = np.random.default_rng(sum(shape))
    a = rng.standard_normal(shape)
    rows = t_maxvol(a, tol=1.05, maxiter=200)
    assert np.array_equal(rows, j_maxvol(a, tol=1.05, maxiter=200))
    if shape[0] > shape[1]:
        assert len(set(rows.tolist())) == shape[1]
        assert np.max(np.abs(a @ np.linalg.inv(a[rows]))) <= 1.05 + 1e-8


def test_gauss_legendre():
    x, w = tc.gauss_legendre(10, 0.0, 1.0)
    jx, jw = jc.gauss_legendre(10, 0.0, 1.0)
    assert np.array_equal(x, jx) and np.array_equal(w, jw)
    for k in [0, 3, 10, 19]:
        assert np.isclose((w * x ** k).sum(), 1.0 / (k + 1), atol=1e-12)


def test_cores_land_on_the_device_and_keep_the_dtype():
    tt = tc.tt_cross(lambda X: np.sum(X, axis=1), (4, 4, 4), device=CPU)
    assert tt.N == 3 and tt.dtype == torch.float64
    g = np.linspace(0, 1, 5)
    tt = tc.tt_cross(lambda X: np.exp(1j * X.sum(1)), [g] * 2,
                     tc.MaxVol(tol=1e-10), device=CPU)
    assert tt.dtype == torch.complex128
    with pytest.raises(TypeError):
        tc.tt_cross(lambda X: X[:, 0], (3, 3), object(), device=CPU)


# ---------------------------------------------------------------------------
# Real cases of tests/test_cross.py
# ---------------------------------------------------------------------------


def _gauss(X):
    return np.exp(-np.sum(X ** 2, axis=1))


def _rank4(X):
    return (np.cos(4 * np.pi * X[:, 0]) * np.cos(3 * np.pi * X[:, 1])
            + X[:, 0] * X[:, 1] + np.sin(X[:, 2]))


g10, g12, g8 = (np.linspace(-1, 1, 10), np.linspace(-1, 1, 12),
                np.linspace(0, 1, 8))

REAL_CASES = {
    # name: (f, domain, algorithm, its options, cross kwargs, tol vs f)
    "readme_gaussian_4d": (_gauss, [g10] * 4, "MaxVol", dict(tol=1e-8),
                           dict(ranks=2), 1e-8),
    "dims_tuple": (lambda X: np.sum(X, axis=1), (5, 5, 5), "MaxVol",
                   dict(tol=1e-10), dict(ranks=2), 1e-8),
    "default_algorithm": (lambda X: np.sum(X, axis=1), (4, 4, 4), "MaxVol",
                          {}, {}, 1e-8),
    "kickrank_growth": (_rank4, [g8] * 3, "MaxVol",
                        dict(tol=1e-10, kickrank=3), dict(ranks=1), 1e-8),
    "dmrg_separable": (_gauss, [g12] * 4, "DMRGCross", dict(tol=1e-10),
                       dict(ranks=3), 1e-8),
    "dmrg_one_dimensional": (lambda X: np.sin(np.pi * X[:, 0]),
                             [np.linspace(0, 1, 16)], "DMRGCross", {}, {},
                             1e-12),
    "dmrg_rank_adaptive": (
        lambda X: 1.0 / (1.0 + X[:, 0] + 2 * X[:, 1] + 3 * X[:, 2]),
        [np.linspace(0, 1, 10)] * 3, "DMRGCross", dict(tol=1e-10, rmax=10),
        dict(ranks=2), 1e-8),
    "greedy_smooth": (lambda X: np.exp(np.sum(X, axis=1)),
                      [np.linspace(0.1, 1, 8)] * 3, "Greedy",
                      dict(tol=1e-9), {}, 1e-7),
    "greedy_zero_lock": (lambda X: np.prod(np.sin(np.pi * X), axis=1),
                         [np.linspace(0, 1, 9)] * 3, "Greedy",
                         dict(tol=1e-8), {}, 1e-6),
    "greedy_bordered_updates": (lambda X: 1.0 / (1.0 + np.sum(X, axis=1)),
                                [np.linspace(0.0, 1.0, 12)] * 3, "Greedy",
                                dict(tol=1e-9, rmax=12), {}, 1e-5),
}


@pytest.mark.parametrize("case", list(REAL_CASES))
def test_real_cross_matches_ttnx_and_the_function(case):
    f, domain, alg, alg_kw, kw, tol = REAL_CASES[case]
    full, tt = both(f, domain, alg, alg_kw, **kw)
    grids = ([np.arange(1.0, d + 1.0) for d in domain]
             if isinstance(domain, tuple) else domain)
    assert relerr(full, dense_eval(f, grids)) < tol
    if case == "dmrg_rank_adaptive":
        assert max(tt.ranks) <= 10
    if case == "greedy_bordered_updates":
        assert max(tt.ranks) >= 4  # the bordered updates actually ran


def test_wishart_5d():
    """(reference test_tt_cross_interpolation.jl:147-186)"""
    d = 5
    sigma = 2 * np.array([
        [1.0, 0.3, 0.2, 0.1, 0.18],
        [0.3, 1.2, 0.25, 0.15, 0.22],
        [0.2, 0.25, 0.9, 0.2, 0.28],
        [0.1, 0.15, 0.2, 1.1, 0.19],
        [0.18, 0.22, 0.28, 0.19, 1.05],
    ])

    def f(X):
        return np.linalg.det(np.eye(d) + sigma * X[:, None, :]) ** (-(d + 2)
                                                                    / 2)

    domain = [np.linspace(0.0, 2.0, 8)] * d
    _, tt = both(f, domain, "MaxVol",
                 dict(tol=1e-6, maxiter=25, rmax=60, kickrank=2), ranks=2,
                 val_size=1500, seed=2026)
    rng = np.random.default_rng(2027)
    idx = np.stack([rng.integers(0, 8, 200) for _ in range(d)], axis=1)
    coords = np.stack([domain[k][idx[:, k]] for k in range(d)], axis=1)
    yhat = tc._evaluate_tt([c.numpy() for c in tt.cores], idx)
    assert relerr(yhat, f(coords)) < 1e-4


# ---------------------------------------------------------------------------
# Quadrature
# ---------------------------------------------------------------------------


INTEGRALS = {
    "separable_exponential": (lambda X: np.exp(np.sum(X, axis=1)),
                              (np.zeros(2), np.ones(2)), dict(nquad=20),
                              (np.e - 1) ** 2, 1e-10),
    "dims_shorthand": (lambda X: np.prod(X, axis=1), (3,), {}, 0.125,
                       1e-10),
    "gaussian_3d": (_gauss, (-np.ones(3), np.ones(3)), dict(nquad=30),
                    (np.sqrt(np.pi) * erf(1.0)) ** 3, 1e-9),
}


@pytest.mark.parametrize("case", list(INTEGRALS))
def test_integrate_matches_ttnx_and_the_closed_form(case):
    f, bounds, kw, exact, atol = INTEGRALS[case]
    got = tc.tt_integrate(f, *bounds, alg=tc.MaxVol(tol=1e-10), device=CPU,
                          **kw)
    ref = jc.tt_integrate(f, *bounds, alg=jc.MaxVol(tol=1e-10), **kw)
    assert isinstance(got, float)
    assert abs(got - ref) <= 1e-12 * abs(ref)
    assert abs(got - exact) <= atol


def test_integrate_complex_and_bounds_mismatch():
    f = lambda X: np.exp(1j * np.sum(X, axis=1))  # noqa: E731
    got = tc.tt_integrate(f, np.zeros(2), np.ones(2), device=CPU)
    assert isinstance(got, complex)
    assert abs(got - ((np.exp(1j) - 1) / 1j) ** 2) < 1e-12
    with pytest.raises(ValueError):
        tc.tt_integrate(lambda X: X[:, 0], np.zeros(2), np.ones(3),
                        device=CPU)


# ---------------------------------------------------------------------------
# tests/test_cross_complex.py and the complex cases of
# tests/test_coverage_extras.py
# ---------------------------------------------------------------------------


ALGS = {
    "maxvol": ("MaxVol", {}),
    "greedy": ("Greedy", dict(nsamples=500)),
    "dmrg": ("DMRGCross", {}),
}


def alg_options(alg_name, **kw):
    name, extra = ALGS[alg_name]
    kw = dict(kw, **extra)
    if alg_name == "greedy":
        kw.pop("kickrank", None)
    return name, kw


def both_greedy_seeded(f, domain, alg_name, alg_kw, **kw):
    """As :func:`both`; Greedy takes ``RandomPivot(seed=42)`` as the
    reference suite does."""
    name, opts = alg_options(alg_name, **alg_kw)
    if alg_name != "greedy":
        return both(f, domain, name, opts, **kw)
    j_tt = jc.tt_cross(f, domain, jc.Greedy(pivot=jc.RandomPivot(seed=42),
                                            **opts), **kw)
    t_tt = tc.tt_cross(f, domain, tc.Greedy(pivot=tc.RandomPivot(seed=42),
                                            **opts), device=CPU, **kw)
    ref, got = dense(j_tt.cores), port_dense(t_tt)
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))
    return got, t_tt


_cg = np.linspace(0.0, 1.0, 5) + 1j * np.linspace(0.0, 0.4, 5)
_sg = np.linspace(0.0, 1.0, 5) * (1.0 + 0.5j) + (1.0 + 0.5j)
COMPLEX_CASES = {
    # jl:214-241 — complex coordinate grids
    "complex_domain": (lambda X: np.exp(X[:, 0] + 0.7 * X[:, 1]
                                        - 0.3 * X[:, 2]),
                       [_cg] * 3, dict(tol=1e-8, maxiter=20, rmax=30), 1e-6),
    # jl:435-446 — rank-1 complex on a real grid
    "rank1_separable": (lambda X: np.prod(np.exp(1j * X), axis=1),
                        [np.linspace(0.0, 1.0, 5)] * 3,
                        dict(tol=1e-10, maxiter=30), 1e-8),
    # jl:347-371 — x1 x2 x3 on a complex grid
    "separable_complex_grid": (lambda X: np.prod(X, axis=1), [_sg] * 3,
                               dict(tol=1e-10, maxiter=30), 1e-8),
    # jl:373-397 — exp(i sum x^2)
    "smooth_complex_valued": (lambda X: np.exp(1j * np.sum(X ** 2, axis=1)),
                              [np.linspace(0.0, 1.0, 6)] * 3,
                              dict(tol=1e-6, maxiter=50, rmax=20), 1e-4),
    # jl:399-428 — rank-2 complex separable with a rank cap
    "rank2_separable": (lambda X: (np.prod(np.sin(X), axis=1)
                                   + 1j * np.prod(np.cos(X), axis=1)),
                        [np.linspace(0.0, np.pi, 7)] * 3,
                        dict(tol=1e-10, maxiter=30, rmax=4), 1e-8),
    # jl:430-455 — Lorentzian resolvent
    "lorentzian": (lambda X: 1.0 / (0.3j + np.sum(X ** 2, axis=1)),
                   [np.linspace(-1.0, 1.0, 8)] * 3,
                   dict(tol=1e-6, maxiter=40, rmax=20), 1e-4),
    # jl:457-480 — 4-D rank-1 complex separable
    "separable_4d": (lambda X: np.prod(1.0 + 1j * X, axis=1),
                     [np.linspace(0.0, 1.0, 6)] * 4,
                     dict(tol=1e-10, maxiter=20), 1e-8),
    # jl:243-330 — the real accuracy triples
    "low_rank_polynomial": (lambda X: np.sum(X, axis=1) ** 2,
                            [np.linspace(0.0, 1.0, 8)] * 3,
                            dict(tol=1e-8, maxiter=30, rmax=10), 1e-6),
    "smooth_gaussian_4d": (_gauss, [np.linspace(-1.0, 1.0, 8)] * 4,
                           dict(tol=1e-6, maxiter=50, rmax=20), 1e-4),
}


@pytest.mark.parametrize("alg_name", list(ALGS))
@pytest.mark.parametrize("case", list(COMPLEX_CASES))
def test_suite_matches_ttnx_and_the_function(case, alg_name):
    f, domain, alg_kw, tol = COMPLEX_CASES[case]
    if alg_name == "greedy" and case in ("rank2_separable",
                                         "low_rank_polynomial"):
        alg_kw = {k: v for k, v in alg_kw.items() if k != "rmax"}
    full, tt = both_greedy_seeded(f, domain, alg_name, alg_kw, ranks=2)
    exact = dense_eval(f, domain)
    assert tt.is_complex == np.iscomplexobj(exact)
    assert relerr(full, exact) < tol
    if case == "rank2_separable" and alg_name != "greedy":
        assert max(tt.ranks) <= 4


@pytest.mark.parametrize("alg_name,d,tol", [("MaxVol", 2, 1e-8),
                                            ("DMRGCross", 3, 1e-7)])
def test_complex_cross_coverage_cases(alg_name, d, tol):
    g = np.linspace(0, 1, 8)
    if d == 2:
        def f(X):
            return np.exp(2j * np.pi * X[:, 0]) * np.cos(np.pi * X[:, 1])
    else:
        def f(X):
            return np.exp(1j * np.pi * (X[:, 0] + 0.5 * X[:, 1] + X[:, 2]))
    full, tt = both(f, [g] * d, alg_name, dict(tol=1e-10), ranks=2)
    assert tt.is_complex
    assert relerr(full, dense_eval(f, [g] * d)) < tol


def test_greedy_stall_falls_back_to_dmrg(capsys):
    """A forced Greedy stall (1 sweep, tiny budget, tight tol) falls back to
    the DMRG cross, which rescues the approximation (reference
    jl:512-518)."""
    domain = [np.linspace(-1.0, 1.0, 8)] * 3

    def f(X):
        return np.exp(-np.sum(X ** 2, axis=1)) + 0.1 * np.cos(
            3.0 * np.sum(X, axis=1))

    tt = tc.tt_cross(f, domain, tc.Greedy(tol=1e-10, maxiter=1, nsamples=4,
                                          verbose=True,
                                          pivot=tc.RandomPivot(seed=7)),
                     ranks=1, device=CPU)
    out = capsys.readouterr().out
    assert "stalled" in out and "DMRG" in out
    j_tt = jc.tt_cross(f, domain, jc.Greedy(tol=1e-10, maxiter=1,
                                            nsamples=4,
                                            pivot=jc.RandomPivot(seed=7)),
                       ranks=1)
    ref = dense(j_tt.cores)
    got = port_dense(tt)
    assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))
    assert relerr(got, dense_eval(f, domain)) < 1e-4


@pytest.mark.parametrize("module", ["ttnx_torch.cross", "ttnx_torch.utils"])
def test_module_loads_no_jax(module):
    """Importing the cross or the utilities in a fresh interpreter loads
    neither jax nor ttnx."""
    import subprocess
    import sys
    from pathlib import Path

    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'jaxlib', 'ttnx'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
