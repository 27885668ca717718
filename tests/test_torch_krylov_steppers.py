"""The eager Krylov methods and time steppers of ttnx_torch
(``solvers/krylov.py``, ``solvers/steppers.py``) against ttnx on the CPU,
in float64.

Mirrors tests/test_steppers_krylov.py: the Arnoldi exponential against
scipy's dense expm, the TT-valued exponential integrator, the TT GMRES /
CG / BiCGStab and the solver choice of ``krylov_linsolve``, and the four
steppers against dense recurrences and the heat equation's eigenmode.
Inputs are numpy arrays from seeds (or ttnx's deterministic constructors)
fed to both packages. Tolerances: steppers at d <= 8 port against ttnx
1e-10; Krylov solvers with rounding port against ttnx 1e-8 and each
against the oracle at the reference test's own tolerance. States are
compared as dense vectors, never as raw cores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from threadpoolctl import threadpool_limits

import ttnx
from ttnx.core.tt import TTOperator as JOp
from ttnx.core.tt import TTVector as JVec
from ttnx.solvers import krylov as jk
from ttnx.solvers import steppers as js

import ttnx_torch as tx
from ttnx_torch.solvers import krylov as tk
from ttnx_torch.solvers import steppers as ts
from ttnx_torch.utils.convert import ttoperator_from_numpy, ttvector_from_numpy

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread while this module runs (many
    small factorizations beside the other test workers)."""
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


def rand_cores(rng, d, r):
    rks = ttnx.r_and_d_to_rks([1] + [r] * (d - 1) + [1], (2,) * d, rmax=r)
    return [rng.standard_normal((rks[k], 2, rks[k + 1])) / np.sqrt(
        2 * rks[k + 1]) for k in range(d)]


def rand_op_cores(rng, d, r):
    rks = ttnx.r_and_d_to_rks([1] + [r] * (d - 1) + [1], (4,) * d, rmax=r)
    return [rng.standard_normal((rks[k], 2, 2, rks[k + 1]))
            for k in range(d)]


def both(obj):
    if isinstance(obj, JOp):
        return obj, ttoperator_from_numpy([np.array(c) for c in obj.cores],
                                          device=CPU)
    if isinstance(obj, JVec):
        return obj, ttvector_from_numpy([np.array(c) for c in obj.cores],
                                        device=CPU)
    if obj[0].ndim == 4:
        return (JOp([jnp.asarray(c) for c in obj]),
                ttoperator_from_numpy(obj, device=CPU))
    return (JVec([jnp.asarray(c) for c in obj]),
            ttvector_from_numpy(obj, device=CPU))


def heat_setup(d=5, kappa=1e-4):
    """Negative-definite heat operator and a smooth initial state."""
    h = 1.0 / (2 ** d + 1)
    A = (kappa / h ** 2) * ttnx.toeplitz_to_qtto(-2.0, 1.0, 1.0, d)
    return both(A), both(ttnx.qtt_sin(d, a=h, b=1 - h))


# ---------------------------------------------------------------------------
# Arnoldi exponential on dense vectors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [0.3, -0.7, 0.2j, -0.4j])
def test_expm_multiply_matches_dense_expm(rng, t):
    n = 20
    M = rng.standard_normal((n, n))
    M = 0.5 * (M + M.T)
    v = rng.standard_normal(n)
    Mt = torch.as_tensor(M)
    out = tk.expm_multiply(lambda x: Mt.to(x.dtype) @ x, t,
                           torch.as_tensor(v)).numpy()
    expect = scipy.linalg.expm(t * M) @ v
    assert rel(out, expect) < 1e-10
    ref = np.asarray(jk.expm_multiply(lambda x: jnp.asarray(M) @ x, t,
                                      jnp.asarray(v)))
    assert out.dtype == ref.dtype and rel(out, ref) < 1e-12


def test_expm_multiply_zero_vector_and_nonsymmetric(rng):
    zero = tk.expm_multiply(lambda x: 2 * x, 0.5,
                            torch.zeros(5, dtype=torch.float64))
    assert torch.equal(zero, torch.zeros(5, dtype=torch.float64))
    n = 12
    M, v = rng.standard_normal((n, n)), rng.standard_normal(n)
    Mt = torch.as_tensor(M)
    out = tk.expm_multiply(lambda x: Mt @ x, 0.5, torch.as_tensor(v))
    assert rel(out.numpy(), scipy.linalg.expm(0.5 * M) @ v) < 1e-9


def test_expm_multiply_keeps_float32(rng):
    """A real step keeps float32 data float32; an imaginary one makes it
    complex64 (the scalar is weak, as in the reference)."""
    v = torch.as_tensor(rng.standard_normal(8), dtype=torch.float32)
    assert tk.expm_multiply(lambda x: -x, 0.1, v).dtype == torch.float32
    assert tk.expm_multiply(lambda x: -x, 0.1j, v).dtype == torch.complex64


# ---------------------------------------------------------------------------
# The TT exponential integrator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,t,kdim,max_bond,tol", [
    (3, 0.3, 10, 0, 1e-10), (4, 0.2, 20, 6, 1e-8)])
def test_expintegrator_tt(rng, d, t, kdim, max_bond, tol):
    """Full Krylov space at d = 3 is exact; at d = 4 every basis vector is
    rounded to rank 6."""
    jA, A = both(rand_op_cores(rng, d, 2))
    jv, v = both(rand_cores(rng, d, 2))
    out, info = tk.expintegrator_tt(A, t, v, krylov_dim=kdim,
                                    max_bond=max_bond)
    ref, info_j = jk.expintegrator_tt(jA, t, jv, krylov_dim=kdim,
                                      max_bond=max_bond)
    expect = scipy.linalg.expm(t * mat(jA)) @ vec(jv)
    assert rel(vec(out), expect) < tol
    assert info["krylov_dim"] == info_j["krylov_dim"] <= 2 ** d + 1
    assert rel(vec(out), vec(ref)) < 1e-8
    if max_bond:
        assert max(out.ranks) <= max_bond


def test_expintegrator_zero_vector(rng):
    _, A = both(rand_op_cores(rng, 3, 2))
    out, info = tk.expintegrator_tt(A, 0.5, tx.zeros_tt((2,) * 3,
                                                        device=CPU))
    assert info["krylov_dim"] == 0 and np.allclose(vec(out), 0.0)


def test_expintegrator_bad_dim(rng):
    _, A = both(rand_op_cores(rng, 3, 2))
    _, v = both(rand_cores(rng, 3, 2))
    with pytest.raises(ValueError):
        tk.expintegrator_tt(A, 0.5, v, krylov_dim=0)


# ---------------------------------------------------------------------------
# TT-valued Krylov linear solvers
# ---------------------------------------------------------------------------


def _system(rng, d=5):
    """A well-conditioned SPD system: I + 0.1 laplacian, a smooth exact
    solution, b its TT-SVD, a random rank-2 start."""
    jA, A = both(ttnx.id_tto(d) + 0.1 * ttnx.laplacian(d))
    x_true = np.asarray(ttnx.qtt_to_vector(ttnx.function_to_qtt(
        lambda x: np.sin(np.pi * x) + 0.3, d)))
    jb, b = both(ttnx.ttv_decomp((mat(jA) @ x_true).reshape((2,) * d),
                                 tol=1e-14))
    jx0, x0 = both(rand_cores(rng, d, 2))
    return (jA, jb, jx0), (A, b, x0), x_true


@pytest.mark.parametrize("solver,kw", [
    ("gmres", dict(krylovdim=10, maxiter=10, tol=1e-10)),
    ("cg", dict(maxiter=200, tol=1e-10)),
    ("bicgstab", dict(maxiter=100, tol=1e-10)),
])
def test_tt_krylov_solver(rng, solver, kw):
    """Each solver with exact orthogonalization against the exact solution
    (the reference test's bound; the ranks grow every iteration, so ttnx's
    eager side compiles each op anew: parity is held with rounding
    below)."""
    _, (A, b, x0), x_true = _system(rng)
    fn = {"gmres": tk.gmres_tt, "cg": tk.cg_tt, "bicgstab": tk.bicgstab_tt}
    x = fn[solver](lambda v: tx.matvec(A, v), b, x0, **kw)
    assert np.linalg.norm(vec(x) - x_true) < 1e-6


def test_tt_krylov_solvers_with_rounding(rng):
    """The three solvers with every update rounded to rank 4 on the same
    system: port against ttnx 1e-8, and the exact solution 1e-5."""
    (jA, jb, jx0), (A, b, x0), x_true = _system(rng)
    max_bond = 4
    op = lambda v: tx.tt_round(tx.matvec(A, v), max_bond=max_bond)
    jop = lambda v: ttnx.tt_round(ttnx.matvec(jA, v), max_bond=max_bond)
    for fn, jfn, kw in ((tk.gmres_tt, jk.gmres_tt, dict(krylovdim=6)),
                        (tk.cg_tt, jk.cg_tt, dict(maxiter=40)),
                        (tk.bicgstab_tt, jk.bicgstab_tt, dict(maxiter=30))):
        x = fn(op, b, x0, tol=1e-10, max_bond=max_bond, **kw)
        xj = jfn(jop, jb, jx0, tol=1e-10, max_bond=max_bond, **kw)
        assert rel(vec(x), vec(xj)) < 1e-8, fn.__name__
        assert np.linalg.norm(vec(x) - x_true) < 1e-5, fn.__name__


def test_gmres_full_ill_conditioned(rng):
    """Full GMRES (krylovdim >= dim) solves the unscaled Laplacian."""
    d = 4
    jA, A = both(ttnx.laplacian(d))
    x_true = np.asarray(ttnx.qtt_to_vector(ttnx.function_to_qtt(
        lambda x: np.sin(np.pi * x) + 0.3, d)))
    jb, b = both(ttnx.ttv_decomp((mat(jA) @ x_true).reshape((2,) * d),
                                 tol=1e-14))
    jx0, x0 = both(rand_cores(rng, d, 2))
    x = tk.gmres_tt(lambda v: tx.matvec(A, v), b, x0, krylovdim=16,
                    maxiter=3, tol=1e-12)
    assert np.linalg.norm(vec(x) - x_true) < 1e-8


@pytest.mark.parametrize("kw,want", [
    (dict(issymmetric=True, isposdef=True, maxiter=40), "cg"),
    (dict(max_bond=6, maxiter=60, rtol=1e-10), "bicgstab"),
    (dict(maxiter=10), "gmres"),
])
def test_krylov_linsolve_auto(rng, monkeypatch, kw, want):
    """'auto' picks CG for SPD, BiCGStab when rounding, else GMRES; each
    solves the system; the rounded one matches ttnx (1e-8)."""
    (jA, jb, jx0), (A, b, x0), x_true = _system(rng)
    picked = []

    def spy(name):
        fn = getattr(tk, name)

        def call(*args, **kwargs):
            picked.append(name)
            return fn(*args, **kwargs)

        return call

    for name in ("gmres_tt", "bicgstab_tt", "cg_tt"):
        monkeypatch.setattr(tk, name, spy(name))
    x = tk.krylov_linsolve(A, b, x0, **kw)
    assert picked == [want + "_tt"]
    assert np.linalg.norm(vec(x) - x_true) < 1e-5
    if "max_bond" in kw:
        assert max(x.ranks) <= kw["max_bond"]
        xj = jk.krylov_linsolve(jA, jb, jx0, **kw)
        assert rel(vec(x), vec(xj)) < 1e-8


def test_unknown_krylov_solver_raises(rng):
    _, (A, b, x0), _ = _system(rng)
    with pytest.raises(ValueError):
        tk.krylov_linsolve(A, b, x0, krylov_solver="nope")


# ---------------------------------------------------------------------------
# Steppers
# ---------------------------------------------------------------------------


def test_explicit_euler_matches_dense():
    (jA, A), (ju0, u0) = heat_setup()
    steps = [1e-3] * 4
    u = ts.euler_method(A, u0, steps, normalize=False)
    dense = vec(ju0)
    for h in steps:
        dense = dense + h * (mat(jA) @ dense)
    assert rel(vec(u), dense) < 1e-10
    uj = js.euler_method(jA, ju0, steps, normalize=False)
    assert rel(vec(u), vec(uj)) < 1e-10


@pytest.mark.parametrize("tt_solver", ["mals", "als", "dmrg", "krylov"])
def test_implicit_euler_matches_dense(rng, tt_solver):
    (jA, A), (ju0, u0) = heat_setup()
    steps = [1e-3] * 3
    jg, g = both(rand_cores(rng, 5, 4))
    kw = ({"max_bond": 8, "rtol": 1e-12, "maxiter": 50}
          if tt_solver == "krylov" else {})
    u = ts.implicit_euler_method(A, u0, g, steps, normalize=False,
                                 tt_solver=tt_solver, **kw)
    uj = js.implicit_euler_method(jA, ju0, jg, steps, normalize=False,
                                  tt_solver=tt_solver, **kw)
    dense = vec(ju0)
    eye = np.eye(dense.size)
    for h in steps:
        dense = np.linalg.solve(eye - h * mat(jA), dense)
    assert rel(vec(u), dense) < 1e-7
    assert rel(vec(u), vec(uj)) < (1e-8 if tt_solver == "krylov" else 1e-10)


@pytest.mark.parametrize("tt_solver", ["mals", "als"])
def test_crank_nicholson_matches_dense(rng, tt_solver):
    (jA, A), (ju0, u0) = heat_setup()
    steps = [1e-3] * 3
    jg, g = both(rand_cores(rng, 5, 4))
    u = ts.crank_nicholson_method(A, u0, g, steps, normalize=False,
                                  tt_solver=tt_solver)
    uj = js.crank_nicholson_method(jA, ju0, jg, steps, normalize=False,
                                   tt_solver=tt_solver)
    dense = vec(ju0)
    Ad, eye = mat(jA), np.eye(dense.size)
    for h in steps:
        dense = np.linalg.solve(eye - h / 2 * Ad, (eye + h / 2 * Ad) @ dense)
    assert rel(vec(u), dense) < 1e-8
    assert rel(vec(u), vec(uj)) < 1e-10


def test_rk4_matches_dense():
    (jA, A), (ju0, u0) = heat_setup()
    steps = [1e-3] * 3
    u = ts.rk4_method(A, u0, steps, max_bond=16, normalize=False)
    dense = vec(ju0)
    Ad = mat(jA)
    for h in steps:
        k1 = Ad @ dense
        k2 = Ad @ (dense + h / 2 * k1)
        k3 = Ad @ (dense + h / 2 * k2)
        k4 = Ad @ (dense + h * k3)
        dense = dense + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    assert rel(vec(u), dense) < 1e-9
    uj = js.rk4_method(jA, ju0, steps, max_bond=16, normalize=False)
    assert rel(vec(u), vec(uj)) < 1e-10


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_explicit_normalize_and_return_error(method):
    (jA, A), (ju0, u0) = heat_setup()
    steps = [1e-3] * 2
    if method == "euler":
        u, err = ts.euler_method(A, u0, steps, return_error=True)
        uj, err_j = js.euler_method(jA, ju0, steps, return_error=True)
    else:
        u, err = ts.rk4_method(A, u0, steps, 8, return_error=True)
        uj, err_j = js.rk4_method(jA, ju0, steps, 8, return_error=True)
    assert abs(float(tx.norm(u)) - 1.0) < 1e-12
    assert rel(vec(u), vec(uj)) < 1e-10
    # both errors sit at rounding level here
    assert abs(err - err_j) <= 1e-6 * abs(err_j) + 1e-13


def test_heat_equation_decay_d8(rng):
    """The heat eigenmode at d = 8 through CN and MALS: the CN factor per
    step (rel 1e-9), and ttnx's state (1e-10)."""
    d = 8
    h_grid = 1.0 / (2 ** d + 1)
    jA, A = both((1.0 / h_grid ** 2) * ttnx.toeplitz_to_qtto(-2.0, 1.0, 1.0,
                                                            d))
    ju0, u0 = both(ttnx.qtt_sin(d, a=h_grid, b=1 - h_grid))
    lam = -4.0 / h_grid ** 2 * np.sin(np.pi * h_grid / 2) ** 2
    dt, n = 1e-8, 5
    jg, g = both(rand_cores(rng, d, 4))
    u = ts.crank_nicholson_method(A, u0, g, [dt] * n, normalize=False,
                                  tt_solver="mals")
    uj = js.crank_nicholson_method(jA, ju0, jg, [dt] * n, normalize=False,
                                   tt_solver="mals")
    factor = (1 + dt * lam / 2) / (1 - dt * lam / 2)
    assert rel(vec(u), factor ** n * vec(ju0)) < 1e-9
    assert rel(vec(u), vec(uj)) < 1e-10


def test_implicit_return_error(rng):
    (jA, A), (ju0, u0) = heat_setup()
    jg, g = both(rand_cores(rng, 5, 4))
    _, err = ts.implicit_euler_method(A, u0, g, [1e-3] * 2, normalize=False,
                                      return_error=True)
    assert err < 1e-6


def test_cn_keeps_float32(rng):
    """A float32 problem stays float32 through the step (ttnx's numpy step
    sizes promote it to float64)."""
    (_, A), (_, u0) = heat_setup()
    _, g = both(rand_cores(rng, 5, 4))
    u = ts.crank_nicholson_method(A.astype(torch.float32),
                                  u0.astype(torch.float32),
                                  g.astype(torch.float32), [1e-3],
                                  normalize=False, tt_solver="als")
    assert u.dtype == torch.float32


def test_unknown_tt_solver(rng):
    (_, A), (_, u0) = heat_setup()
    _, g = both(rand_cores(rng, 5, 2))
    with pytest.raises(ValueError):
        ts.implicit_euler_method(A, u0, g, [1e-3], tt_solver="bogus")
