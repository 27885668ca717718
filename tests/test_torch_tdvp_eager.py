"""The eager TDVP tier of ttnx_torch (``solvers/tdvp.py``) against ttnx on
the CPU.

Mirrors tests/test_tdvp.py: the identity and scalar Hamiltonians, the 2-D
heat eigenmode in imaginary time (1- and 2-site), the returned residual,
rank control, the environment cache and the dense real-time oracle; adds
the local operators one by one. Inputs are ttnx's deterministic
constructors fed to both packages through ``ttnx_torch.utils.convert``.
Both packages compute in complex128 or float64 whatever the input dtype.
Tolerances: port against ttnx 1e-10 on dense states (QR and SVD signs are
a gauge, so cores are never compared), each against the oracle at the
reference test's own tolerance.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from threadpoolctl import threadpool_limits

import ttnx
from ttnx.core.tt import TTOperator as JOp
from ttnx.core.tt import TTVector as JVec

import ttnx_torch as tx
from ttnx_torch.utils.convert import ttoperator_from_numpy, ttvector_from_numpy

# both packages export the function ``tdvp`` from ``solvers``, which hides
# the module of the same name there
jt = importlib.import_module("ttnx.solvers.tdvp")
tt = importlib.import_module("ttnx_torch.solvers.tdvp")

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


def vec(x):
    if isinstance(x, JVec):
        return np.asarray(ttnx.ttv_to_tensor(x)).reshape(-1)
    return tx.ttv_to_tensor(x).reshape(-1).numpy()


def rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def both(obj):
    cores = [np.array(c) for c in obj.cores]
    if isinstance(obj, JOp):
        return obj, ttoperator_from_numpy(cores, device=CPU)
    return obj, ttvector_from_numpy(cores, device=CPU)


def sine(d, **kw):
    return both(ttnx.qtt_sin(d, lam=np.pi, **kw))


# ---------------------------------------------------------------------------
# Local operators
# ---------------------------------------------------------------------------


def test_local_operators_match_ttnx(rng):
    """The 0-, 1- and 2-site effective Hamiltonians and both environment
    updates on random complex tensors (1e-12)."""

    def arr(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    r, ra = 3, 2
    FL, FR = arr(r, ra, r), arr(r, ra, r)
    M1, M2 = arr(ra, 2, ra, 2), arr(ra, 2, ra, 2)
    A, C, AAC = arr(r, 2, r), arr(r, r), arr(r, 2, 2, r)
    pairs = [
        (jt._apply_h1(A, FL, FR, M1), tt._apply_h1, (A, FL, FR, M1)),
        (jt._apply_h0(C, FL, FR), tt._apply_h0, (C, FL, FR)),
        (jt._apply_h2(AAC, FL, FR, M1, M2), tt._apply_h2,
         (AAC, FL, FR, M1, M2)),
        (jt._update_left_env(A, M1, FL), tt._update_left_env, (A, M1, FL)),
        (jt._update_right_env(A, M1, FR), tt._update_right_env,
         (A, M1, FR)),
    ]
    for ref, fn, args in pairs:
        ref = np.asarray(ref)
        got = fn(*[torch.as_tensor(a) for a in args]).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# Identity and scalar Hamiltonians
# ---------------------------------------------------------------------------


def test_zero_hamiltonian_is_identity():
    d = 4
    jpsi, psi0 = both(ttnx.orthogonalize(ttnx.qtt_sin(d, lam=np.pi), 0)
                      .astype(jnp.complex128))
    _, H0 = both(0.0 * ttnx.id_tto(d, dtype=jnp.complex128))
    psi = tt.tdvp(H0, psi0, [0.1], normalize=False, carry_env=False)
    assert psi.dtype == torch.complex128
    assert rel(vec(psi), vec(jpsi)) < 1e-10


def test_tdvp2_imaginary_time_zero_hamiltonian():
    d = 4
    jpsi, psi0 = both(ttnx.orthogonalize(ttnx.qtt_sin(d, lam=np.pi), 0)
                      .astype(jnp.complex128))
    _, H0 = both(0.0 * ttnx.id_tto(d, dtype=jnp.complex128))
    psi = tt.tdvp2(H0, psi0, [0.02, 0.02], normalize=False, sweeps=2,
                   imaginary_time=True)
    assert rel(vec(psi), vec(jpsi)) < 1e-10


@pytest.mark.parametrize("driver", ["tdvp", "tdvp2"])
def test_scalar_hamiltonian_phase(driver):
    """``H = c I`` evolves by the global phase ``e^{-i c t}``; real input
    is made complex."""
    d, c, t = 4, 0.5, 0.05
    jH, H = both(c * ttnx.id_tto(d))
    ju0, u0 = sine(d)
    fn = getattr(tt, driver)
    psi = fn(H, u0, [t], normalize=False)
    assert psi.dtype == torch.complex128
    expect = np.exp(-1j * c * t) * vec(ju0)
    assert rel(vec(psi), expect) < 1e-10
    ref = getattr(jt, driver)(jH, ju0, [t], normalize=False)
    assert rel(vec(psi), vec(ref)) < 1e-10


# ---------------------------------------------------------------------------
# The 2-D heat eigenmode in imaginary time
# ---------------------------------------------------------------------------


def _heat2d():
    d = 4
    h = 1.0 / (2 ** d + 1)
    lap = ttnx.toeplitz_to_qtto(-2.0, 1.0, 1.0, d)
    A = (0.1 / h ** 2) * (ttnx.kron_tto(lap, ttnx.id_tto(d))
                          + ttnx.kron_tto(ttnx.id_tto(d), lap))
    s = ttnx.qtt_sin(d, a=h, b=1 - h)
    u0 = ttnx.kron_tt(s, s)
    lam = float(np.real(ttnx.dot(u0, A @ u0) / ttnx.dot(u0, u0)))
    return both(A), both(u0), lam


@pytest.mark.parametrize("driver,kw", [
    ("tdvp", {}), ("tdvp2", dict(max_bond=8, truncerr=1e-12))])
def test_heat_eigenmode(driver, kw):
    (jA, A), (ju0, u0), lam = _heat2d()
    steps = [1e-3] * 5
    target = np.exp(lam * sum(steps)) * vec(ju0)
    sol = getattr(tt, driver)(A, u0, steps, imaginary_time=True,
                              normalize=False, **kw)
    ref = getattr(jt, driver)(jA, ju0, steps, imaginary_time=True,
                              normalize=False, **kw)
    assert rel(vec(sol), target) < 1e-8
    assert rel(vec(sol), vec(ref)) < 1e-10


# ---------------------------------------------------------------------------
# Returned residual, rank control, environment cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("imaginary_time", [False, True])
def test_residual_small_for_eigenstate(imaginary_time):
    d = 4
    _, A = both(0.5 * ttnx.id_tto(d))
    _, u0 = sine(d)
    steps = [1e-3] * 5
    _, e1 = tt.tdvp(A, u0, steps, imaginary_time=imaginary_time,
                    return_error=True, normalize=False)
    _, e2 = tt.tdvp2(A, u0, steps, imaginary_time=imaginary_time,
                     return_error=True, normalize=False, max_bond=8,
                     truncerr=1e-12)
    # a finite-difference residual of TT norms: the reference's bound, no
    # closer comparison (its size is set by rounding)
    assert e1 < 1e-3 and e2 < 1e-3


def test_tdvp2_max_bond():
    d = 6
    jlap, lap = both(ttnx.toeplitz_to_qtto(-2.0, 1.0, 1.0, d))
    ju0, u0 = both(ttnx.qtt_sin(d))
    sol = tt.tdvp2(lap, u0, [1e-3] * 3, imaginary_time=True, normalize=False,
                   max_bond=3)
    ref = jt.tdvp2(jlap, ju0, [1e-3] * 3, imaginary_time=True,
                   normalize=False, max_bond=3)
    assert max(sol.ranks) <= 3 and sol.ranks == ref.ranks
    assert rel(vec(sol), vec(ref)) < 1e-10


def test_carry_env_consistency():
    d = 5
    _, lap = both(ttnx.toeplitz_to_qtto(-2.0, 1.0, 1.0, d)
                  .astype(jnp.complex128))
    _, u0 = both(ttnx.qtt_sin(d).astype(jnp.complex128))
    a = tt.tdvp(lap, u0, [0.1, 0.1], normalize=False, sweeps=2,
                carry_env=True)
    b = tt.tdvp(lap, u0, [0.1, 0.1], normalize=False, sweeps=2,
                carry_env=False)
    assert float(tx.norm(tx.sub(a, b)) / tx.norm(b)) < 1e-9


def test_dense_oracle_small():
    """Real-time evolution against the dense expm: 1-site TDVP keeps the
    rank-2 manifold (projection error), 2-site at full rank tracks it."""
    d, t, n = 4, 0.01, 5
    jH, H = both(ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d))
    ju0, u0 = both(ttnx.qtt_sin(d))
    Hd = np.asarray(ttnx.qtto_to_matrix(jH))
    expect = scipy.linalg.expm(-1j * Hd * t * n) @ vec(ju0)
    sol1 = tt.tdvp(H, u0, [t] * n, normalize=False)
    sol2 = tt.tdvp2(H, u0, [t] * n, normalize=False, max_bond=16)
    err1, err2 = rel(vec(sol1), expect), rel(vec(sol2), expect)
    assert err1 < 2e-2 and err2 < 1e-5 and err2 < err1
    assert rel(vec(sol1), vec(jt.tdvp(jH, ju0, [t] * n,
                                      normalize=False))) < 1e-10
    assert rel(vec(sol2), vec(jt.tdvp2(jH, ju0, [t] * n, normalize=False,
                                       max_bond=16))) < 1e-10


def test_sweeps_return_env_cache():
    """One sweep of each kind returns the state and a full environment
    list; feeding the cache back gives the carried-env result."""
    d = 4
    jH, H = both(ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d))
    ju0, u0 = both(ttnx.orthogonalize(ttnx.qtt_sin(d), 0))
    for sweep, jsweep in ((tt.tdvp1sweep, jt.tdvp1sweep),
                          (tt.tdvp2sweep, jt.tdvp2sweep)):
        psi, F = sweep(0.01, u0, H)
        ref, _ = jsweep(0.01, ju0, jH)
        assert len(F) == d + 2
        assert rel(vec(psi), vec(ref)) < 1e-10
