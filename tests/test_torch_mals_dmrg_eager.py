"""The eager MALS and DMRG tiers of ttnx_torch (``solvers/mals.py``,
``solvers/dmrg.py``) against ttnx on the CPU, in float64.

Mirrors tests/test_mals_dmrg.py (the truncation rules, the MALS linear and
eigen solves, the DMRG linear solve with dense and CG local solves, one-
and two-site, the DMRG eigensolve with its rank schedule) and adds the
LOBPCG branch of both eigensolvers, the CG port against JAX's and the
window pieces. Inputs are numpy arrays from seeds (or ttnx's deterministic
constructors) fed to both packages. Tolerances: port against ttnx 1e-10
with dense local solves, 1e-8 on energies through LOBPCG and on states
through CG; realized ranks exactly; each package against the dense oracle
at the reference test's own tolerance. States are compared as dense
vectors up to sign, never as raw cores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import ttnx
from ttnx.core.tt import TTOperator as JOp
from ttnx.core.tt import TTVector as JVec
from ttnx.solvers import dmrg as jd
from ttnx.solvers import mals as jm

import ttnx_torch as tx
from ttnx_torch.solvers import dmrg as td
from ttnx_torch.solvers import mals as tm
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


def close_up_to_sign(got, ref, tol):
    err = min(np.linalg.norm(got - ref), np.linalg.norm(got + ref))
    assert err <= tol * np.linalg.norm(ref), err


def rand_cores(rng, d, r, orthogonal=False):
    rks = ttnx.r_and_d_to_rks([1] + [r] * (d - 1) + [1], (2,) * d, rmax=r)
    cores = []
    for k in range(d):
        c = rng.standard_normal((rks[k], 2, rks[k + 1])) / np.sqrt(
            2 * rks[k + 1])
        if orthogonal:
            q, _ = np.linalg.qr(c.reshape(rks[k] * 2, rks[k + 1]))
            c = q.reshape(rks[k], 2, -1)
        cores.append(c)
    return cores


def both(obj):
    if isinstance(obj, JOp):
        return obj, ttoperator_from_numpy([np.array(c) for c in obj.cores],
                                          device=CPU)
    if isinstance(obj, JVec):
        return obj, ttvector_from_numpy([np.array(c) for c in obj.cores],
                                        device=CPU)
    return (JVec([jnp.asarray(c) for c in obj]),
            ttvector_from_numpy(obj, device=CPU))


def rhs_of(jA, u):
    """``b = A u`` as a TT-SVD of the dense product, in both packages."""
    return both(ttnx.ttv_decomp((mat(jA) @ u).reshape((2,) * jA.N),
                                tol=1e-14))


def sampled(f, d):
    return np.asarray(ttnx.qtt_to_vector(ttnx.function_to_qtt(f, d)))


# ---------------------------------------------------------------------------
# Truncation rules (host numpy in both packages)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,tol,want", [
    ([3.0, 2.0, 1.0, 0.1], 0.0, 4),
    ([3.0, 2.0, 1.0], 2.0 / 14.0, 2),  # tail weight 1 < 2 dropped
    ([1.0, 0.5, 0.25, 1e-9], 1e-12, 3),
])
def test_sv_trunc_count(s, tol, want):
    s = np.array(s)
    assert tm.sv_trunc_count(s, tol) == jm.sv_trunc_count(s, tol) == want


@pytest.mark.parametrize("s,tol,want", [
    ([1.0, 0.5, 0.5 - 1e-12, 1e-8], 1e-4, 3),  # keeps both degenerate
    ([1.0, 0.1, 1e-14], 1e-10, 2),
])
def test_cut_off_index(s, tol, want):
    s = np.array(s)
    assert td.cut_off_index(s, tol) == jd.cut_off_index(s, tol) == want


# ---------------------------------------------------------------------------
# MALS
# ---------------------------------------------------------------------------


def test_mals_identity_system(rng):
    d = 6
    jA, A = both(ttnx.id_tto(d))
    jb, b = both(ttnx.qtt_sin(d))
    jx0, x0 = both(rand_cores(rng, d, 2))
    x = tm.mals_linsolve(A, b, x0, tol=1e-12)
    xj = jm.mals_linsolve(jA, jb, jx0, tol=1e-12)
    assert rel(vec(x), vec(b)) < 1e-10
    assert x.ranks == xj.ranks
    assert rel(vec(x), vec(xj)) < 1e-10


def test_mals_poisson_1d(rng):
    """1-D Poisson, d = 8, two MALS calls: rel 1e-7 to the sampled sine."""
    d = 8
    h = 1.0 / (2 ** d - 1)
    jA, A = both((1.0 / h ** 2) * ttnx.laplacian(d))
    u = sampled(lambda x: np.sin(np.pi * x), d)
    jb, b = rhs_of(jA, u)
    jx0, x0 = both(rand_cores(rng, d, 4))
    x = tm.mals_linsolve(A, b, x0, tol=1e-12, rmax=16)
    x = tm.mals_linsolve(A, b, x, tol=1e-12, rmax=16)
    xj = jm.mals_linsolve(jA, jb, jx0, tol=1e-12, rmax=16)
    xj = jm.mals_linsolve(jA, jb, xj, tol=1e-12, rmax=16)
    assert rel(vec(x), u) < 1e-7
    assert x.ranks == xj.ranks
    assert rel(vec(x), vec(xj)) < 1e-10


@pytest.mark.parametrize("rmax", [2, 3])
def test_mals_rank_adaptation_respects_rmax(rng, rmax):
    d = 6
    jA, A = both(ttnx.laplacian(d))
    jb, b = both(ttnx.qtt_sin(d))
    jx0, x0 = both(rand_cores(rng, d, 2))
    x = tm.mals_linsolve(A, b, x0, tol=1e-14, rmax=rmax)
    xj = jm.mals_linsolve(jA, jb, jx0, tol=1e-14, rmax=rmax)
    assert max(x.ranks) <= rmax and x.ranks == xj.ranks
    close_up_to_sign(vec(x), vec(xj), 1e-10)


def test_mals_return_info(rng):
    d = 5
    _, A = both(ttnx.id_tto(d))
    _, b = both(ttnx.qtt_sin(d))
    _, x0 = both(rand_cores(rng, d, 2))
    _, info = tm.mals_linsolve(A, b, x0, return_info=True)
    assert info["residual"] < 1e-6  # a TT residual's floor is sqrt(eps)


@pytest.mark.parametrize("op,d,sweeps,rmax,tol", [
    ("laplacian", 6, 4, 10, 1e-8), ("heisenberg", 6, 5, 12, 1e-7)])
def test_mals_ground_state(rng, op, d, sweeps, rmax, tol):
    jA, A = both(ttnx.laplacian(d) if op == "laplacian"
                 else ttnx.heisenberg_xyz_tto(d))
    jx0, x0 = both(rand_cores(rng, d, 2, orthogonal=True))
    kw = dict(tol=1e-12, sweep_schedule=[sweeps], rmax_schedule=[rmax])
    E, x, r_hist = tm.mals_eigsolve(A, x0, **kw)
    Ej, xj, r_hist_j = jm.mals_eigsolve(jA, jx0, **kw)
    w0 = np.linalg.eigvalsh(mat(jA))[0]
    assert abs(E[-1] - w0) < tol
    assert len(r_hist) == len(E) and max(r_hist) <= rmax
    assert abs(E[-1] - Ej[-1]) <= 1e-10 * abs(w0)
    assert list(r_hist) == list(r_hist_j)
    close_up_to_sign(vec(x), vec(xj), 1e-8)


def test_mals_lobpcg_branch(rng):
    """``it_solver=True`` takes LOBPCG: energies 1e-8 from ttnx's and from
    the dense spectrum."""
    d = 6
    jA, A = both(ttnx.heisenberg_xyz_tto(d, jx=1.0, jy=0.5, jz=0.25))
    jx0, x0 = both(rand_cores(rng, d, 2, orthogonal=True))
    kw = dict(tol=1e-12, sweep_schedule=[4], rmax_schedule=[8],
              it_solver=True)
    E, x, r_hist = tm.mals_eigsolve(A, x0, **kw)
    Ej, _, r_hist_j = jm.mals_eigsolve(jA, jx0, **kw)
    w0 = np.linalg.eigvalsh(mat(jA))[0]
    assert abs(E[-1] - Ej[-1]) <= 1e-8 * abs(w0)
    assert abs(E[-1] - w0) <= 1e-7 * abs(w0)
    assert list(r_hist) == list(r_hist_j)


def test_mals_schedule_validation(rng):
    _, A = both(ttnx.laplacian(4))
    _, x0 = both(rand_cores(rng, 4, 2))
    with pytest.raises(ValueError):
        tm.mals_eigsolve(A, x0, sweep_schedule=[2, 3], rmax_schedule=[2])


# ---------------------------------------------------------------------------
# DMRG linear solve
# ---------------------------------------------------------------------------


def test_dmrg_identity_system(rng):
    d = 6
    jA, A = both(ttnx.id_tto(d))
    jb, b = both(ttnx.qtt_sin(d))
    jx0, x0 = both(rand_cores(rng, d, 2))
    kw = dict(sweep_schedule=[2], it_solver=False)
    x = td.dmrg_linsolve(A, b, x0, **kw)
    xj = jd.dmrg_linsolve(jA, jb, jx0, **kw)
    assert rel(vec(x), vec(b)) < 1e-10
    assert x.ranks == xj.ranks and rel(vec(x), vec(xj)) < 1e-10


@pytest.mark.parametrize("it_solver", [False, True])
def test_dmrg_laplacian_system(rng, it_solver):
    """The reference's case takes CG above ``itslv_thresh = 64``: the port
    against ttnx's dense local solves (1e-8 through CG; ttnx's own CG
    branch applies another operator, ROADMAP C)."""
    d = 6
    jA, A = both(ttnx.laplacian(d))
    u = sampled(lambda x: np.sin(np.pi * x) * (1 - x), d)
    jb, b = rhs_of(jA, u)
    jx0, x0 = both(rand_cores(rng, d, 3))
    kw = dict(sweep_schedule=[4], itslv_thresh=64, return_info=True)
    x, info = td.dmrg_linsolve(A, b, x0, it_solver=it_solver, **kw)
    xj, _ = jd.dmrg_linsolve(jA, jb, jx0, it_solver=False, **kw)
    assert info["residual"] < 1e-6
    assert x.ranks == xj.ranks
    assert rel(vec(x), vec(xj)) < (1e-8 if it_solver else 1e-10)


@pytest.mark.parametrize("complex_", [False, True])
def test_dmrg_cg_operator_is_the_hermitian_part(rng, monkeypatch, complex_):
    """The matrix-free operator CG sees is ``(K + K^H) / 2`` of the dense
    local matrix (1e-12), on random environments and a random two-site
    window operator (its bond legs of different sizes)."""
    import ttnx_torch.solvers.als as ta

    def arr(*shape):
        a = rng.standard_normal(shape)
        return a + 1j * rng.standard_normal(shape) if complex_ else a

    r, rr, ra, rb = 3, 2, 4, 5
    L, Am, R = arr(r, ra, r), arr(ra, 4, 4, rb), arr(rr, rb, rr)
    L, Am, R = (torch.as_tensor(a) for a in (L, Am, R))
    K = ta.local_matrix(L, Am, R)
    seen = []

    def spy(op, b, x0, tol, maxiter):
        v = torch.as_tensor(arr(*b.shape))
        seen.append((op(v), v))
        return x0, None

    monkeypatch.setattr(td, "cg", spy)
    td._local_solve(L, Am, R, torch.ones((r, 1), dtype=L.dtype),
                    torch.ones((1, 4, 1), dtype=L.dtype),
                    torch.ones((rr, 1), dtype=L.dtype),
                    torch.zeros((r, 4, rr), dtype=L.dtype), True, 8, 10,
                    1e-8)
    got, v = seen[0]
    want = (0.5 * (K + K.conj().T)) @ v.reshape(-1)
    assert torch.allclose(got.reshape(-1), want, atol=1e-12, rtol=0)


@pytest.mark.parametrize("sweeps", [3, 4])
def test_dmrg_single_site(rng, sweeps):
    """One-site DMRG pads the start to the schedule's rank first."""
    d = 5
    jA, A = both(ttnx.id_tto(d))
    jb, b = both(ttnx.qtt_sin(d))
    jx0, x0 = both(rand_cores(rng, d, 2))
    kw = dict(n_sites=1, sweep_schedule=[sweeps], rmax_schedule=[4],
              it_solver=False)
    x = td.dmrg_linsolve(A, b, x0, **kw)
    xj = jd.dmrg_linsolve(jA, jb, jx0, **kw)
    assert rel(vec(x), vec(b)) < 1e-9
    assert x.ranks == xj.ranks and rel(vec(x), vec(xj)) < 1e-10


def test_cg_port_matches_jax(rng):
    """``core.linalg.cg`` stops where ``jax.scipy.sparse.linalg.cg`` does:
    the same iterate (1e-10: cond(S) ~ 1e4 amplifies the rounding of the
    two summation orders) at a tolerance it reaches and at a maxiter it
    hits first."""
    from jax.scipy.sparse.linalg import cg as jcg
    from ttnx_torch.core.linalg import cg as tcg

    m = 60
    G = rng.standard_normal((m, m))
    S = G @ G.T + 0.5 * np.eye(m)
    b, x0 = rng.standard_normal(m), rng.standard_normal(m)
    for tol, maxiter in ((1e-10, 500), (1e-14, 7)):
        xj, _ = jcg(lambda v: jnp.asarray(S) @ v, jnp.asarray(b),
                    x0=jnp.asarray(x0), tol=tol, maxiter=maxiter)
        xt, _ = tcg(lambda v: torch.as_tensor(S) @ v, torch.as_tensor(b),
                    x0=torch.as_tensor(x0), tol=tol, maxiter=maxiter)
        assert rel(xt.numpy(), np.asarray(xj)) < 1e-10


def test_dmrg_window_pieces(rng):
    """The window operator and rhs, and both window splits, against ttnx
    (splits compared as products and ranks: SVD signs are a gauge)."""
    d = 5
    jA, A = both(ttnx.heisenberg_xyz_tto(d))
    jb, b = both(rand_cores(rng, d, 3))
    for i, n in ((0, 2), (1, 3)):
        assert np.abs(td._amid(A, i, n).numpy()
                      - np.asarray(jd._amid(jA, i, n))).max() <= 1e-13
        assert np.abs(td._bmid(b, i, n).numpy()
                      - np.asarray(jd._bmid(jb, i, n))).max() <= 1e-13
    V = rng.standard_normal((3, 8, 2))
    V[:, :, 1] *= 1e-9  # a small tail for the cut-off to drop
    for split in ("_split_window_right", "_split_window_left"):
        core, mv, keep = getattr(td, split)(torch.as_tensor(V), (2, 2, 2),
                                            1e-6, 8)
        jcore, jmv, jkeep = getattr(jd, split)(jnp.asarray(V), (2, 2, 2),
                                               1e-6, 8)
        assert keep == jkeep
        if split.endswith("right"):
            prod = torch.einsum("anb,bmc->anmc", core, mv).numpy()
            jprod = np.einsum("anb,bmc->anmc", jcore, jmv)
        else:
            prod = torch.einsum("amb,bnc->amnc", mv, core).numpy()
            jprod = np.einsum("amb,bnc->amnc", jmv, jcore)
        assert np.abs(prod - jprod).max() <= 1e-12


# ---------------------------------------------------------------------------
# DMRG eigensolve
# ---------------------------------------------------------------------------


def test_dmrg_laplacian_ground_state(rng):
    d = 6
    jA, A = both(ttnx.laplacian(d))
    jx0, x0 = both(rand_cores(rng, d, 2, orthogonal=True))
    kw = dict(sweep_schedule=[4], rmax_schedule=[10])
    E, x, r_hist = td.dmrg_eigsolve(A, x0, **kw)
    Ej, xj, r_hist_j = jd.dmrg_eigsolve(jA, jx0, **kw)
    w0 = np.linalg.eigvalsh(mat(jA))[0]
    assert abs(E[-1] - w0) < 1e-8
    assert abs(E[-1] - Ej[-1]) <= 1e-10 * abs(w0)
    assert list(r_hist) == list(r_hist_j)
    close_up_to_sign(vec(x), vec(xj), 1e-8)


def test_dmrg_heisenberg_vs_dense(rng):
    """A field-carrying XYZ chain at d = 8 with a rank schedule [8, 16]."""
    d = 8
    jA, A = both(ttnx.heisenberg_xyz_tto(d, jx=1.0, jy=0.5, jz=0.25,
                                         lam=0.1, field="z"))
    jx0, x0 = both(rand_cores(rng, d, 2, orthogonal=True))
    kw = dict(sweep_schedule=[2, 5], rmax_schedule=[8, 16], tol=1e-12)
    E, x, r_hist = td.dmrg_eigsolve(A, x0, **kw)
    Ej, _, r_hist_j = jd.dmrg_eigsolve(jA, jx0, **kw)
    w0 = np.linalg.eigvalsh(mat(jA))[0]
    assert abs(E[-1] - w0) < 1e-7
    assert abs(E[-1] - Ej[-1]) <= 1e-10 * abs(w0)
    assert list(r_hist) == list(r_hist_j)


def test_dmrg_lobpcg_branch(rng):
    """``it_solver=True`` on the XXX chain (d = 8, rmax 16): LOBPCG above
    the threshold, dense below it; energies 1e-8 from ttnx's."""
    d = 8
    jA, A = both(ttnx.heisenberg_xyz_tto(d))
    jx0, x0 = both(rand_cores(rng, d, 4, orthogonal=True))
    kw = dict(sweep_schedule=[3], rmax_schedule=[16], it_solver=True,
              itslv_thresh=64, tol=1e-10)
    E, x, r_hist = td.dmrg_eigsolve(A, x0, **kw)
    Ej, _, r_hist_j = jd.dmrg_eigsolve(jA, jx0, **kw)
    w0 = np.linalg.eigvalsh(mat(jA))[0]
    assert np.abs(E - Ej).max() <= 1e-8 * abs(w0)
    assert abs(E[-1] - w0) <= 1e-8 * abs(w0)
    assert list(r_hist) == list(r_hist_j)


def test_dmrg_eigval_history_monotone(rng):
    d = 6
    _, A = both(ttnx.laplacian(d))
    _, x0 = both(rand_cores(rng, d, 3, orthogonal=True))
    E, _, _ = td.dmrg_eigsolve(A, x0, sweep_schedule=[3], rmax_schedule=[8])
    assert E[-1] <= E[0] + 1e-12


def test_dmrg_schedule_validation(rng):
    _, A = both(ttnx.laplacian(4))
    _, x0 = both(rand_cores(rng, 4, 2))
    with pytest.raises(ValueError):
        td.dmrg_eigsolve(A, x0, sweep_schedule=[2, 3], rmax_schedule=[2])
