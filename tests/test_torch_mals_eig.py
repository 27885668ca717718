"""Slice 13 of ttnx_torch: the scan-tier ALS eigensolve and the
rank-adaptive MALS against ttnx on the CPU, in float64.

Mirrors tests/test_mals_scan.py (without its two jit-cache checks, a
property of JAX; the eager ``mals_linsolve`` is not ported yet, so
``test_matches_eager_mals`` holds the port to ttnx's ``mals_linsolve_scan``
and to the closed form) and TestScanEigsolve of
tests/test_scan_parallel.py, plus the local pieces one by one. Inputs are
numpy arrays from seeds, fed to both packages. Tolerances: the reference
tests' own against the closed forms and dense spectra; port against ttnx
1e-10 on energies, realized ranks exactly, dense states 1e-8 up to sign
(eigh, QR and SVD signs are a gauge, and so are raw cores: they are never
compared). On the CPU kernel B8 takes its plain version, so forcing the
ALS env stacks through ``env_chain_A_plain`` must give the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import ttnx
from ttnx.core.tt import TTVector as JVec
from ttnx.solvers import als_scan as ja
from ttnx.solvers import mals_scan as jm

import ttnx_torch as tx
from ttnx_torch.kernels.env_chain import env_chain_A_plain
from ttnx_torch.solvers import als_scan as ta
from ttnx_torch.solvers import mals_scan as tm
from ttnx_torch.utils.convert import (stack_from_numpy, ttoperator_from_numpy,
                                      ttvector_from_numpy)

CPU = torch.device("cpu")


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


def _t(a):
    return stack_from_numpy(np.array(a), device=CPU)


def vec(tt):
    if isinstance(tt, JVec):
        return np.asarray(ttnx.ttv_to_tensor(tt)).reshape(-1)
    return _np(tx.ttv_to_tensor(tt)).reshape(-1)


def close_up_to_sign(got, ref, tol):
    got, ref = np.asarray(got).reshape(-1), np.asarray(ref).reshape(-1)
    err = min(np.linalg.norm(got - ref), np.linalg.norm(got + ref))
    assert err <= tol * np.linalg.norm(ref), err


def rand_cores(rng, d, r, orthogonal=False):
    """Normalized random TT cores (numpy), left-orthonormal when
    ``orthogonal``, as ``rand_tt(..., normalise=True)`` builds them."""
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


def tt_both(cores):
    return (JVec([jnp.asarray(c) for c in cores]),
            ttvector_from_numpy(cores, device=CPU))


def op_both(j_op):
    """A ttnx operator and the port's copy of it."""
    cores = [np.array(c) for c in j_op.cores]
    return j_op, ttoperator_from_numpy(cores, device=CPU)


def _system(rng, d=6):
    """The reference's MALS system: the Dirichlet Laplacian, the sampled
    sine as the exact solution, ``b`` its TT-SVD, a rank-4 start."""
    jA, A = op_both(ttnx.laplacian(d))
    u = np.asarray(ttnx.qtt_to_vector(ttnx.function_to_qtt(
        lambda x: np.sin(np.pi * x), d)))
    bd = (np.asarray(ttnx.qtto_to_matrix(jA)) @ u).reshape((2,) * d)
    jb, b = ttnx.ttv_decomp(bd, tol=1e-14), tx.ttv_decomp(bd, tol=1e-14,
                                                          device=CPU)
    jx0, x0 = tt_both(rand_cores(rng, d, 4))
    return (jA, jb, jx0), (A, b, x0), u


# ---------------------------------------------------------------------------
# MALS (tests/test_mals_scan.py)
# ---------------------------------------------------------------------------


def test_matches_eager_mals(rng):
    (jA, jb, jx0), (A, b, x0), u = _system(rng)
    xs = tm.mals_linsolve_scan(A, b, x0, tol=1e-12, rmax=16, n_sweeps=2)
    rel = np.linalg.norm(vec(xs) - u) / np.linalg.norm(u)
    assert rel < 1e-10
    xj = jm.mals_linsolve_scan(jA, jb, jx0, tol=1e-12, rmax=16, n_sweeps=2)
    assert xs.ranks == xj.ranks  # identical adapted ranks
    close_up_to_sign(vec(xs), vec(xj), 1e-10)


def test_identity_system(rng):
    d = 6
    jx0, x0 = tt_both(rand_cores(rng, d, 4))
    b = tx.qtt_sin(d, device=CPU)
    x = tm.mals_linsolve_scan(tx.id_tto(d, device=CPU), b, x0, tol=1e-12,
                              rmax=8)
    rel = np.linalg.norm(vec(x) - vec(b)) / np.linalg.norm(vec(b))
    assert rel < 1e-10
    assert x.ranks == b.ranks  # adapts down to the rhs rank
    xj = jm.mals_linsolve_scan(ttnx.id_tto(d), ttnx.qtt_sin(d), jx0,
                               tol=1e-12, rmax=8)
    assert x.ranks == xj.ranks


def test_default_rmax_and_tol(rng):
    """``rmax`` defaults to min(round(sqrt(prod dims)), 64) and ``tol`` to
    1e-12, as in the reference; a looser tol realizes lower ranks in both
    packages alike."""
    (jA, jb, jx0), (A, b, x0), u = _system(rng, d=4)
    x = tm.mals_linsolve_scan(A, b, x0)
    xj = jm.mals_linsolve_scan(jA, jb, jx0)
    assert x.ranks == xj.ranks
    close_up_to_sign(vec(x), vec(xj), 1e-10)
    assert np.linalg.norm(vec(x) - u) < 1e-10 * np.linalg.norm(u)
    x6 = tm.mals_linsolve_scan(A, b, x0, tol=1e-6)
    assert x6.ranks == jm.mals_linsolve_scan(jA, jb, jx0, tol=1e-6).ranks


def test_eigsolve_heisenberg(rng):
    d = 6
    jH, H = op_both(ttnx.heisenberg_xyz_tto(d))
    jx0, x0 = tt_both(rand_cores(rng, d, 2, orthogonal=True))
    E, x = tm.mals_eigsolve_scan(H, x0, tol=1e-12, rmax=12, n_sweeps=4)
    w = np.linalg.eigvalsh(np.asarray(ttnx.qtto_to_matrix(jH)))
    assert abs(E[-1] - w[0]) < 1e-10
    assert max(x.ranks) > 2  # ranks adapted beyond the rank-2 start
    assert all(e >= w[0] - 1e-9 for e in E)  # variational throughout
    Ej, xj = jm.mals_eigsolve_scan(jH, jx0, tol=1e-12, rmax=12, n_sweeps=4)
    assert len(E) == len(Ej) == 4 * 2 * (d - 1)
    assert np.max(np.abs(E - np.asarray(Ej))) <= 1e-10 * abs(w[0])
    assert x.ranks == xj.ranks
    close_up_to_sign(vec(x), vec(xj), 1e-8)


def test_mals_sweep_one_sweep(rng):
    """One sweep on the packed stacks: the same realized masks and the same
    represented state as ttnx's ``mals_sweep``."""
    d, R = 5, 8
    (jA, jb, jx0), (A, b, x0), _ = _system(rng, d=d)
    x = tx.orthogonalize(x0, 0)
    stacks = (ta.pack_op(A, 3), ta.pack_tt(b, max(b.ranks)),
              ta.pack_tt(x, R))
    masks = ta.rank_masks(x.ranks, R, device=CPU)
    xs, ms = tm.mals_sweep(*stacks, masks, 1e-12)
    xj, mj = jm.mals_sweep(*(jnp.asarray(_np(s)) for s in stacks),
                           jnp.asarray(_np(masks)), 1e-12)
    assert np.array_equal(_np(ms), np.asarray(mj))
    rks = [int(v) for v in _np(ms).sum(axis=1)]
    close_up_to_sign(vec(ta.unpack_tt(xs, rks)),
                     vec(ja.unpack_tt(xj, rks)), 1e-10)


def test_mals_eig_sweep_one_sweep(rng):
    # d even: the open XXX chain's ground state is a singlet, not the
    # degenerate doublet of odd d, so the state itself is comparable
    d, R = 6, 8
    jH, H = op_both(ttnx.heisenberg_xyz_tto(d))
    x = tx.orthogonalize(tt_both(rand_cores(rng, d, 2, orthogonal=True))[1],
                         0)
    A_stack, x_stack = ta.pack_op(H, 5), ta.pack_tt(x, R)
    masks = ta.rank_masks(x.ranks, R, device=CPU)
    xs, ms, lams = tm.mals_eig_sweep(A_stack, x_stack, masks, 1e-12)
    xj, mj, lj = jm.mals_eig_sweep(jnp.asarray(_np(A_stack)),
                                   jnp.asarray(_np(x_stack)),
                                   jnp.asarray(_np(masks)), 1e-12)
    assert np.array_equal(_np(ms), np.asarray(mj))
    assert np.max(np.abs(_np(lams) - np.asarray(lj))) <= 1e-10 * 10
    rks = [int(v) for v in _np(ms).sum(axis=1)]
    close_up_to_sign(vec(ta.unpack_tt(xs, rks)),
                     vec(ja.unpack_tt(xj, rks)), 1e-8)


def test_keep_mask():
    rng = np.random.default_rng(7)
    for s in (np.sort(rng.random(12))[::-1], np.r_[1.0, 1e-7, 1e-9,
                                                   np.zeros(5)],
              np.zeros(6)):
        for tol in (1e-12, 1e-6, 0.5):
            got = _np(tm._keep_mask(_t(s), tol))
            ref = np.asarray(jm._keep_mask(jnp.asarray(s), tol, len(s)))
            assert np.array_equal(got, ref)


def _masked_problem(rng, R, RA, n, rl, rr, ra=3):
    """Random local operator pieces with symmetric envs (``L[a, W, b] =
    L[b, W, a]``), an MPO symmetric in its physical legs, and rank masks of
    ``rl`` and ``rr`` active entries."""
    def env():
        e = rng.standard_normal((R, RA, R))
        return e + e.transpose(2, 1, 0)

    Ai = rng.standard_normal((RA, n, n, RA))
    Aj = rng.standard_normal((RA, n, n, RA))
    Ai, Aj = Ai + Ai.transpose(0, 2, 1, 3), Aj + Aj.transpose(0, 2, 1, 3)
    m_l, m_r = np.zeros(R), np.zeros(R)
    m_l[:rl], m_r[:rr] = 1.0, 1.0
    return dict(L=env(), Ai=Ai, Aj=Aj, Renv=env(), m_l=m_l, m_r=m_r,
                Lb=rng.standard_normal((R, ra)),
                bi=rng.standard_normal((ra, n, ra)),
                bj=rng.standard_normal((ra, n, ra)),
                Rb=rng.standard_normal((R, ra)))


def test_local2_solve_and_eigmin(rng):
    p = _masked_problem(rng, 6, 3, 2, 4, 3)
    args = ("L", "Ai", "Aj", "Renv", "Lb", "bi", "bj", "Rb", "m_l", "m_r")
    got = _np(tm._local2_solve(*(_t(p[k]) for k in args)))
    ref = np.asarray(jm._local2_solve(*(jnp.asarray(p[k]) for k in args)))
    assert np.max(np.abs(got - ref)) <= 1e-10 * np.max(np.abs(ref))
    eargs = ("L", "Ai", "Aj", "Renv", "m_l", "m_r")
    lam, V = tm._local2_eigmin(*(_t(p[k]) for k in eargs))
    lj, Vj = jm._local2_eigmin(*(jnp.asarray(p[k]) for k in eargs))
    assert abs(float(lam) - float(lj)) <= 1e-10 * abs(float(lj))
    close_up_to_sign(_np(V), np.asarray(Vj), 1e-8)


def test_local2_solve_tiny_ridge_is_zero_in_f32(rng):
    """``1e-100 * diag(mask)`` is 0 in float32, as in the JAX package: a
    masked system whose active block is singular has a singular K."""
    p = _masked_problem(rng, 4, 3, 2, 2, 2)
    p["L"][:] = 0.0
    args = ("L", "Ai", "Aj", "Renv", "Lb", "bi", "bj", "Rb", "m_l", "m_r")
    f32 = [torch.as_tensor(p[k], dtype=torch.float32) for k in args]
    out = tm._local2_solve(*[t.double() for t in f32])
    assert torch.isfinite(out).all()  # f64: the ridge makes K regular
    with pytest.raises(RuntimeError):
        tm._local2_solve(*f32)


# ---------------------------------------------------------------------------
# ALS eigensolve (tests/test_scan_parallel.py::TestScanEigsolve)
# ---------------------------------------------------------------------------


def test_heisenberg_ground_state(rng):
    d = 6
    jH, H = op_both(ttnx.heisenberg_xyz_tto(d))
    jx0, x0 = tt_both(rand_cores(rng, d, 8, orthogonal=True))
    E, x = ta.als_eigsolve_scan(H, x0, n_sweeps=6)
    w = np.linalg.eigvalsh(np.asarray(ttnx.qtto_to_matrix(jH)))
    assert abs(E[-1] - w[0]) < 1e-6
    assert all(e >= w[0] - 1e-10 for e in E)  # variational
    Ej, xj = ja.als_eigsolve_scan(jH, jx0, n_sweeps=6)
    assert np.max(np.abs(E - np.asarray(Ej))) <= 1e-10 * abs(w[0])
    assert x.ranks == xj.ranks == x0.ranks
    close_up_to_sign(vec(x), vec(xj), 1e-8)


def test_energy_history_length(rng):
    d = 5
    jA, A = op_both(ttnx.laplacian(d))
    jx0, x0 = tt_both(rand_cores(rng, d, 4, orthogonal=True))
    E, x = ta.als_eigsolve_scan(A, x0, n_sweeps=3)
    # (d-1) microsteps a half sweep, 2 half sweeps a sweep
    assert len(E) == 3 * 2 * (d - 1)
    Ej, _ = ja.als_eigsolve_scan(jA, jx0, n_sweeps=3)
    assert np.max(np.abs(E - np.asarray(Ej))) <= 1e-10 * np.max(np.abs(E))


def test_complex_hamiltonian_takes_the_plain_env_chain(rng):
    """A complex MPO (a Y field): the env stacks take ``env_chain_A_plain``
    (B8 has no complex kernel); the energies match ttnx's."""
    d = 5
    jH, H = op_both(ttnx.heisenberg_xyz_tto(d, lam=0.7, field="y"))
    assert H.is_complex
    jx0, x0 = tt_both(rand_cores(rng, d, 4, orthogonal=True))
    E, x = ta.als_eigsolve_scan(H, x0, n_sweeps=3)
    Ej, _ = ja.als_eigsolve_scan(jH, jx0, n_sweeps=3)
    w = np.linalg.eigvalsh(np.asarray(ttnx.qtto_to_matrix(jH)))
    assert np.max(np.abs(E - np.asarray(Ej))) <= 1e-10 * abs(w[0])
    assert all(e >= w[0] - 1e-10 for e in E)
    assert x.dtype == torch.complex128


def test_env_stacks_forced_plain_give_the_same_bits(rng, monkeypatch):
    """The default route (B8's wrapper, plain on CPU tensors) against the
    env stacks forced through ``env_chain_A_plain``: the same bits, and two
    env-stack calls a sweep."""
    d, sweeps = 6, 2
    H = op_both(ttnx.heisenberg_xyz_tto(d))[1]
    x0 = tt_both(rand_cores(rng, d, 8, orthogonal=True))[1]
    E, x = ta.als_eigsolve_scan(H, x0, n_sweeps=sweeps)
    calls = []

    def plain(xm, A, *, left=False):
        calls.append(left)
        return env_chain_A_plain(xm, A, left=left)

    monkeypatch.setattr(ta, "env_chain_A_fused", plain)
    Ep, xp = ta.als_eigsolve_scan(H, x0, n_sweeps=sweeps)
    assert calls == [False, True] * sweeps
    assert np.array_equal(E, Ep)
    assert all(torch.equal(a, b) for a, b in zip(x.cores, xp.cores))


def test_env_stacks_and_local_eig(rng):
    d, R = 5, 6
    H = ttnx.heisenberg_xyz_tto(d)
    x = ja.pack_tt(ttnx.orthogonalize(JVec([jnp.asarray(c) for c in
                                            rand_cores(rng, d, 4)]), 0), R)
    A = ja.pack_op(H, 5)
    masks = ja.rank_masks((1, 2, 4, 4, 2, 1), R)
    for t_fn, j_fn in ((ta._right_env_stack_A, ja._right_env_stack_A),
                       (ta._left_env_stack_A, ja._left_env_stack_A)):
        got = _np(t_fn(_t(x), _t(A), _t(masks[1:])))
        ref = np.asarray(j_fn(x, A, masks[1:]))
        assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))
    envs = np.asarray(ja._right_env_stack_A(x, A, masks[1:]))
    L = np.asarray(ja._left_env_stack_A(x, A, masks[1:]))
    k = 2
    lam, V = ta._local_eig_padded(_t(L[k]), _t(A[k]), _t(envs[k + 1]),
                                  _t(masks[k]), _t(masks[k + 1]))
    lj, Vj = ja._local_eig_padded(L[k], A[k], envs[k + 1], masks[k],
                                  masks[k + 1])
    assert abs(float(lam) - float(lj)) <= 1e-10 * abs(float(lj))
    close_up_to_sign(_np(V), np.asarray(Vj), 1e-8)


def test_als_eigsolve_sweeps_on_stacks(rng):
    """``als_eigsolve_sweeps`` on packed stacks: two sweeps give ttnx's
    energy history."""
    d, R = 6, 8
    jH, H = op_both(ttnx.heisenberg_xyz_tto(d))
    x = tx.orthogonalize(tt_both(rand_cores(rng, d, 8, orthogonal=True))[1],
                         0)
    A_stack, x_stack = ta.pack_op(H, 5), ta.pack_tt(x, R)
    masks = ta.rank_masks(x.ranks, R, device=CPU)
    out, lams = ta.als_eigsolve_sweeps(A_stack, x_stack, masks, n_sweeps=2)
    _, lj = ja.als_eigsolve_sweeps(jnp.asarray(_np(A_stack)),
                                   jnp.asarray(_np(x_stack)),
                                   jnp.asarray(_np(masks)), 2)
    assert out.shape == x_stack.shape and lams.shape == (2 * 2 * (d - 1),)
    assert np.max(np.abs(_np(lams) - np.asarray(lj))) <= 1e-10 * 10


def test_entry_problems_solve_on_the_cpu():
    """``entry.als_eig_problem`` and ``entry.mals_problem`` at a small size,
    float64, through the port's solvers: the XXX ground energy (scipy
    oracle) and the sampled sine."""
    from ttnx_torch.entry import (als_eig_problem, dense_xxx_groundstate,
                                  mals_problem)

    d = 6
    p = als_eig_problem(CPU, d=d, rmax=8, dtype=torch.float64)
    E, _ = ta.als_eigsolve_scan(p["A"], p["x0"], n_sweeps=2)
    E0 = dense_xxx_groundstate(d)
    assert abs(E[-1] - E0) <= 1e-6 * abs(E0)
    p = mals_problem(CPU, d=d, rmax=8)
    x = tm.mals_linsolve_scan(p["A"], p["b"], p["x0"], rmax=p["rmax"])
    u = vec(p["u"])
    assert np.linalg.norm(vec(x) - u) <= 1e-10 * np.linalg.norm(u)
    assert p["b"].ranks == (1, 6, 6, 6, 6, 6, 1)
