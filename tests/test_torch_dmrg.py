"""Slice 3 of ttnx_torch: the DMRG scan tier against ttnx on the CPU.

The spin-chain constructors, kernel B8 (operator-only env chain) and B9
(fused Lanczos) through their plain versions, ``cut_off_mask``, the DMRG
eigensweep and linear-solve sweep, their drivers and the batched
eigensweep, on identical numpy inputs. ttnx's Pallas kernels run in
interpret mode, as ttnx's own tests run them; its env-chain kernel
computes in float32, so the float64 chain is held to ttnx's float64 scan
twin. Tolerances: operators 1e-14; B8 1e-5 (f32) and 1e-12 (f64); B9 1e-4
(f32) and 1e-10 (f64) on a well-conditioned K; float64 sweeps 1e-10 on
energies and 1e-8 on dense states up to sign (eigh/SVD signs are a
gauge); the float32 sweep 1e-4 on energies.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ttnx
from ttnx.core.decomp import ttv_to_tensor as j_dense
from ttnx.core.tt import TTVector as JVec
from ttnx.kernels.env_chain import _env_chain_A_xla
from ttnx.kernels.env_chain import env_chain_A_fused as j_env_A
from ttnx.kernels.lanczos import lanczos_fused as j_lanczos
from ttnx.parallel.batch import batched_dmrg_eig_sweeps as j_batched_dmrg
from ttnx.solvers import dmrg_scan as jd
from ttnx.solvers.als_scan import unpack_tt as j_unpack

import ttnx_torch
from ttnx_torch.core.decomp import ttv_to_tensor as t_dense
from ttnx_torch.core.decomp import tto_to_tensor as t_op_dense
from ttnx_torch.entry import dense_xxx_groundstate
from ttnx_torch.kernels.env_chain import env_chain_A_fused, env_chain_A_plain
from ttnx_torch.kernels.lanczos import (can_fuse_lanczos, lanczos_fused,
                                        lanczos_plain)
from ttnx_torch.parallel import batched_dmrg_eig_sweeps
from ttnx_torch.solvers import dmrg_scan as td
from ttnx_torch.solvers.als_scan import unpack_tt
from ttnx_torch.utils.convert import (stack_from_numpy, ttoperator_from_numpy,
                                      ttvector_from_numpy)

from kernel_launches import launches

F64, F32 = np.float64, np.float32


def _t(a, dt):
    return stack_from_numpy(np.array(a, dtype=dt), device="cpu")


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol * float(np.max(np.abs(ref))), err


def _close_up_to_sign(got, ref, tol):
    got, ref = np.asarray(got).reshape(-1), np.asarray(ref).reshape(-1)
    err = min(np.linalg.norm(got - ref), np.linalg.norm(got + ref))
    assert err <= tol * np.linalg.norm(ref), err


def _op_dense(cores):
    """Dense matrix of an MPO from its numpy cores (big-endian bits)."""
    m = np.ones((1, 1, 1))
    for c in cores:
        m = np.einsum("xya,aijb->xiyjb", m, c)
        m = m.reshape(m.shape[0] * m.shape[1], m.shape[2] * m.shape[3], -1)
    return m[:, :, 0]


# ---------------------------------------------------------------------------
# Spin-chain constructors
# ---------------------------------------------------------------------------


SPIN_CHAINS = [
    ("pauli_sum_tto", ("x", 5), {}),
    ("pauli_sum_tto", ("y", 4), {}),
    ("pauli_sum_tto", ("z", 1), {}),
    ("pauli_pair_sum_tto", ("x", "z", 5), {}),
    ("pauli_pair_sum_tto", ("y", "y", 4), {}),
    ("pauli_pair_sum_tto", ("y", "x", 3), {}),
    ("H_mu", ("z", 4), {}),
    ("H_munu", ("x", "x", 4), {}),
    ("heisenberg_xyz_tto", (5,), dict(jx=0.7, jy=1.3, jz=-0.4, lam=0.25)),
    ("heisenberg_xyz_tto", (4,), dict(lam=0.5, field="y")),
    ("ising_tto", (5,), dict(J=1.5, h=0.3)),
    ("ising_tto", (4,), dict(J=0.5, h=0.2, interaction="y", field="z")),
    ("xxz_tto", (5,), dict(delta=0.5, h=0.1)),
    ("xxx_tto", (6,), {}),
    ("xy_tto", (4,), dict(jx=1.0, jy=0.5, h=0.2)),
]


@pytest.mark.parametrize("name,args,kw", SPIN_CHAINS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(SPIN_CHAINS)])
def test_spin_chain_constructors_match_ttnx(name, args, kw):
    ref = getattr(ttnx, name)(*args, **kw)
    got = getattr(ttnx_torch, name)(*args, **kw, device="cpu")
    ref_cores = [np.asarray(c) for c in ref.cores]
    got_cores = [c.numpy() for c in got.cores]
    assert [c.shape for c in got_cores] == [c.shape for c in ref_cores]
    assert got.dtype == (torch.complex128 if np.iscomplexobj(ref_cores[0])
                         else torch.float64)
    dense = _op_dense(got_cores)
    _close(dense, _op_dense(ref_cores), 1e-14)
    _close(t_op_dense(got).reshape(dense.shape).numpy(), dense, 1e-14)
    assert np.allclose(dense, dense.conj().T, atol=1e-14)


def test_pauli_matrix_and_bad_axis():
    for mu in ("x", "y", "z", ":X"):
        assert np.array_equal(ttnx_torch.pauli_matrix(mu),
                              ttnx.pauli_matrix(mu))
    with pytest.raises(ValueError):
        ttnx_torch.pauli_matrix("w")
    with pytest.raises(ValueError):
        ttnx_torch.heisenberg_xyz_tto(1, device="cpu")


# ---------------------------------------------------------------------------
# B8: the operator-only env chain
# ---------------------------------------------------------------------------


def _env_inputs(seed, d=4, R=16, RA=5, n=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((d, R, n, R)) / np.sqrt(R)
    x[:, R - 3:] = 0.0          # masked bonds: padding is exactly zero
    x[..., R - 3:] = 0.0
    A = rng.standard_normal((d, RA, n, n, RA)) / RA
    return x, A


@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
def test_env_chain_A_plain_vs_ttnx_kernel_f32(left):
    x, A = _env_inputs(1)
    ref = j_env_A(jnp.asarray(x, F32), jnp.asarray(A, F32), left=left,
                  interpret=True)
    got = env_chain_A_fused(_t(x, F32), _t(A, F32), left=left)
    assert got.shape == (5, 16, 5, 16)
    _close(got.numpy(), np.asarray(ref), 1e-5)


@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
def test_env_chain_A_plain_vs_ttnx_scan_f64(left):
    x, A = _env_inputs(2, R=12)
    ref = _env_chain_A_xla(jnp.asarray(x), jnp.asarray(A), left)
    got = env_chain_A_plain(_t(x, F64), _t(A, F64), left=left)
    _close(got.numpy(), np.asarray(ref), 1e-12)


# ---------------------------------------------------------------------------
# B9: fused Lanczos
# ---------------------------------------------------------------------------


def _spread_K(seed, M):
    """Symmetric K with eigenvalues spread over [-1, 2] and a unit start
    vector: well-conditioned for a short Lanczos run."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((M, M)))
    K = (q * np.linspace(-1.0, 2.0, M)) @ q.T
    v0 = rng.standard_normal(M)
    return 0.5 * (K + K.T), v0 / np.linalg.norm(v0)


@pytest.mark.parametrize("M", [256, 1024])
@pytest.mark.parametrize("dt,tol", [(F32, 1e-4), (F64, 1e-10)],
                         ids=["f32", "f64"])
def test_lanczos_plain_vs_ttnx_kernel(M, dt, tol):
    K, v0 = _spread_K(M, M)
    ref = j_lanczos(jnp.asarray(K, dt), jnp.asarray(v0, dt), 8,
                    interpret=True)
    got = lanczos_fused(_t(K, dt), _t(v0, dt), iters=8)
    for g, r in zip(got, ref):
        _close(g.numpy(), np.asarray(r), tol)
    assert float(got[2][-1]) == 0.0


@pytest.mark.parametrize("dt", [F32, F64], ids=["f32", "f64"])
def test_lanczos_breakdown_zero_pattern(dt):
    """K of rank 3 and a start inside its range (f64: breakdown after three
    steps at rounding level) or an eigenvector (f32: exact breakdown at the
    first step): the zero pattern of betas, alphas and Q rows matches
    ttnx's kernel exactly."""
    M, iters = 64, 8
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((M, M)))
    if dt == F64:
        K = (q[:, :3] * np.array([1.0, 2.0, 3.0])) @ q[:, :3].T
        v0 = q[:, :3] @ np.ones(3) / np.sqrt(3.0)
        dead_from = 3
    else:
        K = np.diag(np.r_[1.0, 2.0, 3.0, np.zeros(M - 3)])
        v0 = np.zeros(M)
        v0[1] = 1.0
        dead_from = 1
    ref = j_lanczos(jnp.asarray(K, dt), jnp.asarray(v0, dt), iters,
                    interpret=True)
    got = lanczos_plain(_t(K, dt), _t(v0, dt), iters=iters)
    Q, alphas, betas = (g.numpy() for g in got)
    rQ, ra, rb = (np.asarray(r) for r in ref)
    assert np.array_equal(betas == 0, rb == 0)
    assert np.array_equal(np.all(Q == 0, axis=1), np.all(rQ == 0, axis=1))
    assert np.all(Q[dead_from:] == 0) and np.all(alphas[dead_from:] == 0)
    assert np.all(betas[dead_from - 1:] == 0)
    _close(alphas, ra, 1e-6 if dt == F32 else 1e-12)


def test_can_fuse_lanczos_and_kernel_gate():
    assert can_fuse_lanczos(torch.float32, 1024)
    assert not can_fuse_lanczos(torch.float64, 1025)
    assert not can_fuse_lanczos(torch.complex128, 64)
    with launches(lanczos_fused) as added:
        lanczos_fused(torch.eye(4), torch.ones(4) / 2, iters=2)
    assert added == {}  # CPU: the plain version


# ---------------------------------------------------------------------------
# cut_off_mask
# ---------------------------------------------------------------------------


CUTOFF_CASES = [
    ([1.0, 0.5, 0.5 - 1e-14, 1e-9, 1e-16], 0.4 / np.sqrt(1.5), 1e-10),
    ([3.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1e-3, 1e-3, 0.0], 0.3, 1e-8),
    ([1.0, 1.0, 1.0, 1.0], 0.9, 1e-10),
    ([2.0, 1e-7, 1e-7 + 1e-16, 1e-7 - 1e-15, 1e-12, 0.0], 1e-6, 1e-8),
]


@pytest.mark.parametrize("s,tol,degen", CUTOFF_CASES)
def test_cut_off_mask_matches_ttnx(s, tol, degen):
    ref = np.asarray(jd.cut_off_mask(jnp.asarray(s), tol, degen))
    got = td.cut_off_mask(torch.tensor(s, dtype=torch.float64), tol, degen)
    assert got.tolist() == ref.tolist()


def test_cut_off_mask_random_multiplets_match_ttnx():
    rng = np.random.default_rng(5)
    for _ in range(20):
        vals = np.sort(rng.choice([1.0, 0.5, 0.25, 1e-3, 1e-6, 1e-9],
                                  size=16))[::-1]
        s = vals * (1 + rng.choice([0.0, 1e-12, 1e-6], size=16))
        s = np.sort(s)[::-1].copy()
        tol = float(rng.choice([1e-2, 1e-4, 1e-7]))
        ref = np.asarray(jd.cut_off_mask(jnp.asarray(s), tol, 1e-8))
        got = td.cut_off_mask(torch.tensor(s), tol, 1e-8)
        assert got.tolist() == ref.tolist()


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------


def _orth_start(seed, d, r, n=2):
    """Normalized left-orthonormal rank-r TT cores (numpy)."""
    rng = np.random.default_rng(seed)
    rks = [min(r, n ** k, n ** (d - k)) for k in range(d + 1)]
    cores = []
    for k in range(d):
        c = rng.standard_normal((rks[k] * n, rks[k + 1]))
        q, _ = np.linalg.qr(c)
        cores.append(q.reshape(rks[k], n, rks[k + 1]))
    return cores, rks


def _xxx_problem(d, rmax, dt, seed=3, r0=4):
    H = ttnx_torch.xxx_tto(d, device="cpu")
    A = np.asarray([np.pad(c.numpy(), ((0, 5 - c.shape[0]), (0, 0), (0, 0),
                                       (0, 5 - c.shape[3])))
                    for c in H.cores])
    cores, rks = _orth_start(seed, d, r0)
    x = np.zeros((d, rmax, 2, rmax))
    for k, c in enumerate(cores):
        x[k, :c.shape[0], :, :c.shape[2]] = c
    m = np.zeros((d + 1, rmax))
    for k, r in enumerate(rks):
        m[k, :r] = 1.0
    return A.astype(dt), x.astype(dt), m.astype(dt)


def _j_state(x, m):
    rks = [int(v) for v in np.asarray(m).sum(axis=1)]
    return np.asarray(j_dense(j_unpack(jnp.asarray(x), rks))).reshape(-1)


def _t_state(x, m):
    rks = [int(v) for v in m.sum(dim=1).tolist()]
    return t_dense(unpack_tt(x, rks)).reshape(-1).numpy()


@pytest.mark.parametrize("eig_solver", ["lanczos", "lanczos_fused"])
@pytest.mark.parametrize("split,tol", [("svd", 1e-8), ("gram", 1e-4)])
def test_eig_sweep_matches_ttnx_f64(split, tol, eig_solver):
    """The 'gram' split squares the condition: a singular value below
    sqrt(eps) |s| (1.5e-8 in f64) is rounding, so at tol = 1e-8 which
    directions it keeps is decided by rounding (ROADMAP C). At tol = 1e-4
    every kept direction is well above that floor."""
    d, rmax = 6, 8
    A, x, m = _xxx_problem(d, rmax, F64)
    kw = dict(lanczos_iters=8, eig_solver=eig_solver, split=split)
    rx, rm, rE = jd.dmrg_eig_sweep(jnp.asarray(A), jnp.asarray(x),
                                   jnp.asarray(m), tol, 1e-8, **kw)
    gx, gm, gE = td.dmrg_eig_sweep(_t(A, F64), _t(x, F64), _t(m, F64),
                                   tol, 1e-8, **kw)
    assert gE.shape == (2 * (d - 1),)
    _close(gE.numpy(), np.asarray(rE), 1e-10)
    assert np.array_equal(gm.numpy(), np.asarray(rm))
    _close_up_to_sign(_t_state(gx, gm), _j_state(rx, rm), 1e-8)


def test_eig_sweep_matches_ttnx_f32_gram():
    """R = 16 in float32: ttnx builds both env stacks in its B8 kernel
    (interpret mode), the port in B8's plain version. The float32 'gram'
    split resolves singular values only down to sqrt(eps) |s| (3.5e-4),
    so the cut sits above that floor (tol = 3e-3); below it the kept
    directions are rounding (ROADMAP C)."""
    d, rmax = 5, 16
    A, x, m = _xxx_problem(d, rmax, F32)
    kw = dict(lanczos_iters=8, split="gram")
    _, rm, rE = jd.dmrg_eig_sweep(jnp.asarray(A), jnp.asarray(x),
                                  jnp.asarray(m), jnp.float32(3e-3),
                                  jnp.float32(1e-6), **kw)
    _, gm, gE = td.dmrg_eig_sweep(_t(A, F32), _t(x, F32), _t(m, F32), 3e-3,
                                  1e-6, **kw)
    assert gE.dtype == torch.float32
    assert np.array_equal(gm.numpy(), np.asarray(rm))
    _close(gE.numpy(), np.asarray(rE), 1e-4)


def test_eigsolve_scan_reaches_dense_ground_energy():
    d = 6
    H = ttnx_torch.xxx_tto(d, device="cpu")
    cores, _ = _orth_start(11, d, 2)
    x0 = ttvector_from_numpy(cores, device="cpu")
    E, x = ttnx_torch.dmrg_eigsolve_scan(H, x0, tol=1e-12, rmax=12,
                                         n_sweeps=4, lanczos_iters=30)
    E0 = dense_xxx_groundstate(d)
    assert abs(E[-1] - E0) < 1e-9
    assert all(e >= E0 - 1e-8 for e in E)  # Ritz values are variational
    assert max(x.ranks) > 2
    w = np.linalg.eigvalsh(_op_dense([c.numpy() for c in H.cores]))
    assert abs(w[0] - E0) < 1e-10


def test_linsolve_scan_matches_ttnx():
    d = 6
    cores, _ = _orth_start(13, d, 4)
    Aj = ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d)
    bj = ttnx.qtt_sin(d)
    ref = jd.dmrg_linsolve_scan(Aj, bj, JVec([jnp.asarray(c) for c in cores]),
                                tol=1e-12, rmax=8, n_sweeps=2)
    At = ttoperator_from_numpy([np.asarray(c) for c in Aj.cores], device="cpu")
    bt = ttvector_from_numpy([np.asarray(c) for c in bj.cores], device="cpu")
    got = td.dmrg_linsolve_scan(At, bt,
                                ttvector_from_numpy(cores, device="cpu"),
                                tol=1e-12, rmax=8, n_sweeps=2)
    assert got.ranks == ref.ranks
    _close(t_dense(got).numpy(), np.asarray(j_dense(ref)), 1e-10)


@pytest.mark.parametrize("per_problem", [False, True],
                         ids=["shared", "per_problem"])
def test_batched_eig_sweeps_match_ttnx_vmap(per_problem):
    d, rmax, B = 5, 4, 3
    xs, ms, As = [], [], []
    for i in range(B):
        H = ttnx_torch.xxz_tto(d, delta=0.5, h=0.2 * i if per_problem
                               else 0.0, device="cpu")
        As.append(np.stack([np.pad(c.numpy(), ((0, 5 - c.shape[0]), (0, 0),
                                               (0, 0), (0, 5 - c.shape[3])))
                            for c in H.cores]))
        _, x, m = _xxx_problem(d, rmax, F64, seed=20 + i, r0=2)
        xs.append(x)
        ms.append(m)
    A = np.stack(As) if per_problem else As[0]
    xb, mb = np.stack(xs), np.stack(ms)
    kw = dict(n_sweeps=2, lanczos_iters=8, split="svd")
    rx, rm, rE = j_batched_dmrg(jnp.asarray(A), jnp.asarray(xb),
                                jnp.asarray(mb), 1e-8, 1e-8, **kw)
    gx, gm, gE = batched_dmrg_eig_sweeps(_t(A, F64), _t(xb, F64),
                                         _t(mb, F64), 1e-8, 1e-8, **kw)
    assert gE.shape == (B, 2 * 2 * (d - 1))
    _close(gE.numpy(), np.asarray(rE), 1e-10)
    assert np.array_equal(gm.numpy(), np.asarray(rm))
    for i in range(B):
        _close_up_to_sign(_t_state(gx[i], gm[i]),
                          _j_state(np.asarray(rx)[i], np.asarray(rm)[i]),
                          1e-8)


def test_bad_options_raise():
    A, x, m = _xxx_problem(4, 4, F64)
    args = (_t(A, F64), _t(x, F64), _t(m, F64), 1e-8, 1e-8)
    with pytest.raises(ValueError):
        td.dmrg_eig_sweep(*args, eig_solver="arnoldi")
    with pytest.raises(ValueError):
        td.dmrg_eig_sweep(*args, split="qr")


def test_eig_sweep_kernels_counted_only_on_card():
    """On CPU tensors the sweep takes B8's and B9's plain versions: no
    launch is counted."""
    A, x, m = _xxx_problem(4, 4, F64)
    with launches(env_chain_A_fused) as env, launches(lanczos_fused) as lz:
        td.dmrg_eig_sweep(_t(A, F64), _t(x, F64), _t(m, F64), 1e-8, 1e-8,
                          lanczos_iters=4, eig_solver="lanczos_fused")
    assert env == lz == {}


def test_dense_xxx_groundstate_sparse_matches_dense():
    """The oracle's sparse eigsh branch (d = 11) against a dense eigvalsh
    of the same Kronecker sum (d = 11 is 2048 states)."""
    d = 11
    H = ttnx_torch.xxx_tto(d, device="cpu")
    w = np.linalg.eigvalsh(_op_dense([c.numpy() for c in H.cores]))
    assert abs(dense_xxx_groundstate(d) - w[0]) < 1e-9 * abs(w[0])

