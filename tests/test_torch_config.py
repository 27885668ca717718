"""The config objects and the solver telemetry of ttnx_torch
(``config.py``, ``utils/profiling.SolverTelemetry``) wired through the
eager solvers, against ttnx on the CPU in float64.

Mirrors the config and telemetry part of tests/test_config_telemetry.py
(on inputs from a numpy seed fed to both packages), and adds the field
defaults of every config against ttnx's, ``to_kwargs``, the TF32 scope of
``matmul_precision`` and the telemetry counts of the MALS and DMRG linear
solves. Tolerances: the reference test's own against the exact solution;
the two packages' telemetry histories to 1e-10 where they are set by the
solution (energies), exactly where they are counts or ranks; residuals of
TT norms only to their sqrt(eps) floor.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import ttnx
import ttnx.config as jc
from ttnx.core.tt import TTVector as JVec
from ttnx.utils.profiling import SolverTelemetry as JTelemetry

import ttnx_torch as tx
from ttnx_torch import config as tc
from ttnx_torch.utils.convert import ttoperator_from_numpy, ttvector_from_numpy
from ttnx_torch.utils.profiling import SolverTelemetry

CPU = torch.device("cpu")
CONFIGS = ["ALSConfig", "MALSConfig", "DMRGConfig", "TDVPConfig",
           "KrylovConfig"]


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


def rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def both(obj):
    cores = [np.array(c) for c in obj.cores]
    if isinstance(obj, ttnx.TTOperator):
        return obj, ttoperator_from_numpy(cores, device=CPU)
    return obj, ttvector_from_numpy(cores, device=CPU)


def rand_both(rng, d, r):
    rks = ttnx.r_and_d_to_rks([1] + [r] * (d - 1) + [1], (2,) * d, rmax=r)
    cores = [rng.standard_normal((rks[k], 2, rks[k + 1])) / np.sqrt(
        2 * rks[k + 1]) for k in range(d)]
    return JVec([jnp.asarray(c) for c in cores]), ttvector_from_numpy(
        cores, device=CPU)


@pytest.fixture
def system(rng):
    """``A = I``, ``b = qtt_sin``, a random rank-4 start, d = 5."""
    d = 5
    jA, A = both(ttnx.id_tto(d))
    jb, b = both(ttnx.qtt_sin(d))
    jx0, x0 = rand_both(rng, d, 4)
    return (jA, jb, jx0), (A, b, x0)


# ---------------------------------------------------------------------------
# The config objects
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_match_ttnx(name):
    """Same fields, same defaults, frozen, and the same ``to_kwargs``."""
    ours, theirs = getattr(tc, name)(), getattr(jc, name)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert tc.to_kwargs(ours) == jc.to_kwargs(theirs)
    field = dataclasses.fields(ours)[0].name
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(ours, field, None)


def test_to_kwargs_drops_none_and_lists_tuples():
    kw = tc.to_kwargs(tc.DMRGConfig(sweep_schedule=(2, 3)))
    assert kw["sweep_schedule"] == [2, 3] and "rmax_schedule" not in kw


@pytest.mark.parametrize("level,tf32", [("highest", False), ("high", True),
                                        ("default", True)])
def test_matmul_precision_scopes_tf32(level, tf32):
    """'highest' turns TF32 off inside the block, the other levels allow
    it; the previous flag comes back on exit, also after an exception."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    try:
        for before in (True, False):
            flags.allow_tf32 = before
            with tc.matmul_precision(level):
                assert flags.allow_tf32 is tf32
            assert flags.allow_tf32 is before
            with pytest.raises(RuntimeError):
                with tc.matmul_precision(level):
                    raise RuntimeError
            assert flags.allow_tf32 is before
    finally:
        flags.allow_tf32 = saved


def test_als_config_controls_sweeps_and_info(system):
    (jA, jb, jx0), (A, b, x0) = system
    x, info = tx.als_linsolve(A, b, x0, config=tc.ALSConfig(
        sweep_count=4, return_info=True))
    xj = ttnx.als_linsolve(jA, jb, jx0, sweep_count=4)
    assert info["residual"] < 1e-6  # a TT residual's floor: sqrt(eps)
    assert rel(vec(x), vec(jb)) < 1e-10 and rel(vec(x), vec(xj)) < 1e-10


def test_mals_config(system):
    (jA, jb, jx0), (A, b, x0) = system
    x = tx.mals_linsolve(A, b, x0, config=tc.MALSConfig(tol=1e-12, rmax=8))
    xj = ttnx.mals_linsolve(jA, jb, jx0, config=jc.MALSConfig(tol=1e-12,
                                                             rmax=8))
    assert rel(vec(x), vec(jb)) < 1e-6
    assert x.ranks == xj.ranks and rel(vec(x), vec(xj)) < 1e-10


def test_dmrg_config(system):
    """The config does not override ``return_info`` (not a field)."""
    (jA, jb, jx0), (A, b, x0) = system
    cfg = tc.DMRGConfig(tol=1e-12, sweep_schedule=(2,))
    x, info = tx.dmrg_linsolve(A, b, x0, return_info=True, config=cfg)
    assert info["residual"] < 1e-6 and rel(vec(x), vec(jb)) < 1e-8


def test_krylov_config(system):
    (jA, jb, jx0), (A, b, x0) = system
    x = tx.krylov_linsolve(A, b, x0, config=tc.KrylovConfig(
        krylov_solver="gmres", maxiter=30))
    assert rel(vec(x), vec(jb)) < 1e-6


def test_tdvp_config():
    """A config gives the keyword run's result and dtype."""
    d = 4
    _, H = both(-1.0 * ttnx.laplacian(d))
    _, u0 = both(ttnx.qtt_sin(d))
    out_cfg = tx.tdvp(H, u0, [1e-3] * 2, config=tc.TDVPConfig(
        normalize=False, imaginary_time=True))
    out_kw = tx.tdvp(H, u0, [1e-3] * 2, normalize=False, imaginary_time=True)
    a, b = vec(out_cfg), vec(out_kw)
    assert a.dtype == b.dtype and np.allclose(a, b, atol=1e-12)


# ---------------------------------------------------------------------------
# SolverTelemetry
# ---------------------------------------------------------------------------


def test_telemetry_fields_match_ttnx():
    ours, theirs = SolverTelemetry(), JTelemetry()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for t in (ours, theirs):
        t.record_sweep(residual=np.float64(0.5), energy=torch.tensor(-1.0),
                       max_rank=np.int64(3))
        t.flops, t.wall_seconds = 2e9, 0.5
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.gflops_per_s() == theirs.gflops_per_s() == 4.0
    assert type(ours.energies[0]) is float and type(ours.max_ranks[0]) is int


def test_als_linsolve_feeds_telemetry(system):
    (jA, jb, jx0), (A, b, x0) = system
    tel, tel_j = SolverTelemetry(), JTelemetry()
    tx.als_linsolve(A, b, x0, sweep_count=4, telemetry=tel)
    ttnx.als_linsolve(jA, jb, jx0, sweep_count=4, telemetry=tel_j)
    assert tel.local_solves == tel_j.local_solves == 4 * 4
    assert len(tel.residuals) == 4
    assert tel.residuals[-1] <= tel.residuals[0] * (1 + 1e-12)
    assert tel.wall_seconds > 0
    assert tel.max_ranks == tel_j.max_ranks and max(tel.max_ranks) <= 4


def test_als_eigsolve_feeds_energy(rng):
    d = 4
    jA, A = both(ttnx.laplacian(d))
    jx0, x0 = rand_both(rng, d, 3)
    tel, tel_j = SolverTelemetry(), JTelemetry()
    E, _ = tx.als_eigsolve(A, x0, telemetry=tel)
    ttnx.als_eigsolve(jA, jx0, telemetry=tel_j)
    # the rank-3 bond of this start is rank-deficient for the Laplacian's
    # low-rank ground state, so QR fills it with a gauge-dependent
    # direction and the two histories part after the second solve
    assert tel.energies == [float(e) for e in E]
    assert len(E) == tel.local_solves == tel_j.local_solves
    assert tel.max_ranks == tel_j.max_ranks


def test_mals_dmrg_telemetry(system, rng):
    (jA, jb, jx0), (A, b, x0) = system
    tel, tel_j = SolverTelemetry(), JTelemetry()
    tx.mals_linsolve(A, b, x0, telemetry=tel)
    ttnx.mals_linsolve(jA, jb, jx0, telemetry=tel_j)
    assert tel.local_solves == tel_j.local_solves > 0
    assert len(tel.residuals) == 1 and tel.max_ranks == tel_j.max_ranks

    d = 4
    jH, H = both(ttnx.laplacian(d))
    jx1, x1 = rand_both(rng, d, 4)
    tel2, tel2_j = SolverTelemetry(), JTelemetry()
    E, _, r_hist = tx.dmrg_eigsolve(H, x1, telemetry=tel2)
    ttnx.dmrg_eigsolve(jH, jx1, telemetry=tel2_j)
    assert tel2.energies == [float(e) for e in E]
    assert tel2.max_ranks == [int(r) for r in r_hist] == tel2_j.max_ranks
    assert np.abs(np.array(tel2.energies)
                  - np.array(tel2_j.energies)).max() <= 1e-10
    assert tel2.wall_seconds > 0


def test_dmrg_linsolve_telemetry(system):
    (jA, jb, jx0), (A, b, x0) = system
    tel, tel_j = SolverTelemetry(), JTelemetry()
    tx.dmrg_linsolve(A, b, x0, telemetry=tel)
    ttnx.dmrg_linsolve(jA, jb, jx0, telemetry=tel_j)
    assert tel.local_solves == tel_j.local_solves
    assert tel.max_ranks == tel_j.max_ranks and len(tel.residuals) == 1
