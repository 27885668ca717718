"""Slice 2 of ttnx_torch: the batched ALS path against ttnx on the CPU.

Kernels B5 (batched matrix-free CG), B6 (batched env chains) and B7 (the
fused forward + backward pass) through their plain versions, the solver
``als_sweeps_b`` and ``batched_als_sweeps``, on identical numpy inputs with
distinct problems per batch element. ttnx's kernels run in interpret mode,
as ttnx's own tests run them; they compute in float32, so the float64 cases
hold the port to ttnx's float64 XLA twins. Tolerances: f32 1e-4 for CG and
the fused pass, 1e-5 for the env chains; f64 1e-10 (CG), 1e-12 (chains).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from ttnx.core.decomp import ttv_to_tensor as j_dense
from ttnx.kernels.als_sweep_fused import als_fwd_bwd_fused_batched as j_sweep
from ttnx.kernels.env_chain import _env_chain_xla
from ttnx.kernels.env_chain import env_chain_fused_batched as j_env_b
from ttnx.kernels.local_cg_mf import cg_matfree_fused_batched as j_mf_b
from ttnx.parallel.batch import batched_als_sweeps as j_batched
from ttnx.solvers.als_scan import unpack_tt as j_unpack
from ttnx.solvers.als_scan_batched import _b_local_cg as j_b_local_cg
from ttnx.solvers.als_scan_batched import als_sweeps_b as j_sweeps_b

from ttnx_torch.core.decomp import ttv_to_tensor as t_dense
from ttnx_torch.entry import batched_als_problem, flat_spectrum_stack
from ttnx_torch.kernels import dispatch
from ttnx_torch.kernels.als_sweep_fused import (als_fwd_bwd_fused_batched,
                                                als_fwd_bwd_plain,
                                                sweep_route)
from ttnx_torch.kernels.env_chain import (env_chain_batched_plain,
                                          env_chain_fused_batched)
from ttnx_torch.kernels.local_cg_mf import (cg_matfree_batched_plain,
                                            cg_matfree_fused_batched)
from ttnx_torch.parallel import batched_als_sweeps
from ttnx_torch.solvers.als_scan import unpack_tt
from ttnx_torch.solvers.als_scan_batched import _b_local_cg, als_sweeps_b
from ttnx_torch.utils.convert import stack_from_numpy

from kernel_launches import launches

F64, F32 = np.float64, np.float32


def _t(a, dt):
    return stack_from_numpy(np.array(a, dtype=dt), device="cpu")


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol * float(np.max(np.abs(ref))), err


def _local_batch(seed, B, R, RA=4, n=2):
    """B distinct SPD local systems sharing the MPO core and the masks."""
    rng = np.random.default_rng(seed)

    def spd_envs():
        out = np.zeros((B, R, RA, R))
        for b in range(B):
            for w in range(RA):
                g = rng.standard_normal((R, R)) / np.sqrt(R)
                out[b, :, w, :] = g @ g.T + (np.eye(R) if w == 0 else 0.0)
        return out

    Ac = np.zeros((RA, n, n, RA))
    Ac[0, :, :, 0] = np.eye(n)
    for w in range(1, RA):
        s = rng.standard_normal((n, n)) * 0.1
        Ac[w, :, :, w] = s @ s.T
    m_l = np.ones(R)
    m_l[R - R // 4:] = 0.0
    m_r = np.ones(R)
    m_r[R - R // 8:] = 0.0
    mask = m_l[:, None, None] * m_r[None, None, :] * np.ones((1, n, 1))
    return dict(L=spd_envs(), Ac=Ac, Renv=spd_envs(), m_l=m_l, m_r=m_r,
                mask=mask, Lb=rng.standard_normal((B, R, R)),
                bc=rng.standard_normal((B, R, n, R)),
                Rbe=rng.standard_normal((B, R, R)),
                rhs=rng.standard_normal((B, R, n, R)) * mask,
                x0=rng.standard_normal((B, R, n, R)))


def _env_batch(seed, B=3, d=4, R=16, RA=3, Rb=12, n=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, d, R, n, R)) / np.sqrt(R)
    x[:, :, R - 2:] = 0.0
    x[..., R - 2:] = 0.0
    A = rng.standard_normal((d, RA, n, n, RA)) / RA
    b = rng.standard_normal((B, d, Rb, n, Rb)) / np.sqrt(Rb)
    return x, A, b


# ---------------------------------------------------------------------------
# B5: batched matrix-free CG
# ---------------------------------------------------------------------------


def test_cg_matfree_batched_plain_vs_ttnx_kernel_f32():
    p = {k: v.astype(F32) for k, v in _local_batch(1, B=3, R=32).items()}
    args = ("L", "Ac", "Renv", "rhs", "mask")
    ref = j_mf_b(*(jnp.asarray(p[k]) for k in args), x0=jnp.asarray(p["x0"]),
                 iters=10, block_b=1, interpret=True)
    got = cg_matfree_batched_plain(*(_t(p[k], F32) for k in args),
                                   x0=_t(p["x0"], F32), iters=10)
    _close(got.numpy(), np.asarray(ref), 1e-4)


def test_cg_fused_local_solve_vs_ttnx_cg_f64():
    """The port's batched 'cg_fused' local solve (B5's plain version on the
    CPU) against ttnx's float64 batched einsum CG."""
    p = _local_batch(2, B=3, R=24)
    args = ("L", "Ac", "Renv", "Lb", "bc", "Rbe", "m_l", "m_r")
    ref = j_b_local_cg(*(jnp.asarray(p[k]) for k in args), 10, solver="cg",
                       v0=jnp.asarray(p["x0"]))
    got = _b_local_cg(*(_t(p[k], F64) for k in args), 10, solver="cg_fused",
                      v0=_t(p["x0"], F64))
    _close(got.numpy(), np.asarray(ref), 1e-10)


# ---------------------------------------------------------------------------
# B6: batched env chains
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("left,raw", [(False, False), (True, False),
                                      (False, True), (True, True)],
                         ids=["right", "left", "right-raw", "left-raw"])
def test_env_chain_batched_plain_vs_ttnx_kernel_f32(left, raw):
    x, A, b = (a.astype(F32) for a in _env_batch(3, d=3, Rb=16))
    ref = j_env_b(jnp.asarray(x), jnp.asarray(A), jnp.asarray(b), left=left,
                  raw=raw, interpret=True)
    got = env_chain_batched_plain(_t(x, F32), _t(A, F32), _t(b, F32),
                                  left=left, raw=raw)
    for g, r in zip(got, ref):
        _close(g.numpy(), np.asarray(r), 1e-5)


@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
def test_env_chain_batched_plain_vs_ttnx_f64(left):
    x, A, b = _env_batch(4)
    ref = jax.vmap(lambda xi, bi: _env_chain_xla(xi, jnp.asarray(A), bi,
                                                  left))(jnp.asarray(x),
                                                         jnp.asarray(b))
    got = env_chain_batched_plain(_t(x, F64), _t(A, F64), _t(b, F64),
                                  left=left)
    for g, r in zip(got, ref):
        _close(g.numpy(), np.asarray(r), 1e-12)


# ---------------------------------------------------------------------------
# B7: the fused forward + backward pass
# ---------------------------------------------------------------------------


def _flat_problem(seed, B, d, R, dtype=torch.float32):
    """The heat operator of the batched bench with B distinct
    flat-spectrum right-hand sides and guesses (numpy arrays)."""
    p = batched_als_problem(torch.device("cpu"), batch=1, rmax=R, d=d,
                            dtype=dtype)
    rng = np.random.default_rng(seed)
    rks = p["u_rks"]
    b = np.stack([flat_spectrum_stack(rng, rks, R) for _ in range(B)])
    x = b + 0.3 * np.stack([flat_spectrum_stack(rng, rks, R)
                            for _ in range(B)])
    return (p["lhs_stack"].numpy(), b, x, p["masks"].numpy(), rks)


def test_sweep_pair_plain_vs_ttnx_kernel_f32():
    """B7's plain version against the TPU kernel in interpret mode at the
    smallest shape with interior sites; outputs padded exactly to zero."""
    A, b, x, masks, _ = _flat_problem(5, B=2, d=4, R=16)
    kw = dict(cg_iters=8, ns_iters=(10, 4))
    ref = np.asarray(j_sweep(jnp.asarray(A), jnp.asarray(b, F32),
                             jnp.asarray(x, F32), jnp.asarray(masks),
                             interpret=True, **kw))
    got = als_fwd_bwd_plain(_t(A, F32), _t(b, F32), _t(x, F32),
                            _t(masks, F32), **kw).numpy()
    _close(got, ref, 1e-4)
    assert np.abs(got * (1 - masks[1:])[None, :, None, None, :]).max() == 0
    assert np.abs(got * (1 - masks[:-1])[None, :, :, None, None]).max() == 0


def test_sweep_pair_solves_bench_problem():
    """The fused pass (plain version) on the bench's problem at d=6 solves
    the implicit step as the QR route does, in both refinement settings."""
    d, R, h = 6, 16, 1e-6
    p = batched_als_problem(torch.device("cpu"), batch=2, rmax=R, d=d, h=h)
    hg = 1.0 / (2 ** d + 1)
    c = h / (2 * hg ** 2)
    u0 = t_dense(p["u0"]).reshape(-1).numpy()

    def residual(stack):
        v = t_dense(unpack_tt(stack, p["u_rks"])).reshape(-1).double()
        v = v.numpy()
        lhs = v + c * (2 * v - np.pad(v[1:], (0, 1)) - np.pad(v[:-1], (1, 0)))
        return np.linalg.norm(lhs - u0) / np.linalg.norm(u0)

    args = (p["lhs_stack"], p["b_batch"], p["x_batch"], p["masks"])
    assert residual(als_fwd_bwd_plain(*args)[1]) < 1e-5
    assert residual(als_fwd_bwd_plain(*args, cg_refine=2,
                                      cg_polish=2)[0]) < 1e-5
    assert residual(als_sweeps_b(*args, 2, cg_iters=16,
                                 solver="cg_fused")[0]) < 1e-5


def test_sweep_pair_gauge_fault_on_rank_deficient_guess():
    """ROADMAP C: with a guess whose active directions the solution lacks,
    the Newton-Schulz gauge of the fused pass is set by rounding noise —
    one ulp on the guess moves the cores by far more than the QR route's
    represented vectors move (the reference kernel shares the fault)."""
    d, R = 6, 16
    p = batched_als_problem(torch.device("cpu"), batch=1, rmax=R, d=d,
                            dtype=torch.float64)
    m = p["masks"]
    mm = m[:-1][:, :, None, None] * m[1:][:, None, None, :]
    rng = np.random.default_rng(0)
    pert = torch.as_tensor(rng.standard_normal(tuple(mm.shape[:2]) + (2, R)))
    x = p["x_batch"] + 1e-2 * pert * mm
    args = (p["lhs_stack"], p["b_batch"], x, m)
    ulp = (p["lhs_stack"], p["b_batch"], x * (1 + 2.0 ** -52), m)
    fused = als_fwd_bwd_plain(*args), als_fwd_bwd_plain(*ulp)
    qr = (als_sweeps_b(*args, 2, cg_iters=24),
          als_sweeps_b(*ulp, 2, cg_iters=24))

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def vec(s):
        return t_dense(unpack_tt(s[0], p["u_rks"])).reshape(-1)

    assert rel(*fused) > 1e-3
    assert rel(vec(qr[0]), vec(qr[1])) < 1e-12


@pytest.mark.parametrize("dtype,R,n,RA,refine,route", [
    (torch.float32, 64, 2, 4, 0, "site"),
    (torch.float32, 32, 2, 4, 0, "site"),
    (torch.float64, 64, 2, 4, 0, "folded"),
    (torch.float32, 40, 2, 4, 0, "folded"),
    (torch.float32, 64, 2, 6, 0, "folded"),
    (torch.float32, 64, 3, 4, 0, "folded"),
    (torch.float32, 32, 2, 4, 2, "folded"),
])
def test_sweep_route_by_dtype_shape_refine(dtype, R, n, RA, refine, route):
    """B7's kernel is chosen from dtype, (R, n, RA) and cg_refine alone."""
    assert sweep_route(dtype, R, n, RA, refine) == route


def test_cpu_tensors_at_site_shape_take_plain():
    """f32 at the site kernel's shape on the CPU: the plain version, no
    launch filed under any route."""
    A, b, x, masks, _ = _flat_problem(8, B=1, d=3, R=32)
    args = (_t(A, F32), _t(b, F32), _t(x, F32), _t(masks, F32))
    with launches(als_fwd_bwd_fused_batched) as added:
        assert torch.equal(als_fwd_bwd_fused_batched(*args, cg_iters=2),
                           als_fwd_bwd_plain(*args, cg_iters=2))
    assert added == {}


def test_sweep_pair_requires_square_rhs_rank():
    A, b, x, masks, _ = _flat_problem(6, B=1, d=3, R=8)
    with pytest.raises(ValueError, match="Rb == R"):
        als_fwd_bwd_fused_batched(_t(A, F32), _t(b[:, :, :4, :, :4], F32),
                                  _t(x, F32), _t(masks, F32))


# ---------------------------------------------------------------------------
# The solvers: als_sweeps_b and batched_als_sweeps
# ---------------------------------------------------------------------------


def _heat_batch(d, rmax, B, dtype):
    """The bench's heat problem with B distinct right-hand sides."""
    p = batched_als_problem(torch.device("cpu"), batch=1, rmax=rmax, d=d,
                            h=1e-6, dtype=dtype)
    us = p["b_batch"][0].numpy()
    b = np.stack([(1.0 + 0.2 * i) * us for i in range(B)])
    x = np.broadcast_to(us, (B,) + us.shape).copy()
    return p["lhs_stack"].numpy(), b, x, p["masks"].numpy(), p["u_rks"]


def _vectors(pkg_dense, pkg_unpack, stack, rks):
    return np.stack([np.asarray(pkg_dense(pkg_unpack(stack[i], rks)))
                     .reshape(-1) for i in range(stack.shape[0])])


@pytest.mark.parametrize("solver,dt,rmax,tol", [
    ("cg", F64, 8, 1e-10), ("cg_fused", F32, 16, 1e-4)])
def test_als_sweeps_b_vs_ttnx(solver, dt, rmax, tol):
    A, b, x, masks, rks = _heat_batch(6, rmax, 3, torch.float64)
    arrays = [a.astype(dt) for a in (A, b, x, masks)]
    ref = j_sweeps_b(*(jnp.asarray(a) for a in arrays), 2, cg_iters=16,
                     solver=solver)
    got = als_sweeps_b(*(_t(a, dt) for a in arrays), 2, cg_iters=16,
                       solver=solver)
    rv = _vectors(j_dense, j_unpack, np.asarray(ref), rks)
    gv = _vectors(t_dense, unpack_tt, got, rks)
    _close(gv, rv, tol)


@pytest.mark.parametrize("solver", ["lu", "cg_fused"])
def test_batched_als_sweeps_vs_ttnx_f64(solver):
    A, b, x, masks = __graft_entry__._heat_problem(d=6, rmax=4,
                                                   dtype=jnp.float64)
    rks = [int(v) for v in np.asarray(masks).sum(1)]
    scales = jnp.asarray([1.0, 1.3, 0.7])[:, None, None, None, None]
    bb = scales * b[None]
    xb = jnp.broadcast_to(x, (3,) + x.shape)
    ref = j_batched(A, bb, xb, masks, 2, solver=solver)
    got = batched_als_sweeps(*(_t(a, F64) for a in (A, bb, xb, masks)), 2,
                             solver=solver)
    _close(_vectors(t_dense, unpack_tt, got, rks),
           _vectors(j_dense, j_unpack, np.asarray(ref), rks), 1e-10)


# ---------------------------------------------------------------------------
# The gate: CPU tensors take the plain versions and launch nothing
# ---------------------------------------------------------------------------


def test_cpu_tensors_launch_no_batched_kernel():
    p = {k: _t(v, F64) for k, v in _local_batch(7, B=2, R=8).items()}
    x, A, b = (_t(a, F64) for a in _env_batch(8))
    As, bs, xs, ms, _ = _flat_problem(9, B=2, d=3, R=8, dtype=torch.float64)
    dispatch.reset_launch_counts()
    mf = (p["L"], p["Ac"], p["Renv"], p["rhs"], p["mask"])
    assert torch.equal(cg_matfree_fused_batched(*mf, x0=p["x0"], iters=4),
                       cg_matfree_batched_plain(*mf, x0=p["x0"], iters=4))
    for g, r in zip(env_chain_fused_batched(x, A, b, left=True),
                    env_chain_batched_plain(x, A, b, left=True)):
        assert torch.equal(g, r)
    sweep = (_t(As, F64), _t(bs, F64), _t(xs, F64), _t(ms, F64))
    assert torch.equal(als_fwd_bwd_fused_batched(*sweep, cg_iters=3),
                       als_fwd_bwd_plain(*sweep, cg_iters=3))
    assert all(v == 0 for v in dispatch.launch_counts().values())
