"""The 2-D heat equation through the port's Crank–Nicolson step, and the
lossless compression of ``I -/+ h/2 A`` that keeps the step's kernels on
their fast routes.

* The step on the serial Kronecker sum ``-(1/hg^2) (T x I + I x T)`` at
  d = 4 + 4 against the plain float64 sine-basis reference of the
  benchmark (``portbench/reference/heat2d_cn_d20_r64.py``), from the
  benchmark's own 2-D starting states. Rank 16 is the whole space at
  d = 8, so only the ALS's two sweeps of 16 CG iterations and the dtype
  part the two: their largest readings here are 2.5e-9 (float64) and
  3.7e-6 (float32); the limits sit an order above each.
* ``round_op`` rounds ``I -/+ h/2 A`` to its exact ranks: 3 in 1-D (stored
  4), 4 at most in 2-D (stored 5). The dense operators agree to 1e-12.
* The packed rank: 1-D stays at 4 (its exact 3 and a zero channel), 2-D
  drops from 5 to 4, where B4, B2 and B1 take their fast routes.
* ``route_counts`` files each launch under the route its wrapper returns.

Card tests (marked ``cuda``, skipped without a card; this file imports no
jax): one CN step of the benchmark's 2-D and 1-D configurations launches
B4, B2 and B1 on their fast routes alone.
"""

import numpy as np
import pytest
import torch

from ttnx_torch.core.algebra import add_op, kron_tto, scale_op
from ttnx_torch.core.canonical import round_op
from ttnx_torch.core.decomp import tto_to_tensor
from ttnx_torch.core.tt import id_tto
from ttnx_torch.kernels import dispatch, gram
from ttnx_torch.kernels.env_chain import env_route
from ttnx_torch.kernels.gram import gram_chain_fused, gram_route
from ttnx_torch.kernels.local_cg_mf import matfree_route
from ttnx_torch.ops.operators import toeplitz_to_qtto
from ttnx_torch.solvers.round_scan import _cn_parts, make_cn_step

from portbench.core.qtt_states2d import plane_states
from portbench.core.traffic import draw
from portbench.reference import heat2d_cn_d20_r64 as ref

SEEDS = [2**31 + 17, 5]


def lap1(d, device="cpu"):
    hg = 1.0 / (2 ** d + 1)
    return (-1.0 / hg ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, d,
                                               device=device)


def lap2(da, device="cpu"):
    hg = 1.0 / (2 ** da + 1)
    T = toeplitz_to_qtto(2.0, -1.0, -1.0, da, device=device)
    eye = id_tto(da, device=device)
    return (-1.0 / hg ** 2) * add_op(kron_tto(T, eye), kron_tto(eye, T))


def h_of(da):
    """The step at which ``I + c (T x I + I x T)`` has condition about 34,
    as in the benchmark's configuration: ``c = h / (2 hg^2) = 4.2``."""
    return 8.4 / (2 ** da + 1) ** 2


def side(A, d, h, sign):
    eye = id_tto(d, device="cpu")
    return add_op(eye, scale_op(sign * h / 2, A))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 3e-8),
                                       (torch.float32, 4e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("seed", SEEDS)
def test_cn2d_step_matches_the_plain_reference(dtype, tol, seed):
    da, R, steps = 4, 16, 4
    d, h = 2 * da, h_of(da)
    step, _, _ = make_cn_step(
        lap2(da), h, rmax=R, dims=(2,) * d,
        u_rks=(1,) + (R,) * (d - 1) + (1,), dtype=dtype, sweep_count=2,
        solver="cg_fused", round_method="gram_chain", precision="highest",
        cg_iters=16)
    dr = draw(dict(batch=1, pool=1, modes=8, mode_range=[1, 4 ** da],
                   amp_range=[0.25, 1.0]), seed)
    start = plane_states(dr.modes, dr.amps, da, R, dtype, "cpu")[0]
    kept, u = [], start
    for i in range(steps):
        out = step(u)
        kept.append((i, u, out, start))
        u = out
    got = ref.judge(dict(d_axis=da, h=h), dict(trajectory=steps), dr, kept)
    assert max(got["traj_err"]) <= tol, got
    assert max(got["inc_err"]) <= tol, got


@pytest.mark.parametrize("case", ["1d-d8", "2d-d4+4"])
@pytest.mark.parametrize("sign", [-1, 1])
def test_round_op_is_lossless(case, sign):
    A, d, h, exact = ((lap1(8), 8, 1e-6, 3) if case == "1d-d8"
                      else (lap2(4), 8, h_of(4), 4))
    op = side(A, d, h, sign)
    rounded = round_op(op)
    assert max(op.ranks) == exact + 1 and max(rounded.ranks) == exact
    full, small = tto_to_tensor(op), tto_to_tensor(rounded)
    assert float(torch.linalg.norm(small - full)
                 / torch.linalg.norm(full)) <= 1e-12


def fast_routes(RA, d, R=64):
    return (matfree_route(torch.float32, R, 2, RA),
            env_route(torch.float32, 1, R, 2, RA, R),
            gram_route(torch.float32, d, RA * R, 2))


def test_packing_keeps_1d_at_4_and_brings_2d_from_5_to_4():
    """The 1-D heat cell's operators keep the shapes, routes and work they
    had (rank 3 packed at 4); the 2-D cell's, stored at rank 5 and taking
    B4, B2 and B1's multi-launch routes there, pack at 4, where all three
    take their fast routes."""
    for A, d, h, rounded in [(lap1(12), 12, 1e-6, [1] + [3] * 11 + [1]),
                             (lap2(10), 20, 8e-6,
                              [1] + [3] * 9 + [2] + [4] * 8 + [3, 1])]:
        stored = max(side(A, d, h, 1).ranks)
        c = _cn_parts(A, h, 64, (2,) * d, (1,) + (64,) * (d - 1) + (1,),
                      torch.float32)
        assert c["RA"] == 4
        assert c["lhs_stack"].shape == c["rhs_stack"].shape == (d, 4, 2, 2, 4)
        assert list(round_op(side(A, d, h, 1)).ranks) == rounded
        assert fast_routes(c["RA"], d) == ("cluster", "cluster", "grid")
        # the applied chain's active rows follow the rounded ranks
        assert c["masks_big"].sum(1).tolist() == [
            a * r for a, r in zip(rounded, c["u_rks"])]
        if d == 20:
            assert stored == 5
            assert fast_routes(stored, d) == ("streamed", "staged", "staged")
        else:
            assert stored == 4


@pytest.fixture
def counts():
    dispatch.reset_launch_counts()
    yield
    dispatch.reset_launch_counts()


def test_route_counts_file_launches_by_route(counts, monkeypatch):
    """B1's wrapper with its launch stubbed, so the CPU tensors take the
    kernel path: f32 at RB = 64 files under ``grid``, f64 under
    ``staged``."""
    monkeypatch.setattr(gram, "use_kernel", lambda *t: True)
    monkeypatch.setattr(gram._build, "call", lambda *a: None)
    for dt in (torch.float32, torch.float32, torch.float64):
        gram_chain_fused(torch.zeros((3, 64, 2, 64), dtype=dt))
    assert dispatch.route_counts()["gram_chain_fused"] == {"grid": 2,
                                                           "staged": 1}
    assert dispatch.launch_counts()["gram_chain_fused"] == 3
    dispatch.reset_launch_counts()
    assert dispatch.route_counts()["gram_chain_fused"] == {}


def test_route_counts_stay_empty_on_the_plain_path(counts):
    gram_chain_fused(torch.zeros((3, 8, 2, 8), dtype=torch.float64))
    assert all(v == {} for v in dispatch.route_counts().values())


# ---------------------------------------------------------------------------
# Card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["2d-d10+10", "1d-d12"])
def test_cn_step_takes_the_fast_routes_on_the_card(cuda, counts, case):
    """One step of the benchmark's configurations, f32 at rank 64: B4 x 2
    (d - 1), B2 x 2 and B1 x 1, each on its fast route alone."""
    A, d, h = ((lap2(10, cuda), 20, 8e-6) if case == "2d-d10+10"
               else (lap1(12, cuda), 12, 1e-6))
    R = 64
    step, pack, _ = make_cn_step(
        A, h, rmax=R, dims=(2,) * d, u_rks=(1,) + (R,) * (d - 1) + (1,),
        dtype=torch.float32, sweep_count=2, solver="cg_fused",
        round_method="gram_chain", precision="highest", cg_iters=16)
    rng = np.random.default_rng(3)
    u = torch.zeros((d, R, 2, R), dtype=torch.float32, device=cuda)
    r = [min(2 ** k, 2 ** (d - k), R) for k in range(d + 1)]
    for k in range(d):
        u[k, :r[k], :, :r[k + 1]] = torch.as_tensor(
            rng.standard_normal((r[k], 2, r[k + 1])) / np.sqrt(2 * r[k]))
    dispatch.reset_launch_counts()
    out = step(u)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    routes = {k: v for k, v in dispatch.route_counts().items() if v}
    assert routes == {"cg_matfree_fused": {"cluster": 2 * (d - 1)},
                      "right_env_chain_fused": {"cluster": 1},
                      "left_env_chain_fused": {"cluster": 1},
                      "gram_chain_fused": {"grid": 1}}
