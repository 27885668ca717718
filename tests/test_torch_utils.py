"""The utilities of ttnx_torch (``utils/checkpoint.py``, ``validation.py``,
``resilience.py``, ``profiling.py`` and the core importers of
``convert.py``) against ttnx on the CPU, in float64.

Mirrors tests/test_resilience.py and the checkpoint, validation and layout
cases of tests/test_ad_interop.py. Checkpoints are held in both
directions: a file written by ttnx's ``save_tt`` loads in the port and one
written by the port loads in ttnx, for a vector, an operator and a QTT
subclass, with the cores bit-equal and the metadata kept. Tolerances: the
residuals of ``check_solution`` 1e-12 of ttnx's; solves at the reference
test's thresholds.
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import ttnx
from ttnx.utils import checkpoint as jcp
from ttnx.utils import profiling as jprof
from ttnx.utils import resilience as jres

import ttnx_torch as tx
from ttnx_torch.utils import checkpoint as tcp
from ttnx_torch.utils import profiling as tprof
from ttnx_torch.utils import resilience as tres
from ttnx_torch.utils import validation as tval
from ttnx_torch.utils.convert import (from_reference_layout,
                                      to_reference_layout, to_ttvector,
                                      ttvector_from_numpy)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread and one BLAS thread while this module runs."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api="blas"):
        yield
    torch.set_num_threads(saved)


def rand_cores(seed, dims, r):
    rng = np.random.default_rng(seed)
    rks = ttnx.r_and_d_to_rks([1] + [r] * (len(dims) - 1) + [1], dims,
                              rmax=r)
    return [rng.standard_normal((rks[k], n, rks[k + 1])) / np.sqrt(n * r)
            for k, n in enumerate(dims)]


def guess(d, seed=0, r=4):
    return ttvector_from_numpy(rand_cores(seed, (2,) * d, r), device=CPU)


def vec(x):
    return tx.ttv_to_tensor(x).reshape(-1).numpy()


# ---------------------------------------------------------------------------
# Checkpoints, both directions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def objects():
    """(ttnx object, port object) pairs with the same cores."""
    cores = rand_cores(3, (2, 3, 2, 2), 3)
    ot = (1, 1, 0, -1)
    jv = ttnx.TTVector([jnp.asarray(c) for c in cores], ot)
    tv = tx.TTVector([torch.as_tensor(c) for c in cores], ot)
    jh = ttnx.heisenberg_xyz_tto(4)
    th = tx.heisenberg_xyz_tto(4, device=CPU)
    f = lambda c: c[..., 0] + c[..., 1]  # noqa: E731
    jq = ttnx.function_to_qttv(f, 2, 3, ordering="serial")
    tq = tx.function_to_qttv(f, 2, 3, ordering="serial", device=CPU)
    jqo = ttnx.qtt_laplacian(2, 4, ordering="interleaved", bc="DD")
    tqo = tx.qtt_laplacian(2, 4, ordering="interleaved", bc="DD", device=CPU)
    return {"vector": (jv, tv), "operator": (jh, th), "qtt_vector": (jq, tq),
            "qtt_operator": (jqo, tqo)}


def _same(j_obj, t_obj):
    assert type(t_obj).__name__ == type(j_obj).__name__
    assert tuple(t_obj.ot) == tuple(j_obj.ot)
    assert len(t_obj.cores) == len(j_obj.cores)
    for jc, tc in zip(j_obj.cores, t_obj.cores):
        assert np.array_equal(tc.numpy(), np.asarray(jc))
    for attr in ("n_dims", "bits_per_dim", "ordering"):
        assert getattr(t_obj, attr, None) == getattr(j_obj, attr, None)


@pytest.mark.parametrize("kind", ["vector", "operator", "qtt_vector",
                                  "qtt_operator"])
def test_ttnx_file_loads_in_the_port(objects, kind, tmp_path):
    j_obj, t_obj = objects[kind]
    p = str(tmp_path / f"{kind}.npz")
    jcp.save_tt(p, j_obj)
    _same(j_obj, tcp.load_tt(p, device=CPU))


@pytest.mark.parametrize("kind", ["vector", "operator", "qtt_vector",
                                  "qtt_operator"])
def test_port_file_loads_in_ttnx(objects, kind, tmp_path):
    j_obj, t_obj = objects[kind]
    p = str(tmp_path / f"{kind}.npz")
    tcp.save_tt(p, t_obj)
    _same(jcp.load_tt(p), t_obj)
    _same(t_obj, tcp.load_tt(p, device=CPU))
    with np.load(p) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
    assert meta["n_cores"] == t_obj.N and meta["ot"] == list(t_obj.ot)


def test_round_trip_overwrites_atomically(tmp_path):
    x = guess(5)
    p = str(tmp_path / "x.npz")
    tcp.save_tt(p, x)
    tcp.save_tt(p, 2.0 * x)
    y = tcp.load_tt(p, device=CPU)
    assert np.allclose(vec(y), 2.0 * vec(x), atol=0)
    assert sorted(f.name for f in tmp_path.iterdir()) == ["x.npz"]


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def test_valid_tt_and_tto_pass():
    tval.assert_valid_tt(guess(3))
    tval.assert_valid_tto(tx.id_tto(3, device=CPU))


@pytest.mark.parametrize("shapes,match", [
    (((1, 2, 3), (2, 2, 1)), "bond mismatch"),
    (((2, 2, 3), (3, 2, 1)), "left boundary"),
    (((1, 2, 3), (3, 2, 2)), "right boundary"),
])
def test_invalid_tt_raises(shapes, match):
    bad = tx.TTVector([torch.ones(s, dtype=torch.float64) for s in shapes])
    with pytest.raises(ValueError, match=match):
        tval.assert_valid_tt(bad)
    with pytest.raises(ValueError):
        tval.assert_valid_tt(tx.TTVector([]))


def test_invalid_tto_raises():
    bad = tx.TTOperator([torch.ones((1, 2, 2, 3), dtype=torch.float64),
                         torch.ones((2, 2, 2, 1), dtype=torch.float64)])
    with pytest.raises(ValueError, match="bond mismatch"):
        tval.assert_valid_tto(bad)


def test_assert_finite():
    x = guess(2)
    tval.assert_finite(x)
    with pytest.raises(FloatingPointError, match="core 0"):
        tval.assert_finite(float("nan") * x)


# ---------------------------------------------------------------------------
# Resilience (tests/test_resilience.py)
# ---------------------------------------------------------------------------


def _sine_system(d):
    return (ttnx.id_tto(d), ttnx.qtt_sin(d), tx.id_tto(d, device=CPU),
            tx.qtt_sin(d, device=CPU))


def test_check_solution_matches_ttnx():
    jA, jb, tA, tb = _sine_system(5)
    x_cores = rand_cores(1, (2,) * 5, 2)
    jx = ttnx.TTVector([jnp.asarray(c) for c in x_cores])
    tx_ = ttvector_from_numpy(x_cores, device=CPU)
    ref = jres.check_solution(jA, jb, jx, max_residual=10.0)
    got = tres.check_solution(tA, tb, tx_, max_residual=10.0)
    assert abs(got - ref) <= 1e-12 * ref
    assert tres.check_solution(tA, tb, tb) < 1e-12


def test_check_solution_detects_nan_and_large_residual():
    _, _, A, b = _sine_system(4)
    with pytest.raises(tres.SolveFailure, match="non-finite"):
        tres.check_solution(A, b, float("nan") * b)
    with pytest.raises(tres.SolveFailure, match="residual") as err:
        tres.check_solution(A, b, 100.0 * b, max_residual=1.0)
    assert "residual=" in str(err.value)


def test_with_retry():
    calls = []

    def solve(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise tres.SolveFailure("synthetic")
        return "ok"

    perturbed = []
    assert tres.with_retry(solve, lambda r: None, retries=3,
                           perturb=perturbed.append) == "ok"
    assert calls == [0, 1, 2] and perturbed == [0, 1]

    def always(attempt):
        raise tres.SolveFailure("always")

    with pytest.raises(tres.SolveFailure):
        tres.with_retry(always, lambda r: None, retries=1)


def test_resilient_linsolve_happy_path_matches_ttnx():
    jA, jb, tA, tb = _sine_system(5)
    cores = rand_cores(2, (2,) * 5, 4)
    x = tres.resilient_linsolve(tA, tb, ttvector_from_numpy(cores,
                                                            device=CPU),
                                tx.als_linsolve, max_residual=1e-8,
                                sweep_count=4)
    assert tres.check_solution(tA, tb, x) < 1e-10
    jx = jres.resilient_linsolve(jA, jb, ttnx.TTVector(
        [jnp.asarray(c) for c in cores]), ttnx.als_linsolve,
        max_residual=1e-8, sweep_count=4)
    assert np.allclose(vec(x), np.asarray(ttnx.ttv_to_tensor(jx)).reshape(-1),
                       atol=1e-10)


@pytest.mark.parametrize("d,r,grow_rank,max_residual", [
    (4, 4, 0, 1e-8),   # the reference test's case
    # a TT residual norm floors near sqrt(eps) ||b||: the default threshold
    (6, 2, 2, 1e-6),
])
def test_resilient_linsolve_retries_a_diverging_solver(d, r, grow_rank,
                                                       max_residual):
    _, _, A, b = _sine_system(d)
    x0 = guess(d, seed=4, r=r)
    attempts = []

    def flaky_solver(A, b, g, **kw):
        attempts.append(max(g.ranks))
        if len(attempts) < 3:
            return float("nan") * g  # diverged
        return tx.als_linsolve(A, b, g, sweep_count=4)

    x = tres.resilient_linsolve(A, b, x0, flaky_solver,
                                max_residual=max_residual, retries=3,
                                grow_rank=grow_rank,
                                generator=torch.Generator().manual_seed(1))
    assert len(attempts) == 3
    assert attempts[1] == max(x0.ranks) + grow_rank
    assert tres.check_solution(A, b, x) < max_residual


def test_resilient_linsolve_gives_up():
    _, _, A, b = _sine_system(3)

    def broken(A, b, g, **kw):
        return float("nan") * g

    with pytest.raises(tres.SolveFailure, match="non-finite"):
        tres.resilient_linsolve(A, b, guess(3), broken, retries=1)


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


def test_sync_and_time_returns_the_output():
    x = guess(4)
    calls = []

    def fn(a):
        calls.append(1)
        return {"y": [2.0 * a], "n": torch.ones(3)}

    secs, out = tprof.sync_and_time(fn, x, iters=3)
    assert secs >= 0 and len(calls) == 4
    assert np.allclose(vec(out["y"][0]), 2.0 * vec(x))


def test_timer_accumulates_sections():
    t = tprof.Timer()
    for _ in range(2):
        with t.section("a"):
            time.sleep(0.002)
    with t.section("b"):
        pass
    assert t.sections["a"] >= 0.004 and set(t.sections) == {"a", "b"}
    text = t.summary()
    assert text.startswith("total") and text.index("a:") < text.index("b:")


@pytest.mark.parametrize("a,b,c", [((64, 2, 64), (64, 64), (64,)),
                                   ((3, 4), (4, 5), (4,))])
def test_contraction_flops_matches_ttnx(a, b, c):
    assert tprof.contraction_flops(a, b, c) == jprof.contraction_flops(a, b,
                                                                       c)


def test_trace_writes_a_chrome_trace(tmp_path):
    x = guess(4)
    with tprof.trace(str(tmp_path)) as prof:
        tx.ttv_to_tensor(x)
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".json")
    assert "traceEvents" in json.loads(files[0].read_text())
    assert any("matmul" in e.key or "mm" in e.key
               for e in prof.key_averages())


# ---------------------------------------------------------------------------
# Core importers (tests/test_ad_interop.py)
# ---------------------------------------------------------------------------


def test_reference_layout_round_trip():
    x = ttvector_from_numpy(rand_cores(5, (2, 3, 2), 2), device=CPU)
    back = from_reference_layout(to_reference_layout(x), device=CPU)
    assert np.allclose(vec(back), vec(x), atol=0)
    j = ttnx.utils.from_reference_layout(
        [c.numpy() for c in to_reference_layout(x)])
    assert np.allclose(np.asarray(ttnx.ttv_to_tensor(j)).reshape(-1), vec(x))


def test_to_ttvector_checks_the_chain():
    cores = rand_cores(6, (2, 2, 2), 2)
    assert to_ttvector(cores, device=CPU).ranks == (1, 2, 2, 1)
    with pytest.raises(ValueError, match="rank-3"):
        to_ttvector([np.ones((1, 2))], device=CPU)
    with pytest.raises(ValueError, match="bond mismatch"):
        to_ttvector([np.ones((1, 2, 2)), np.ones((3, 2, 1))], device=CPU)
    with pytest.raises(ValueError, match="boundary"):
        to_ttvector([np.ones((2, 2, 1))], device=CPU)
