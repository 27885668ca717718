"""The 2-D heat configuration's pieces on the CPU: its plain reference
against the closed form of a sine mode, its starting states against their
samples, its fixture cell with each planted fault, and the slow-route
reader on a synthetic trace.

A 2-D sine mode ``(k, l)`` is an eigenvector of ``T x I + I x T``, so a
Crank-Nicolson step scales it by ``g_kl = (1 - c (lam_k + lam_l)) / (1 + c
(lam_k + lam_l))``, ``lam_k = 2 - 2 cos(k pi hg)``, ``c = h / (2 hg^2)``.
The fixture (``fixtures/tiny2d``) is one cell of the configuration at
d = 3 + 3, rank 8, float32, where the port takes its kernels' plain
versions.

On a card (marked ``cuda``, skipped without one) the cell at its own size
and a 20 s window (the control's error grows along a trajectory, so a
window must hold whole trajectories): the program is correct, its TF32
control and each fault are not (``python -m pytest -p no:cacheprovider -o addopts="" -m cuda
portbench/tests``).
"""

import json
import time

import numpy as np
import pytest
import torch

from portbench.calibrate import calibrate, planted
from portbench.core import harness
from portbench.core.catalog import PACKAGE, Catalog
from portbench.core.qtt_states2d import mode_pairs, plane_states
from portbench.core.trace import parse
from portbench.core.traffic import draw
from portbench.core.window import Window
from portbench.reference import heat2d_cn_d20_r64 as ref

FIXTURE = PACKAGE / "tests" / "fixtures" / "tiny2d"
CELL = "tiny_cn2d.tiny_stream2d"
SEED = 2**31 + 11


def closed_form(k, l, da, h, n):
    """``g_kl^n sin(k pi hg (i + 1)) sin(l pi hg (j + 1))`` on the grid."""
    N = 2 ** da
    hg = 1.0 / (N + 1)
    c = h / (2 * hg ** 2)
    lam = [2 - 2 * np.cos(m * np.pi * hg) for m in (k, l)]
    g = (1 - c * sum(lam)) / (1 + c * sum(lam))
    i = np.arange(1, N + 1)
    return g ** n * np.outer(np.sin(k * np.pi * hg * i),
                             np.sin(l * np.pi * hg * i))


@pytest.mark.parametrize("kl", [(1, 1), (3, 7), (16, 2), (32, 32)])
def test_one_mode_decays_by_its_gain(kl):
    da, h = 5, 8.4 / 33 ** 2
    m = np.array([[(kl[0] - 1) * 2 ** da + kl[1]]])
    assert [int(x[0, 0]) for x in mode_pairs(m, da)] == list(kl)
    start = plane_states(m, np.ones((1, 1)), da, 16, torch.float64, "cpu")[0]
    S, g = ref.dst_matrix(2 ** da, "cpu"), ref.gains(da, h, "cpu")
    for n in (1, 3):
        got = ref.steps(S, g, ref.plane(start), n).numpy()
        want = closed_form(*kl, da, h, n)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_judge_reads_zero_on_exact_steps_and_one_on_an_idle_step():
    """Step ``n`` of a sum of modes is the same sum with each amplitude
    times ``g_kl^n``: states built so are exact steps."""
    da, h, L = 4, 8.4 / 17 ** 2, 3
    dr = draw(dict(batch=1, pool=1, modes=6, mode_range=[1, 4 ** da],
                   amp_range=[0.25, 1.0]), SEED)
    k, l = mode_pairs(dr.modes, da)
    g = ref.gains(da, h, "cpu").numpy()[k - 1, l - 1]
    states = [plane_states(dr.modes, dr.amps * g ** n, da, 16,
                           torch.float64, "cpu")[0] for n in range(L + 1)]
    kept = [(i, states[i], states[i + 1], states[0]) for i in range(L)]
    got = ref.judge(dict(d_axis=da, h=h), dict(trajectory=L), dr, kept)
    assert max(got["traj_err"] + got["inc_err"]) < 1e-12
    idle = [(0, states[0], states[0], states[0])]
    got = ref.judge(dict(d_axis=da, h=h), dict(trajectory=L), dr, idle)
    assert got["inc_err"][0] == pytest.approx(1.0)


def unfolding_tails(values, d, R):
    """Per bond, the weight of the exact unfolding's singular values beyond
    the bond's capped feasible rank."""
    out = []
    for k in range(1, d):
        s = np.linalg.svd(values.reshape(2 ** k, -1), compute_uv=False)
        keep = min(2 ** k, 2 ** (d - k), R)
        out.append(float(np.sqrt((s[keep:] ** 2).sum())))
    return np.array(out)


@pytest.mark.parametrize("modes,fits", [(8, True), (32, False)])
def test_starts_hold_capped_ranks_and_match_their_samples(modes, fits):
    """At d = 5 + 5, rank 16: sums of 8 modes (sin-cos pairs: rank 16 at
    most) are held to rounding; sums of 32 are truncated at the middle bond
    (feasible 32), by no more than the TT-SVD's bound from the unfoldings'
    discarded singular values. Nothing lies outside the capped feasible
    ranks."""
    da, R = 5, 16
    d, N = 2 * da, 2 ** da
    dr = draw(dict(batch=1, pool=3, modes=modes, mode_range=[1, 4 ** da],
                   amp_range=[0.25, 1.0]), SEED)
    s = plane_states(dr.modes, dr.amps, da, R, torch.float64, "cpu")
    r = [min(2 ** k, 2 ** (d - k), R) for k in range(d + 1)]
    for k in range(d):
        active = torch.zeros_like(s[:, k])
        active[:, :r[k], :, :r[k + 1]] = s[:, k, :r[k], :, :r[k + 1]]
        assert torch.equal(active, s[:, k])
    hg = 1.0 / (N + 1)
    i = np.arange(1, N + 1)
    errs = []
    for n in range(3):
        k, l = mode_pairs(dr.modes[n], da)
        want = sum(a * np.outer(np.sin(kk * np.pi * hg * i),
                                np.sin(ll * np.pi * hg * i))
                   for a, kk, ll in zip(dr.amps[n], k, l))
        norm = np.linalg.norm(want)
        err = float(np.linalg.norm(ref.plane(s[n]).numpy() - want))
        bound = float(np.linalg.norm(unfolding_tails(want, d, R)))
        assert err <= bound + 1e-12 * norm
        errs.append(err / norm)
    assert bool(max(errs) <= 1e-12) == fits, errs


def catalog():
    return Catalog(roots=[FIXTURE, PACKAGE],
                   benchmark=FIXTURE / "BENCHMARK.json")


def run(fault=None, seconds=0.6):
    cat = catalog()
    with planted(cat, CELL, fault):
        return harness.run_cell(cat, CELL, SEED, seconds, False,
                                torch.device("cpu"), time.perf_counter())


def test_fixture_cell_is_correct():
    r = run()
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"traj_err", "inc_err"}
    assert set(r["metrics"]) == {"cn_step_ms", "cn_step_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_each_fault_is_caught(fault):
    r = run(fault)
    assert r["correct"] is False and r["failed"] > 0, r["checks"]


def test_slow_route_reader_counts_the_multi_launch_namespaces(tmp_path):
    """Two units: one kernel of each slow namespace, three of the fast ones
    whose names contain a slow one's prefix, and one outside the window."""
    names = ["void ttnx_cg_mf::cg_kernel<float>(float const*)",
             "void ttnx_env::right_kernel<float>(int)",
             "void ttnx_gram::gram_kernel<float>(int)",
             "void ttnx_cg_site::cg_site_kernel<64, 2, 4, float>(int)",
             "void ttnx_envsite::env_cluster_kernel<64, 16>(int)",
             "void ttnx_gramgrid::gram_grid_kernel<float>(int)"]
    ev = [dict(ph="X", cat="user_annotation", name="portbench.window", ts=0,
               dur=100, tid=1),
          dict(ph="X", cat="user_annotation", name="portbench.units", ts=0,
               dur=90, tid=1)]
    ev += [dict(ph="X", cat="kernel", name=n, ts=10 + 10 * j, dur=5, tid=7)
           for j, n in enumerate(names)]
    ev.append(dict(ph="X", cat="kernel", name=names[0], ts=150, dur=5,
                   tid=7))
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    window = Window(units=4, problems_per_unit=1, wall_s=4e-4,
                    intervals_ms=[0.1] * 4)
    read = Catalog().reader("slow_route_launches.cn")
    run_ = harness.Run(setup_s=1.0, window=window,
                       trace=parse(path, units=2, wall_s=1e-4), work={})
    assert read(run_) == 1.5
    assert read(harness.Run(setup_s=1.0, window=window, trace=None,
                            work={})) is None


CARD_CELL = "heat2d_cn_d20_r64.stream2d"


def card_reading(control=False, fault=None):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    line, = calibrate(Catalog(), CARD_CELL, [SEED], 20, control,
                      torch.device("cuda", 0), fault)
    return line


@pytest.mark.cuda
def test_card_control_fails_where_the_program_passes():
    sound, control = card_reading(), card_reading(control=True)
    assert sound["correct"] is True, sound
    assert control["correct"] is False, control


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_card_fault_is_not_correct(fault):
    r = card_reading(fault=fault)
    assert r["correct"] is False and r["failed"] > 0, r
