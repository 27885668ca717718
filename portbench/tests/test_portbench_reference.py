"""The plain references and the benchmark's own inputs against closed forms.

The sine modes are exact eigenvectors of the three-point Laplacian, so a
Crank-Nicolson step scales mode ``k`` by ``(1 - c lam_k) / (1 + c lam_k)``
and the implicit solve divides it by ``1 + c lam_k``, with
``lam_k = 2 - 2 cos(k pi hg)`` and ``c = h / (2 hg^2)``.
"""

import numpy as np
import pytest
import torch

from portbench.core.qtt_states import sine_states
from portbench.core.traffic import draw
from portbench.reference import heat, heat_batch_d12_r64, heat_cn_d12_r64

D, R, H, L = 8, 16, 1e-4, 5


def gain(modes, d, h):
    hg = 1.0 / (2 ** d + 1)
    return h / (2 * hg ** 2) * (2 - 2 * np.cos(np.asarray(modes) * np.pi * hg))


def closed_form(modes, amps, d, h, power):
    hg = 1.0 / (2 ** d + 1)
    j = np.arange(1, 2 ** d + 1)
    out = np.zeros(2 ** d)
    for k, a, x in zip(modes, amps, gain(modes, d, h)):
        out += a * power(x) * np.sin(k * np.pi * hg * j)
    return out


def draws(seed, batch=3, pool=2, d=D, modes=16):
    return draw(dict(batch=batch, pool=pool, modes=modes,
                     mode_range=[1, 2 ** d], amp_range=[0.25, 1.0]), seed)


def stacks(modes, amps, d=D, r=R):
    return sine_states(modes, amps, d, r, torch.float64, "cpu")


@pytest.mark.parametrize("d,r", [(6, 8), (D, R), (12, 64)])
def test_states_read_back_on_the_grid(d, r):
    """The benchmark's QTT inputs, read by the reference's contraction,
    are the sampled sine sums."""
    dr = draws(5, d=d, modes=2 ** (d // 2))
    got = heat.grid(stacks(dr.modes, dr.amps, d, r))
    want = heat.sine_grid(dr.modes, dr.amps, d, "cpu")
    assert got.shape == (dr.modes.shape[0], 2 ** d)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-12


def test_states_fill_the_feasible_ranks():
    """At d = 12, R = 64 every bond of a state holds its feasible rank
    (64 at the middle), nothing beyond it, and no rank is numerically
    empty."""
    dr = draws(6, batch=1, pool=1, d=12, modes=64)
    s = stacks(dr.modes, dr.amps, 12, 64)[0]
    r = heat.feasible_ranks(12, 64)
    assert r[6] == 64
    values = heat.sine_grid(dr.modes, dr.amps, 12, "cpu")[0].numpy()
    for k in range(12):
        assert float(s[k, r[k]:].abs().sum()) == 0.0
        assert float(s[k, :, :, r[k + 1]:].abs().sum()) == 0.0
        sv = np.linalg.svd(values.reshape(2 ** (k + 1), -1),
                           compute_uv=False)
        assert len(sv) == r[k + 1] and sv[-1] > 1e-6 * sv[0]


def test_buffer_rank_under_the_feasible_rank_is_refused():
    dr = draws(6, batch=1, pool=1)
    with pytest.raises(ValueError):
        stacks(dr.modes, dr.amps, D, 8)


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_cn_trajectories_match_closed_form(seed):
    dr = draws(seed, batch=1, pool=3)
    M = heat_cn_d12_r64.step_matrix(D, H, "cpu")
    starts = heat.sine_grid(dr.modes, dr.amps, D, "cpu")
    steps = [0, 4, 2]
    got = heat_cn_d12_r64.trajectories(M, starts, steps)
    for a, n in enumerate(steps):
        want = closed_form(dr.modes[a], dr.amps[a], D, H,
                           lambda x: ((1 - x) / (1 + x)) ** (n + 1))
        err = np.linalg.norm(got[a].numpy() - want) / np.linalg.norm(want)
        assert err < 1e-12


def cn_stack(dr, start, n):
    """The exact state ``n`` steps into the trajectory from ``start``."""
    x = gain(dr.modes[start], D, H)
    amps = dr.amps[start] * ((1 - x) / (1 + x)) ** n
    return stacks(dr.modes[start:start + 1], amps[None])[0]


def test_cn_judge_reads_zero_on_the_exact_trajectories():
    """Exact states (the closed form put into QTT stacks) give readings at
    rounding level across trajectory starts; a step that returns its
    input reads 1 in ``inc_err``, and a state scaled by 1.01 reads far
    above rounding in both."""
    dr = draws(3, batch=1, pool=2)
    cfg, traffic = dict(d=D, h=H), dict(trajectory=L)
    # steps 0 and 3 of trajectory 0, 1 and 4 of trajectory 1 (pool state
    # 1), 2 of trajectory 2 (pool state 0 again)
    kept = [(i, cn_stack(dr, (i // L) % 2, i % L),
             cn_stack(dr, (i // L) % 2, i % L + 1)) for i in (0, 3, 6, 9, 12)]
    r = heat_cn_d12_r64.judge(cfg, traffic, dr, kept)
    assert max(r["traj_err"]) < 1e-12 and max(r["inc_err"]) < 1e-10
    i, before, after = kept[3]
    r = heat_cn_d12_r64.judge(cfg, traffic, dr, [(i, before, before)])
    assert r["inc_err"][0] == pytest.approx(1.0, rel=1e-12)
    assert r["traj_err"][0] > 1e-3
    r = heat_cn_d12_r64.judge(cfg, traffic, dr, [(i, before, after * 1.01)])
    assert r["traj_err"][0] > 5e-3 and r["inc_err"][0] > 1e-3


def test_batch_judge_against_closed_form():
    dr = draws(4, batch=3, pool=2)
    cfg = dict(d=D, h=H)
    kept = []
    for i in (0, 3):
        p = i % dr.pool
        rows = slice(p * dr.batch, (p + 1) * dr.batch)
        amps = dr.amps[rows] / (1 + gain(dr.modes[rows], D, H))
        kept.append((i, stacks(dr.modes[rows], amps)))
    r = heat_batch_d12_r64.judge(cfg, {}, dr, kept)
    assert len(r["sol_err"]) == 2 * dr.batch
    assert max(r["sol_err"]) < 1e-12 and max(r["residual"]) < 1e-12
    rows = slice(0, dr.batch)
    rhs = stacks(dr.modes[rows], dr.amps[rows])
    want = closed_form(dr.modes[0], dr.amps[0], D, H, lambda x: 1 / (1 + x))
    r = heat_batch_d12_r64.judge(cfg, {}, dr, [(0, rhs)])
    got = np.linalg.norm(want - heat.sine_grid(dr.modes[:1], dr.amps[:1], D,
                                               "cpu")[0].numpy())
    assert r["sol_err"][0] == pytest.approx(got / np.linalg.norm(want),
                                            rel=1e-9)
