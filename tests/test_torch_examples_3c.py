"""The scripts of examples_torch/ of group 3, ornstein_2d to
wishart_5d_cross, on the CPU: each runs to its end with the asserts of
its examples/ twin, in one subprocess with ``TTNX_TORCH_CPU=1``
(tests/torch_examples_runner.py), one case a script.
schrodinger_groundstate takes over 30 s alone on the CPU: it carries the
``slow`` marker, and phase 14 of chip_smoke.py holds it on the card.

quadrature_cross is held to its examples/ twin, which fails its own d =
10 Gaussian assert (rel 8.512e-06 > 1e-8: 20 Gauss-Legendre nodes on
[-5, 5] do not resolve exp(-x^2) to 1e-9 a dimension; 30 do). The port
keeps the assert, so the script stops there as the twin does; the test
holds the printed error to ttnx's own ``tt_integrate`` on the same
integral (ROADMAP C.24).
"""

import re

import numpy as np
import pytest

from ttnx.cross import MaxVol, tt_integrate

from torch_examples_runner import run_scripts

SCRIPTS = ["ornstein_2d", "ornstein_2d_coupled", "ornstein_2d_rotational",
           "ornstein_uhlenbeck", "tdvp_comparison", "time_steppers",
           "vasicek_bond", "wishart_5d_cross", "quadrature_cross"]


@pytest.fixture(scope="module")
def results():
    return run_scripts(SCRIPTS, timeout=300)


@pytest.mark.parametrize("name", SCRIPTS[:-1])
def test_example_runs_on_the_cpu(results, name):
    rec = results[name]
    assert rec["ok"], rec["error"] + rec["stdout"][-2000:]


def test_quadrature_cross_stops_where_its_twin_does(results):
    rec = results["quadrature_cross"]
    assert not rec["ok"]
    assert "assert rel < 1e-8" in rec["error"], rec["error"]
    assert "AssertionError" in rec["error"]
    # parts 1-3 pass; part 4 prints d=10 and stops
    assert "exact 0.1096719475" in rec["stdout"]
    got = float(re.search(r"d=10  rel err (\S+)", rec["stdout"]).group(1))
    f = lambda x: np.exp(-np.sum(x ** 2, axis=1))  # noqa: E731
    r = tt_integrate(f, lower=[-5.0] * 10, upper=[5.0] * 10,
                     alg=MaxVol(tol=1e-8))
    ref = abs(r - np.pi ** 5) / np.pi ** 5
    assert ref > 1e-8
    assert float(f"{ref:.3e}") == got


@pytest.mark.slow
def test_schrodinger_groundstate_runs_on_the_cpu():
    rec = run_scripts(["schrodinger_groundstate"], timeout=600)[
        "schrodinger_groundstate"]
    assert rec["ok"], rec["error"] + rec["stdout"][-2000:]
