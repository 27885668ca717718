"""The scripts of examples_torch/ of group 1 (autograd) on the CPU: each
runs to its end with the asserts of its examples/ twin, in one
subprocess with ``TTNX_TORCH_CPU=1`` (tests/torch_examples_runner.py),
one case a script. burgers_variational takes over 30 s alone on the CPU:
it carries the ``slow`` marker, and phase 14 of chip_smoke.py holds
it on the card.
"""

import pytest

from torch_examples_runner import run_scripts

SCRIPTS = ["manifold_gradient_descent", "optimize_methods",
           "variational_solver"]


@pytest.fixture(scope="module")
def results():
    return run_scripts(SCRIPTS, timeout=300)


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_runs_on_the_cpu(results, name):
    rec = results[name]
    assert rec["ok"], rec["error"] + rec["stdout"][-2000:]


@pytest.mark.slow
def test_burgers_variational_runs_on_the_cpu():
    rec = run_scripts(["burgers_variational"], timeout=600)[
        "burgers_variational"]
    assert rec["ok"], rec["error"] + rec["stdout"][-2000:]
