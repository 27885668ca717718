"""The scripts of examples_torch/ of group 3, analytic_encodings to
feynman_kac_oscillator_2d, on the CPU: each runs to its end with the
asserts of its examples/ twin, in one subprocess with
``TTNX_TORCH_CPU=1`` (tests/torch_examples_runner.py), one case a
script.
"""

import pytest

from torch_examples_runner import run_scripts

SCRIPTS = ["analytic_encodings", "chebyshev_polynomials", "complex_cross",
           "cross_algorithms", "dft", "diffusion_poisson_2d",
           "dmrg_quickstart", "feynman_kac_oscillator",
           "feynman_kac_oscillator_2d"]


@pytest.fixture(scope="module")
def results():
    return run_scripts(SCRIPTS, timeout=300)


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_runs_on_the_cpu(results, name):
    rec = results[name]
    assert rec["ok"], rec["error"] + rec["stdout"][-2000:]
