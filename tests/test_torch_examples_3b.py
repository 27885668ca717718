"""The scripts of examples_torch/ of group 3, harmonic_oscillator_rk4 to
laplace_pde, on the CPU: each runs to its end with the asserts of its
examples/ twin, in one subprocess with ``TTNX_TORCH_CPU=1``
(tests/torch_examples_runner.py), one case a script.
"""

import pytest

from torch_examples_runner import run_scripts

SCRIPTS = ["harmonic_oscillator_rk4", "heat_equation_2d",
           "heat_prolongation_multigrid", "heisenberg_dmrg",
           "highly_oscillatory", "interpolation_3d", "kolmogorov_backward",
           "kolmogorov_second_quantized", "laplace_pde"]


@pytest.fixture(scope="module")
def results():
    return run_scripts(SCRIPTS, timeout=300)


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_runs_on_the_cpu(results, name):
    rec = results[name]
    assert rec["ok"], rec["error"] + rec["stdout"][-2000:]
