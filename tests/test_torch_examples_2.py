"""The scripts of examples_torch/ of group 2 (kernels, batches, the mesh)
on the CPU: each runs to its end with the asserts of its examples/ twin,
in one subprocess with ``TTNX_TORCH_CPU=1``
(tests/torch_examples_runner.py), one case a script.
"""

import pytest

from torch_examples_runner import run_scripts

SCRIPTS = ["als_quickstart", "ising_phase_transition",
           "batched_dmrg_tdvp_sweep", "batched_cross_sweep",
           "batched_parameter_sweep"]


@pytest.fixture(scope="module")
def results():
    return run_scripts(SCRIPTS, timeout=300)


@pytest.mark.parametrize("name", SCRIPTS)
def test_example_runs_on_the_cpu(results, name):
    rec = results[name]
    assert rec["ok"], rec["error"] + rec["stdout"][-2000:]
