"""The check's control and faults on the card, at each cell's own sizes with
a window of a few seconds: the configured path is correct, while the
port's lower-precision path (TF32 allowed for every matmul) and each fault
of the cell's ``faults`` module, planted under the timed path, come out not
correct at the same seed.

Run on a card from the repository root:
``python -m pytest -p no:cacheprovider -o addopts="" -m cuda portbench/tests``.
"""

import pytest
import torch

from portbench.calibrate import calibrate
from portbench.core.catalog import Catalog

CELLS = ["heat_cn_d12_r64.stream", "heat_batch_d12_r64.b512"]
SEED = 2**31 + 99


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


def reading(cell, control=False, fault=None):
    line, = calibrate(Catalog(), cell, [SEED], 5, control, card(), fault)
    return line


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    sound = reading(cell)
    control = reading(cell, control=True)
    assert sound["correct"] is True, sound
    assert control["correct"] is False, control


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [
    (CELLS[0], "unchanged"), (CELLS[0], "altered"), (CELLS[1], "unchanged"),
    (CELLS[1], "half"), (CELLS[1], "altered")])
def test_fault_is_not_correct_at_the_cells_size(cell, fault):
    r = reading(cell, fault=fault)
    assert r["correct"] is False and r["failed"] > 0, r
