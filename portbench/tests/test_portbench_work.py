"""The frozen work counts against the port's own arithmetic at the cells'
shapes, and the operator rank they assume against the port's packing."""

import json

import pytest
import torch

from portbench.core.catalog import PACKAGE
from portbench.work import counts, heat_batch_d12_r64, heat_cn_d12_r64

from ttnx_torch.core.algebra import add_op, scale_op
from ttnx_torch.core.tt import id_tto
from ttnx_torch.ops.operators import toeplitz_to_qtto
from ttnx_torch.utils import flops


def data(kind, name):
    return json.loads((PACKAGE / kind / f"{name}.json").read_text())


@pytest.mark.parametrize("iters", [16, 17, 32])
def test_counts_equal_the_ports(iters):
    assert counts.cn_step_flops(12, 64, 4, 4, cg_iters=iters) == \
        flops.cn_step_flops(12, 64, 4, 4, cg_iters=iters)
    assert counts.als_sweeps_flops(12, 64, 4, 64, cg_iters=iters) == \
        flops.als_sweeps_flops(12, 64, 4, 64, cg_iters=iters)
    assert counts.round_gram_flops(12, 256, 64) == \
        flops.round_gram_flops(12, 256, 64)


def test_cell_work_at_the_cells_shapes():
    cn = heat_cn_d12_r64.unit_work(data("configs", "heat_cn_d12_r64"),
                                   data("traffic", "stream"))
    assert cn["flops"] == flops.cn_step_flops(12, 64, 4, 4, cg_iters=17)
    assert cn["bytes"] == 2 * 12 * 64 * 2 * 64 * 4 + 2 * 12 * 4 * 2 * 2 * 4 * 4
    batch = heat_batch_d12_r64.unit_work(
        data("configs", "heat_batch_d12_r64"), data("traffic", "b512"))
    assert batch["flops"] == 512 * flops.als_sweeps_flops(12, 64, 4, 64,
                                                          cg_iters=17)
    assert batch["bytes"] == 2 * 512 * 12 * 64 * 2 * 64 * 4 \
        + 12 * 4 * 2 * 2 * 4 * 4


def test_operator_rank_is_the_packed_one():
    d, h = 12, 1e-6
    hg = 1.0 / (2 ** d + 1)
    A = (-1.0 / hg ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, d, device="cpu")
    eye = id_tto(d, device="cpu")
    for sign in (1, -1):
        op = add_op(eye, scale_op(sign * h / 2, A))
        assert max(op.ranks) == heat_cn_d12_r64.RA == heat_batch_d12_r64.RA
