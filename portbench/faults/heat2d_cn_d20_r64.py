"""Faults planted under the timed path of ``heat2d_cn_d20_r64``: the 1-D CN
configuration's, since both drive ``make_cn_step`` (a step that returns its
input, and one whose output is scaled by 1.01)."""

from portbench.faults.heat_cn_d12_r64 import FAULTS  # noqa: F401
