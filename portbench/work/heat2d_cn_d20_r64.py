"""Work of one CN step of ``heat2d_cn_d20_r64``: the 1-D configuration's
count at ``d`` = 20, since the step packs the compressed ``I -/+ h/2 A`` of
the Kronecker sum at the same operator rank 4."""

from portbench.work.heat_cn_d12_r64 import unit_work  # noqa: F401
