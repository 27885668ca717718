from portbench.drivers.heat2d_cn_d20_r64 import *  # noqa: F401,F403
