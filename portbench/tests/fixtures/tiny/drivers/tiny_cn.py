from portbench.drivers.heat_cn_d12_r64 import *  # noqa: F401,F403
