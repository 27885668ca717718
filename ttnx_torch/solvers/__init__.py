"""Solvers: the eager tier (ALS, MALS, DMRG, TDVP, the Krylov methods and
the time steppers) and the scan tier (padded-rank ALS, MALS, DMRG, TDVP
and the Crank–Nicolson step)."""

from ttnx_torch.solvers.als import (als_eigsolve, als_gen_eigsolv,  # noqa: F401
                                    als_linsolve)
from ttnx_torch.solvers.dmrg import dmrg_eigsolve, dmrg_linsolve  # noqa: F401
from ttnx_torch.solvers.krylov import (bicgstab_tt, cg_tt,  # noqa: F401
                                       expintegrator_tt, expm_multiply,
                                       gmres_tt, krylov_linsolve)
from ttnx_torch.solvers.mals import mals_eigsolve, mals_linsolve  # noqa: F401
from ttnx_torch.solvers.steppers import (  # noqa: F401
    crank_nicholson_method, euler_method, implicit_euler_method, rk4_method)
from ttnx_torch.solvers.tdvp import (tdvp, tdvp1sweep, tdvp2,  # noqa: F401
                                     tdvp2sweep)
