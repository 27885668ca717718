"""TT-cross black-box approximation and TT quadrature: the host-driven
MaxVol, Greedy and DMRG cross (:mod:`ttnx_torch.cross.cross`) and the
device cross with a batch axis (:mod:`ttnx_torch.cross.device`)."""

from ttnx_torch.cross.cross import (  # noqa: F401
    MaxVol,
    Greedy,
    DMRGCross,
    DMRG,
    MaxVolPivot,
    RandomPivot,
    tt_cross,
    tt_integrate,
    gauss_legendre,
)
from ttnx_torch.cross.maxvol import maxvol  # noqa: F401
from ttnx_torch.cross.device import (  # noqa: F401
    dmrg_cross_device,
    evaluate_tt_indices,
    index_evaluator,
    maxvol_cross_device,
    maxvol_fixed,
    tt_cross_device,
)
