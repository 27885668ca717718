"""Utilities: numpy bridges and importers, checkpoints, validation and the
NaN trap, the TT-manifold optimization tools, resilience, profiling and
FLOP accounting."""

from ttnx_torch.utils.convert import (  # noqa: F401
    to_ttvector,
    from_reference_layout,
    to_reference_layout,
)
from ttnx_torch.utils.checkpoint import save_tt, load_tt  # noqa: F401
from ttnx_torch.utils.validation import (  # noqa: F401
    assert_valid_tt,
    assert_valid_tto,
    assert_finite,
    debug_nans,
)
from ttnx_torch.utils.manifold import (  # noqa: F401
    inner,
    manifold_norm,
    distance,
    zero_vector,
    retract,
    TTVectorSpace,
    ttvector_manifold,
    manifold_gradient_descent,
    rayleigh_quotient,
)
from ttnx_torch.utils.profiling import (  # noqa: F401
    trace,
    Timer,
    SolverTelemetry,
    sync_and_time,
    contraction_flops,
)
