"""Utilities: numpy bridges and importers, checkpoints, validation,
resilience, profiling and FLOP accounting. ``ttnx.utils``' manifold tools
and ``debug_nans`` are not ported yet (ROADMAP A.7)."""

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
)
from ttnx_torch.utils.profiling import (  # noqa: F401
    trace,
    Timer,
    SolverTelemetry,
    sync_and_time,
    contraction_flops,
)
