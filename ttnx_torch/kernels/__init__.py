"""Hand-written Hopper kernels and their plain PyTorch versions.

The wrapper modules are imported here, so :mod:`.dispatch` registers every
kernel wrapper whatever was imported first (no kernel is built at import).
"""

from ttnx_torch.kernels import (  # noqa: F401
    als_sweep_fused, contraction, env_chain, gram, lanczos, local_cg,
    local_cg_mf, qr_batched)
