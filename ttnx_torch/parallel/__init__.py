"""Batched solves over a leading problem axis (the mesh layer waits for the
distributed slice of the port)."""

from ttnx_torch.parallel.batch import (  # noqa: F401
    batched_als_sweeps, batched_dmrg_eig_sweeps, batched_tdvp1_steps,
    batched_tdvp2_steps)
