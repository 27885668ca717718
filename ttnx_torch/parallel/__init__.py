"""Batched solves over a leading problem axis (the mesh layer waits for the
distributed slice of the port)."""

from ttnx_torch.parallel.batch import batched_als_sweeps  # noqa: F401
