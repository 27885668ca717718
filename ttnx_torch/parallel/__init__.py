"""The distributed layer on ``torch.distributed``: batched solves spread
over the ``dp`` axis of a ``(dp, tp)`` device mesh, the tp-sharded Gram and
Gram-chain rounding with the distributed CN step, and the distributed
TSQR/TSVD panel factorizations. Every function with a mesh argument is SPMD:
each rank of an initialized process group makes the same call on its own
block (:mod:`ttnx_torch.parallel.comm`); :mod:`ttnx_torch.parallel.launch`
starts local ranks."""

from ttnx_torch.parallel.batch import (  # noqa: F401
    batched_als_linsolve, batched_als_sweeps, batched_dmrg_eig_sweeps,
    batched_tdvp1_steps, batched_tdvp2_steps, make_mesh, shard_batch,
    shard_batched_problem)
from ttnx_torch.parallel.round_dist import (  # noqa: F401
    gram_chain_round_dist, gram_round_dist, make_cn_step_dist, shard_chain,
    tp_rounding_worthwhile)
