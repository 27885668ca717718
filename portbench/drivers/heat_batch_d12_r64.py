"""Driver of ``heat_batch_d12_r64``: batches of implicit heat solves
``(I - h/2 A) x_k = b_k`` through
``ttnx_torch.solvers.als_scan_batched.als_sweeps_b``.

A unit is one call on a batch of distinct right-hand sides, each the
seed's sum of sine modes at the feasible ranks, warm-started from itself.
The set-up builds ``pool`` such batches on the device; unit ``i`` takes
batch ``i % pool``. The control path (``control=True``) allows TF32 for
every matmul, the port's own lower-precision path.
"""

from __future__ import annotations

import torch

from ttnx_torch.core.algebra import add_op, scale_op
from ttnx_torch.core.tt import id_tto, r_and_d_to_rks
from ttnx_torch.ops.operators import toeplitz_to_qtto
from ttnx_torch.solvers.als_scan import pack_op, rank_masks
from ttnx_torch.solvers.als_scan_batched import als_sweeps_b

from portbench.core.qtt_states import sine_states


class Session:
    def __init__(self, config, draws, device, control):
        d, R, h = config["d"], config["rmax"], config["h"]
        dtype = getattr(torch, config["dtype"])
        torch.backends.cuda.matmul.allow_tf32 = control
        torch.backends.cudnn.allow_tf32 = control
        hg = 1.0 / (2 ** d + 1)
        A = ((-1.0 / hg ** 2) * toeplitz_to_qtto(
            2.0, -1.0, -1.0, d, device=device)).astype(dtype)
        lhs = add_op(id_tto(d, dtype=dtype, device=device),
                     scale_op(-h / 2, A))
        self.A = pack_op(lhs, max(lhs.ranks))
        rks = r_and_d_to_rks((1,) + (R,) * (d - 1) + (1,), (2,) * d, rmax=R)
        self.masks = rank_masks(rks, R, dtype=dtype, device=device)
        B = draws.batch
        self.pool = [sine_states(draws.modes[p * B:(p + 1) * B],
                                 draws.amps[p * B:(p + 1) * B], d, R, dtype,
                                 device) for p in range(draws.pool)]
        self.problems_per_unit = B
        self.config = config
        self.kept, self.last = [], None

    def call(self, b):
        c = self.config
        return als_sweeps_b(self.A, b, b, self.masks, c["sweep_count"],
                            cg_iters=c["cg_iters"], solver=c["solver"])

    def warmup(self):
        for _ in range(2):
            self.call(self.pool[0])

    def run(self, i, keep):
        out = self.call(self.pool[i % len(self.pool)])
        self.last = (i, out)
        if keep:
            self.kept.append(self.last)

    def close(self):
        """The kept ``(call index, solutions)`` pairs, the last call's among
        them; frees the operator and the pool."""
        kept = self.kept
        if self.last is not None and (not kept or kept[-1][0] != self.last[0]):
            kept = kept + [self.last]
        self.A = self.masks = self.pool = self.kept = self.last = None
        return kept


def setup(config, traffic, draws, device, control=False):
    return Session(config, draws, device, control)
