"""Driver of ``heat2d_cn_d20_r64``: Crank-Nicolson trajectories of the 2-D
heat equation on a serial QTT through
``ttnx_torch.solvers.round_scan.make_cn_step``.

The operator is the upstream's 2-D set-up, the Kronecker sum
``A = -(1/hg^2) (T x I + I x T)`` of ``T = toeplitz_to_qtto(2, -1, -1, da)``
built with ``kron_tto`` and ``add_op``. A unit is one step. Unit ``i`` is
step ``i % L`` of trajectory ``i // L`` (``L`` the traffic's
``trajectory``): the first step of a trajectory takes the pool's next
starting state, every other step the state the previous step returned. The
starting states are built at set-up and kept on the device. The control
path (``control=True``) is the port's own lower-precision path:
``precision=None`` with TF32 allowed for every matmul.
"""

from __future__ import annotations

import torch

from ttnx_torch.core.algebra import add_op, kron_tto
from ttnx_torch.core.tt import id_tto
from ttnx_torch.ops.operators import toeplitz_to_qtto
from ttnx_torch.solvers.round_scan import make_cn_step

from portbench.core.qtt_states2d import plane_states


class Session:
    problems_per_unit = 1

    def __init__(self, config, traffic, draws, device, control):
        da, d, R = config["d_axis"], config["d"], config["rmax"]
        dtype = getattr(torch, config["dtype"])
        torch.backends.cuda.matmul.allow_tf32 = control
        torch.backends.cudnn.allow_tf32 = control
        hg = 1.0 / (2 ** da + 1)
        T = toeplitz_to_qtto(2.0, -1.0, -1.0, da, device=device)
        eye = id_tto(da, device=device)
        A = (-1.0 / hg ** 2) * add_op(kron_tto(T, eye), kron_tto(eye, T))
        self.step, _, _ = make_cn_step(
            A, config["h"], rmax=R, dims=(2,) * d,
            u_rks=(1,) + (R,) * (d - 1) + (1,), dtype=dtype,
            sweep_count=config["sweep_count"], solver=config["solver"],
            round_method=config["round_method"],
            precision=None if control else config["precision"],
            cg_iters=config["cg_iters"])
        self.starts = plane_states(draws.modes, draws.amps, da, R, dtype,
                                   device)
        self.length = traffic["trajectory"]
        self.u = self.start = None
        self.kept, self.last = [], None

    def warmup(self):
        v = self.starts[0]
        for _ in range(2):
            v = self.step(v)

    def run(self, i, keep):
        if i % self.length == 0:
            self.start = self.starts[(i // self.length) % len(self.starts)]
            self.u = self.start
        out = self.step(self.u)
        self.last = (i, self.u, out, self.start)
        if keep:
            self.kept.append(self.last)
        self.u = out

    def close(self):
        """The kept ``(step index, input state, output state, starting
        state)`` quadruples, the last step's among them; frees the step's
        operands."""
        kept = self.kept
        if self.last is not None and (not kept or kept[-1][0] != self.last[0]):
            kept = kept + [self.last]
        self.step = self.u = self.start = self.starts = None
        self.kept = self.last = None
        return kept


def setup(config, traffic, draws, device, control=False):
    return Session(config, traffic, draws, device, control)
