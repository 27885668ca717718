"""Driver of ``heat_cn_d12_r64``: Crank-Nicolson trajectories of the 1-D
heat equation through ``ttnx_torch.solvers.round_scan.make_cn_step``.

A unit is one step. Unit ``i`` is step ``i % L`` of trajectory ``i // L``
(``L`` the traffic's ``trajectory``): the first step of a trajectory takes
the pool's next starting state, every other step the state the previous
step returned. The starting states are built on the device at set-up. The
control path (``control=True``) is the port's own lower-precision path:
``precision=None`` with TF32 allowed for every matmul.
"""

from __future__ import annotations

import torch

from ttnx_torch.ops.operators import toeplitz_to_qtto
from ttnx_torch.solvers.round_scan import make_cn_step

from portbench.core.qtt_states import sine_states


class Session:
    problems_per_unit = 1

    def __init__(self, config, traffic, draws, device, control):
        d, R = config["d"], config["rmax"]
        dtype = getattr(torch, config["dtype"])
        torch.backends.cuda.matmul.allow_tf32 = control
        torch.backends.cudnn.allow_tf32 = control
        hg = 1.0 / (2 ** d + 1)
        A = (-1.0 / hg ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, d,
                                                device=device)
        self.step, _, _ = make_cn_step(
            A, config["h"], rmax=R, dims=(2,) * d,
            u_rks=(1,) + (R,) * (d - 1) + (1,), dtype=dtype,
            sweep_count=config["sweep_count"], solver=config["solver"],
            round_method=config["round_method"],
            precision=None if control else config["precision"],
            cg_iters=config["cg_iters"])
        self.starts = sine_states(draws.modes, draws.amps, d, R, dtype,
                                  device)
        self.length = traffic["trajectory"]
        self.u, self.kept, self.last = None, [], None

    def warmup(self):
        v = self.starts[0]
        for _ in range(2):
            v = self.step(v)

    def run(self, i, keep):
        if i % self.length == 0:
            self.u = self.starts[(i // self.length) % len(self.starts)]
        out = self.step(self.u)
        self.last = (i, self.u, out)
        if keep:
            self.kept.append(self.last)
        self.u = out

    def close(self):
        """The kept ``(step index, input state, output state)`` triples,
        the last step's among them; frees the step's operands."""
        kept = self.kept
        if self.last is not None and (not kept or kept[-1][0] != self.last[0]):
            kept = kept + [self.last]
        self.step = self.u = self.starts = self.kept = self.last = None
        return kept


def setup(config, traffic, draws, device, control=False):
    return Session(config, traffic, draws, device, control)
