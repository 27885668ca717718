"""The measured window: units back to back for a fixed number of seconds.

The host starts the clock on an idle device and issues units until the
seconds have passed; a CUDA event recorded after each unit marks when the
device finished it, and the events are read only after the closing
synchronize, so the window adds no wait of its own between units. The
window's wall time runs to the end of the last unit.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from portbench.core.trace import sync

__all__ = ["Window", "measure"]


@dataclass
class Window:
    units: int
    problems_per_unit: int
    wall_s: float
    intervals_ms: list   # from the window's start or the previous unit's end

    @property
    def problems(self) -> int:
        return self.units * self.problems_per_unit


def measure(session, seconds: float, keep, device) -> Window:
    cuda = device.type == "cuda"
    sync(device)
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    marks = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        session.run(i, keep(i))
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())
        i += 1
        if time.perf_counter() >= deadline:
            break
    sync(device)
    wall = time.perf_counter() - t0
    ends = ([start.elapsed_time(e) for e in marks] if cuda
            else [(m - t0) * 1e3 for m in marks])
    intervals = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    return Window(units=i, problems_per_unit=session.problems_per_unit,
                  wall_s=wall, intervals_ms=intervals)
