"""The general traffic generator and the seeded choice of judged units.

A traffic file gives ``batch`` (problems a unit), ``pool`` (distinct
batches the units take in turn), ``modes`` (eigenmodes summed in a state),
``mode_range`` and ``amp_range`` (inclusive mode numbers and amplitudes
drawn from), ``check_every`` and ``check_span`` (about one unit in
``check_every`` of the first ``check_span`` is judged, fewer after them,
and the last), ``trace_units`` (units in the traced window) and, for a mix of
trajectories, ``trajectory`` (steps from each starting state, the states
being the pool's in turn). Every seed draws the same shapes; only the mode
numbers and amplitudes change.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import numpy as np

__all__ = ["Draws", "draw", "sampled"]


@dataclass(frozen=True)
class Draws:
    """``modes (S, M)`` distinct mode numbers and ``amps (S, M)``
    amplitudes of the ``S = pool * batch`` states, problem ``p`` of unit
    ``i`` being state ``(i % pool) * batch + p``."""
    modes: np.ndarray
    amps: np.ndarray
    batch: int
    pool: int


def draw(traffic: dict, seed: int) -> Draws:
    rng = np.random.default_rng(seed % 2 ** 64)
    batch, pool, m = traffic["batch"], traffic["pool"], traffic["modes"]
    lo, hi = traffic["mode_range"]
    states = batch * pool
    choices = np.tile(np.arange(lo, hi + 1), (states, 1))
    modes = rng.permuted(choices, axis=1)[:, :m]
    amps = rng.uniform(*traffic["amp_range"], size=(states, m))
    return Draws(modes=modes, amps=amps, batch=batch, pool=pool)


def sampled(seed: int, unit: int, every: int, span: int) -> bool:
    """Whether unit ``unit`` is judged: a hash of the seed and the index,
    so a run's sample is fixed by its seed. One unit in ``every`` of the
    first ``span`` is judged, and the period doubles with each doubling of
    the units after them, so the judged outputs a run keeps on the device
    grow with the log of its units, however fast the program gets."""
    period = every * max(1, 2 ** math.ceil(math.log2((unit + 1) / span)))
    h = hashlib.blake2b(f"{seed}/{unit}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") % period == 0
