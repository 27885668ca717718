"""Faults planted under the timed path of ``heat_batch_d12_r64``, each of
which the check has to catch: ``FAULTS[name] = (attribute of the driver,
wrapper of it)``."""

import torch


def unchanged_solve(solve):
    """Every call solves and returns the warm start, not the solutions."""
    def patched(A, b, x, *args, **kwargs):
        solve(A, b, x, *args, **kwargs)
        return x.clone()
    return patched


def half_batch(solve):
    """The first half of each batch solved, the rest returned as the warm
    start."""
    def patched(A, b, x, *args, **kwargs):
        h = b.shape[0] // 2
        return torch.cat([solve(A, b[:h], x[:h], *args, **kwargs), x[h:]])
    return patched


def altered_answer(solve):
    """One problem's solution in each call scaled by 1.01."""
    def patched(A, b, x, *args, **kwargs):
        out = solve(A, b, x, *args, **kwargs).clone()
        out[3, 0] *= 1 + 1e-2
        return out
    return patched


FAULTS = {"unchanged": ("als_sweeps_b", unchanged_solve),
          "half": ("als_sweeps_b", half_batch),
          "altered": ("als_sweeps_b", altered_answer)}
