"""The public entry points of ``ttnx_torch.entry`` run where the caller
says: every function that builds tensors takes a required ``device`` (no
default, so nothing lands on the CPU unasked), and the others build on
numpy and scipy alone (the oracles and the numpy state stacks)."""

import inspect

import numpy as np
import torch

from ttnx_torch import entry

# entry points that take no device: numpy/scipy builders and oracles
HOST_ONLY = {"flat_spectrum_stack", "dense_xxx_groundstate",
             "convection_cn_operators", "dense_cn_reference"}


def test_every_tensor_builder_takes_a_required_device():
    for name in entry.__all__:
        fn = getattr(entry, name)
        params = inspect.signature(fn).parameters
        if name in HOST_ONLY:
            assert "device" not in params, name
            continue
        assert "device" in params, f"{name} has no device argument"
        assert params["device"].default is inspect.Parameter.empty, \
            f"{name} defaults device to {params['device'].default!r}"


def test_host_only_entry_points_build_on_numpy():
    """Their results hold no torch tensor."""
    hg = 1.0 / (2 ** 4 + 1)
    got = [entry.flat_spectrum_stack(np.random.default_rng(0),
                                     (1, 2, 2, 1), 2),
           entry.dense_xxx_groundstate(4),
           *entry.convection_cn_operators(4, hg, 1e-3, 10.0),
           entry.dense_cn_reference(4, hg, 1e-3, 10.0, np.ones(16), 2)]
    assert not any(torch.is_tensor(g) for g in got)
    assert isinstance(got[0], np.ndarray) and got[0].shape == (3, 2, 2, 2)


def test_three_mode_state_and_convection_operator_on_the_given_device():
    cpu = torch.device("cpu")
    u = entry.three_mode_state(4, 1.0 / 17, cpu)
    A = entry.convection_operator(4, 10.0, cpu)
    assert all(c.device == cpu for c in u.cores)
    assert all(c.device == cpu for c in A.cores)
