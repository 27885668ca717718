"""The public entry points of ``ttnx_torch.entry`` run where the caller
says: every function that builds tensors takes a required ``device`` (no
default, so nothing lands on the CPU unasked), and the others build on
numpy and scipy alone (the oracles and the numpy state stacks). The
constructors of ``ttnx_torch.ops``, of the core TT types, the rank masks
and the numpy bridge likewise take a required ``device``."""

import inspect

import numpy as np
import pytest
import torch

from ttnx_torch import entry
from ttnx_torch.core import decomp, tt
from ttnx_torch.ops import operators, qtt
from ttnx_torch.solvers import als_scan
from ttnx_torch.utils import convert

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


# every public constructor of ttnx_torch.ops (and the private _op they
# share) with small arguments; pauli_matrix returns numpy and takes none
CONSTRUCTORS = [
    (operators._op, ([[[np.eye(2)]]], torch.float64)),
    (operators.toeplitz_to_qtto, (2.0, -1.0, -1.0, 4)),
    (operators.pauli_sum_tto, ("x", 3)),
    (operators.pauli_pair_sum_tto, ("x", "z", 3)),
    (operators.H_mu, ("z", 3)),
    (operators.H_munu, ("x", "x", 3)),
    (operators.heisenberg_xyz_tto, (3,)),
    (operators.ising_tto, (3,)),
    (operators.xxz_tto, (3,)),
    (operators.xxx_tto, (3,)),
    (operators.xy_tto, (3,)),
    (qtt.qtt_sin, (4,)),
]


def test_constructors_cover_the_public_ops():
    named = {fn.__name__ for fn, _ in CONSTRUCTORS}
    assert set(operators.__all__) - {"pauli_matrix"} <= named
    assert set(qtt.__all__) <= named


# the core constructors, the masks and the numpy bridge, likewise
CORE_CONSTRUCTORS = [
    (tt.zeros_tt, ((2, 2, 2),)),
    (tt.ones_tt, ((2, 2, 2),)),
    (tt.zeros_tto, ((2, 2, 2),)),
    (tt.id_tto, (3,)),
    (decomp.ttv_decomp, (np.ones((2, 2, 2)),)),
    (decomp.tto_decomp, (np.eye(4).reshape(2, 2, 2, 2),)),
    (als_scan.rank_masks, ((1, 2, 1), 2)),
    (convert.ttvector_from_numpy, ([np.ones((1, 2, 1))],)),
    (convert.ttoperator_from_numpy, ([np.ones((1, 2, 2, 1))],)),
    (convert.stack_from_numpy, (np.ones((2, 3)),)),
]


def _devices(out):
    return [out.device] if torch.is_tensor(out) else [c.device
                                                      for c in out.cores]


@pytest.mark.parametrize("fn,args", CONSTRUCTORS + CORE_CONSTRUCTORS,
                         ids=[fn.__name__ for fn, _ in
                              CONSTRUCTORS + CORE_CONSTRUCTORS])
def test_ops_constructor_needs_a_device(fn, args):
    """No default device: a call without one raises TypeError, and the
    cores land where the caller says."""
    param = inspect.signature(fn).parameters["device"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY
    assert param.default is inspect.Parameter.empty
    with pytest.raises(TypeError):
        fn(*args)
    cpu = torch.device("cpu")
    assert all(d == cpu for d in _devices(fn(*args, device=cpu)))
