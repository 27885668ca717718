"""The public entry points of ``ttnx_torch.entry`` run where the caller
says: every function that builds tensors takes a required ``device`` (no
default, so nothing lands on the CPU unasked), and the others build on
numpy and scipy alone (the oracles and the numpy state stacks). The
constructors of ``ttnx_torch.ops``, of the core TT types, the rank masks
and the numpy bridge likewise take a required ``device``."""

import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from ttnx_torch import entry
from ttnx_torch.core import decomp, tt
from ttnx_torch.ops import fourier, interpolation, operators, qtt
from ttnx_torch.solvers import als_scan
from ttnx_torch.utils import convert

# entry points that take no device: numpy/scipy builders and oracles
HOST_ONLY = {"flat_spectrum_stack", "dense_xxx_groundstate",
             "convection_cn_operators", "dense_cn_reference", "mode_sum"}


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
           entry.dense_cn_reference(4, hg, 1e-3, 10.0, np.ones(16), 2),
           entry.mode_sum(4, hg, ((1, 1.0),), (0.5,))]
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
    (operators.shift, (3,)),
    (operators.gradient, (3,)),
    (operators.laplacian, (3,)),
    (operators.laplacian_DN, (4,)),
    (operators.laplacian_ND, (4,)),
    (operators.laplacian_NN, (4,)),
    (operators.laplacian_P, (4,)),
    (operators.inv_laplacian_DN, (3,)),
    (operators.qtto_prolongation, (3,)),
    (operators.qtto_constant_prolongation, (3,)),
    (operators.qtto_linear_prolongation, (3,)),
    (operators.qtt_laplacian, (2, 4)),
    (qtt.function_to_tensor, (np.sin, 3)),
    (qtt.function_to_qtt, (np.sin, 3)),
    (qtt.function_to_qtt_uniform, (np.sin, 3)),
    (qtt.qtt_polynom, ([1.0, 2.0], 3)),
    (qtt.qtt_cos, (3,)),
    (qtt.qtt_exp, (3,)),
    (qtt.qtt_chebyshev, (2, 3)),
    (qtt.qtt_basis_vector, (3, 5)),
    (qtt.qtt_trapezoidal, (3,)),
    (qtt.function_to_qttv, (lambda c: c[..., 0] * c[..., 1], 2, 2)),
    (fourier.fourier_qtto, (3,)),
    (interpolation.interpolating_qtt, (np.sin, 3, 4)),
    (interpolation.lagrange_rank_revealing, (np.sin, 3, 4)),
]

# functions of ttnx_torch.ops that build nothing from scratch: host-side
# grid maps and numpy helpers, and transforms of TT objects or tensors the
# caller already placed
NO_DEVICE = {"pauli_matrix", "gauss_chebyshev_lobatto", "index_to_point",
             "tuple_to_index", "tensor_to_grid", "qtt_to_function",
             "qtt_to_vector", "qtto_to_matrix", "to_qtt", "to_ttv",
             "QTTVector", "QTTOperator", "check_compat", "reorder",
             "reorder_vec", "reorder_op", "qttv_to_array",
             "reverse_qtt_bits", "cheb_lobatto_lagrange"}


def test_constructors_cover_the_public_ops():
    named = {fn.__name__ for fn, _ in CONSTRUCTORS}
    for mod in (operators, qtt, fourier, interpolation):
        assert set(mod.__all__) - NO_DEVICE <= named, mod.__name__
        for name in set(mod.__all__) & NO_DEVICE:
            fn = getattr(mod, name)
            if callable(fn) and not isinstance(fn, type):
                assert "device" not in inspect.signature(fn).parameters


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
    (convert.qttvector_from_numpy, ([np.ones((1, 2, 1))] * 2, 2, 1,
                                    "serial")),
    (convert.qttoperator_from_numpy, ([np.ones((1, 2, 2, 1))] * 2, 1, 2,
                                      "serial")),
    # the entry builders of slice 13, at their default sizes
    (entry.als_eig_problem, ()),
    (entry.mals_problem, ()),
    # and of the eager tier
    (entry.sine_mode_problem, ()),
]


def _devices(out):
    if torch.is_tensor(out):
        return [out.device]
    if isinstance(out, dict):
        return [d for v in out.values()
                if torch.is_tensor(v) or hasattr(v, "cores")
                for d in _devices(v)]
    return [c.device for c in out.cores]


@pytest.mark.parametrize("fn,args", CONSTRUCTORS + CORE_CONSTRUCTORS,
                         ids=[fn.__name__ for fn, _ in
                              CONSTRUCTORS + CORE_CONSTRUCTORS])
def test_ops_constructor_needs_a_device(fn, args):
    """No default device: a call without one raises TypeError, and the
    cores land where the caller says."""
    params = inspect.signature(fn).parameters
    param = params["device"]
    if fn.__module__ == entry.__name__:
        # entry builders take the device first, as every entry point does
        assert next(iter(params)) == "device"
    else:
        assert param.kind is inspect.Parameter.KEYWORD_ONLY
    assert param.default is inspect.Parameter.empty
    with pytest.raises(TypeError):
        fn(*args)
    cpu = torch.device("cpu")
    assert all(d == cpu for d in _devices(fn(*args, device=cpu)))


@pytest.mark.parametrize("fn", ["RankPool", "make_mesh"])
def test_distributed_constructor_needs_a_device(fn):
    """The rank launcher and the mesh take a required keyword ``device``:
    a call without one raises TypeError before any rank starts."""
    from ttnx_torch.parallel import batch, launch

    fn = getattr(launch, fn, None) or getattr(batch, fn)
    param = inspect.signature(fn).parameters["device"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY
    assert param.default is inspect.Parameter.empty
    with pytest.raises(TypeError, match="device"):
        fn(2)


def test_sine_mode_problem_is_a_sum_of_eigenmodes():
    """``u0`` is ``mode_sum`` with unit factors, ``A`` maps it to the
    modes scaled by ``lam``, the padded guess represents ``u0``, and the
    heat settings give :func:`three_mode_state`."""
    from ttnx_torch.core.algebra import matvec
    from ttnx_torch.core.decomp import ttv_to_tensor

    cpu = torch.device("cpu")
    d = 6
    p = entry.sine_mode_problem(cpu, d=d, modes=((1, 1.0), (5, 0.5)),
                                rmax=8)
    hg = p["hg"]

    def dense(x):
        return ttv_to_tensor(x).reshape(-1).numpy()

    ones = [1.0] * len(p["modes"])
    assert np.allclose(dense(p["u0"]), entry.mode_sum(d, hg, p["modes"],
                                                      ones), atol=1e-12)
    assert np.allclose(dense(matvec(p["A"], p["u0"])),
                       entry.mode_sum(d, hg, p["modes"], p["lam"]),
                       atol=1e-10)
    assert max(p["guess"].ranks) == 8
    assert np.allclose(dense(p["guess"]), dense(p["u0"]), atol=1e-12)
    heat = entry.sine_mode_problem(cpu, d=d, scale=1.0 / hg ** 2,
                                   modes=((1, 1.0), (3, 0.5), (9, 0.25)))
    assert np.array_equal(dense(heat["u0"]),
                          dense(entry.three_mode_state(d, hg, cpu)))


# the eager tier and the modules it brought forward
EAGER_MODULES = ["ttnx_torch.config", "ttnx_torch.utils.profiling",
                 "ttnx_torch.core.linalg", "ttnx_torch.solvers.als",
                 "ttnx_torch.solvers.mals", "ttnx_torch.solvers.dmrg",
                 "ttnx_torch.solvers.krylov", "ttnx_torch.solvers.tdvp",
                 "ttnx_torch.solvers.steppers"]


@pytest.mark.parametrize("module", EAGER_MODULES)
def test_eager_module_loads_no_jax(module):
    """Importing the module in a fresh interpreter loads neither jax nor
    ttnx."""
    import subprocess
    import sys

    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'jaxlib', 'ttnx'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
