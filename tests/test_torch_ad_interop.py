"""Autograd interop of ttnx_torch against ttnx's ``jax.grad`` on the CPU,
in float64: mirrors the ``TestAutodiff`` and ``TestManifold`` cases of
tests/test_ad_interop.py, holds the port's core gradients to ttnx's, and
checks the refusals and the NaN trap.

Gradient parity: the same cores, drawn from a numpy seed, go through a
gauge-invariant scalar cost in both packages; the gradient with respect to
the input cores is unique whatever gauge either side takes inside, so the
cores of the two gradients are compared directly, at relative 1e-10 (1e-8
for one ALS sweep). Complex cores: for a real cost, ``jax.grad`` returns
``dL/dRe - i dL/dIm`` and torch ``dL/dRe + i dL/dIm``, so the port's
gradient is compared with the conjugate of ttnx's.

Refusals: ``tt_round``/``tt_compress`` read singular values on the host
and raise under autodiff in both packages; every kernel wrapper raises at
its gradient gate on CPU inputs that require grad (no plain fallback).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ttnx
from ttnx.utils import manifold as jman

import ttnx_torch as tx
from ttnx_torch.kernels import (als_sweep_fused, contraction, dispatch,
                                env_chain, gram, lanczos, local_cg,
                                local_cg_mf, qr_batched)
from ttnx_torch.utils import manifold as tman
from ttnx_torch.utils.convert import (to_ttvector, ttoperator_from_numpy,
                                      ttvector_from_numpy)
from ttnx_torch.utils.validation import debug_nans

CPU = torch.device("cpu")


def rand_cores(seed, dims, r, cplx=False):
    rng = np.random.default_rng(seed)
    rks = ttnx.r_and_d_to_rks([1] + [r] * (len(dims) - 1) + [1], dims,
                              rmax=r)
    out = []
    for k, n in enumerate(dims):
        shape = (rks[k], n, rks[k + 1])
        c = rng.standard_normal(shape)
        if cplx:
            c = c + 1j * rng.standard_normal(shape)
        out.append(c / np.sqrt(n * r))
    return out


def op_cores(seed, d, r):
    rng = np.random.default_rng(seed)
    rks = [1] + [r] * (d - 1) + [1]
    return [rng.standard_normal((rks[k], 2, 2, rks[k + 1])) / (2 * r)
            for k in range(d)]


def j_vec(cores):
    return ttnx.TTVector([jnp.asarray(c) for c in cores])


def j_op(cores):
    return ttnx.TTOperator([jnp.asarray(c) for c in cores])


def t_vec(cores):
    return ttvector_from_numpy(cores, device=CPU)


def t_op(cores):
    return ttoperator_from_numpy(cores, device=CPU)


def t_core_grad(cost, cores, cls=tx.TTVector):
    """The port's core gradient: ``tman.core_grad`` for vectors (zeros for a
    core the cost does not reach, as ``jax.grad``), autograd for
    operators."""
    if cls is tx.TTVector:
        grads = tman.core_grad(cost, t_vec(cores))
    else:
        leaves = [torch.as_tensor(c).requires_grad_() for c in cores]
        grads = torch.autograd.grad(cost(cls(leaves)), leaves)
    return [g.resolve_conj().numpy() for g in grads]


def j_core_grad(cost, cores, make=j_vec):
    g = jax.grad(cost)(make(cores))
    return [np.asarray(gc) for gc in g.cores]


def _same_grad(got, ref, rtol):
    assert len(got) == len(ref)
    scale = max(float(np.max(np.abs(r))) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float(np.max(np.abs(g - r))) <= rtol * scale


# ---------------------------------------------------------------------------
# Gradient parity with ttnx's jax.grad
# ---------------------------------------------------------------------------

DIMS = (2, 3, 2, 2)
D = (2,) * 5
B_CORES = rand_cores(2, DIMS, 3)
BQ = rand_cores(4, D, 2)
H_CORES = op_cores(3, 5, 2)
T_DENSE = np.random.default_rng(5).standard_normal(DIMS)


def _case(name):
    """(ttnx cost, port cost, input cores, operator input?) of one case;
    each cost takes a TTVector (a TTOperator for ``matmul``)."""
    jb, tb = j_vec(B_CORES), t_vec(B_CORES)
    jbq, tbq = j_vec(BQ), t_vec(BQ)
    jH, tH = j_op(H_CORES), t_op(H_CORES)
    a = rand_cores(1, DIMS, 3)
    aq = rand_cores(6, D, 3)
    cases = {
        "dot": (lambda x: ttnx.dot(x, jb), lambda x: tx.dot(x, tb), a),
        "matvec": (lambda x: jnp.real(ttnx.dot(x, ttnx.matvec(jH, x))),
                   lambda x: torch.real(tx.dot(x, tx.matvec(tH, x))), aq),
        "norm": (ttnx.norm, tx.norm, a),
        "add_scale": (
            lambda x: ttnx.norm(ttnx.add(x, ttnx.scale(-0.7, jb))),
            lambda x: tx.norm(tx.add(x, tx.scale(-0.7, tb))), a),
        "hadamard": (lambda x: ttnx.dot(ttnx.hadamard(x, x), jb),
                     lambda x: tx.dot(tx.hadamard(x, x), tb), a),
        "kron_tt": (
            lambda x: ttnx.dot(ttnx.kron_tt(x, jb), ttnx.kron_tt(jb, x)),
            lambda x: tx.dot(tx.kron_tt(x, tb), tx.kron_tt(tb, x)), a),
        "matmul": (
            lambda A: ttnx.dot(jbq, ttnx.matvec(ttnx.matmul(A, A), jbq)),
            lambda A: tx.dot(tbq, tx.matvec(tx.matmul(A, A), tbq)),
            H_CORES),
        "euclidean_distance": (
            lambda x: ttnx.euclidean_distance(x, jb),
            lambda x: tx.euclidean_distance(x, tb), a),
        "orthogonalize": (
            lambda x: ttnx.dot(ttnx.orthogonalize(x, 2), jb),
            lambda x: tx.dot(tx.orthogonalize(x, 2), tb), a),
        "ttv_to_tensor": (
            lambda x: jnp.sum(ttnx.ttv_to_tensor(x) ** 3 * T_DENSE),
            lambda x: torch.sum(tx.ttv_to_tensor(x) ** 3
                                * torch.as_tensor(T_DENSE)), a),
    }
    j_cost, t_cost, cores = cases[name]
    return j_cost, t_cost, cores, name == "matmul"


@pytest.mark.parametrize("name", [
    "dot", "matvec", "norm", "add_scale", "hadamard", "kron_tt", "matmul",
    "euclidean_distance", "orthogonalize", "ttv_to_tensor"])
def test_core_gradient_matches_jax_grad(name):
    j_cost, t_cost, cores, is_op = _case(name)
    ref = j_core_grad(j_cost, cores, j_op if is_op else j_vec)
    got = t_core_grad(t_cost, cores, tx.TTOperator if is_op else tx.TTVector)
    _same_grad(got, ref, 1e-10)


def test_complex_dot_gradient_is_the_conjugate_of_jax_grad():
    a = rand_cores(7, (2, 2, 2), 2, cplx=True)
    b = rand_cores(8, (2, 2, 2), 2, cplx=True)
    jb, tb = j_vec(b), t_vec(b)
    ref = j_core_grad(lambda x: jnp.real(ttnx.dot(x, jb)), a)
    got = t_core_grad(lambda x: torch.real(tx.dot(x, tb)), a)
    assert got[0].dtype == np.complex128
    _same_grad(got, [np.conj(r) for r in ref], 1e-10)


def test_als_linsolve_gradient_matches_jax_grad():
    """One ALS half-sweep pair, differentiated with respect to the guess:
    through the local dense solves and the QR gauge moves."""
    d = 5
    A = ttnx.id_tto(d) + 0.3 * ttnx.laplacian(d)
    tA = tx.id_tto(d, device=CPU) + 0.3 * tx.laplacian(d, device=CPU)
    x0 = rand_cores(9, (2,) * d, 2)
    c = rand_cores(10, (2,) * d, 3)
    jc, tc = j_vec(c), t_vec(c)
    jbq, tbq = j_vec(BQ), t_vec(BQ)
    ref = j_core_grad(lambda x: ttnx.dot(
        jc, ttnx.als_linsolve(A, jbq, x, sweep_count=2)), x0)
    got = t_core_grad(lambda x: tx.dot(
        tc, tx.als_linsolve(tA, tbq, x, sweep_count=2)), x0)
    _same_grad(got, ref, 1e-8)


# ---------------------------------------------------------------------------
# TestAutodiff, mirrored
# ---------------------------------------------------------------------------


def test_grad_dot_matches_fd():
    a = t_vec(rand_cores(11, (2, 2, 2), 2))
    b = t_vec(rand_cores(12, (2, 2, 2), 2))
    f = lambda x: tx.dot(x, b)  # noqa: E731
    g = t_core_grad(f, [c.numpy() for c in a.cores])
    eps = 1e-6
    for site in range(3):
        probe = torch.zeros_like(a.cores[site])
        i = 0 if site == 0 else 1
        probe[i, 0, 0] = 1.0
        ap = tx.TTVector([c + eps * probe if k == site else c
                          for k, c in enumerate(a.cores)])
        am = tx.TTVector([c - eps * probe if k == site else c
                          for k, c in enumerate(a.cores)])
        fd = (float(f(ap)) - float(f(am))) / (2 * eps)
        assert np.isclose(g[site][i, 0, 0], fd, atol=1e-5)


def test_grad_matvec_energy():
    d = 4
    H = tx.laplacian(d, device=CPU)
    x = t_vec(rand_cores(13, (2,) * d, 2))
    f = lambda v: torch.real(tx.dot(v, tx.matvec(H, v)))  # noqa: E731
    g = t_core_grad(f, [c.numpy() for c in x.cores])
    direction = t_vec(rand_cores(14, (2,) * d, 2))
    eps = 1e-6
    xp = tx.TTVector([c + eps * dc for c, dc in
                      zip(x.cores, direction.cores)])
    xm = tx.TTVector([c - eps * dc for c, dc in
                      zip(x.cores, direction.cores)])
    fd = (float(f(xp)) - float(f(xm))) / (2 * eps)
    inner = sum(float((torch.as_tensor(gc) * dc).sum())
                for gc, dc in zip(g, direction.cores))
    assert np.isclose(inner, fd, rtol=1e-5)


def test_grad_complex_dot():
    a = rand_cores(15, (2, 2), 2, cplx=True)
    b = t_vec(rand_cores(16, (2, 2), 2, cplx=True))
    g = t_core_grad(lambda x: torch.real(tx.dot(x, b)), a)
    assert g[0].dtype == np.complex128


@pytest.fixture(scope="module")
def xxz_start():
    """ttnx's reference start of the descent test (heisenberg_xyz_tto(5),
    a normalised orthogonal rank-6 draw), as numpy cores."""
    x0 = ttnx.rand_tt(jax.random.PRNGKey(1234), (2,) * 5, rmax=6,
                      normalise=True, orthogonal=True)
    return [np.asarray(c) for c in x0.cores], x0


def test_manifold_descent_history_matches_ttnx(xxz_start):
    cores, jx0 = xxz_start
    _, j_hist = jman.manifold_gradient_descent(
        jman.rayleigh_quotient(ttnx.heisenberg_xyz_tto(5)), jx0, steps=50,
        lr=0.05)
    _, t_hist = tman.manifold_gradient_descent(
        tman.rayleigh_quotient(tx.heisenberg_xyz_tto(5, device=CPU)),
        t_vec(cores), steps=50, lr=0.05)
    assert isinstance(t_hist, np.ndarray) and t_hist.shape == (50,)
    np.testing.assert_allclose(t_hist, j_hist, rtol=1e-8)


def test_gradient_descent_reaches_dmrg_energy(xxz_start):
    cores, _ = xxz_start
    H = tx.heisenberg_xyz_tto(5, device=CPU)
    cost = tx.rayleigh_quotient(H)
    x0 = t_vec(cores)
    e0 = float(cost(x0))
    x, hist = tx.manifold_gradient_descent(cost, x0, steps=250, lr=0.05)
    e_dense = np.linalg.eigvalsh(tx.qtto_to_matrix(H).numpy())[0]
    assert all(hist[i + 1] <= hist[i] + 1e-9 for i in range(len(hist) - 1))
    assert hist[-1] < e0 - 1.0
    assert hist[-1] > e_dense - 1e-6
    assert hist[-1] < e_dense + 0.2
    assert all(not c.requires_grad for c in x.cores)


def test_torch_optim_compatibility():
    """The twin of ``test_optax_compatibility``: torch.optim.Adam on a list
    of leaf cores, the cost built as ``TTVector(cores)``."""
    d = 4
    H = tx.laplacian(d, device=CPU)
    cost = tx.rayleigh_quotient(H)
    x = tx.rand_tt(torch.Generator().manual_seed(1234), (2,) * d, rmax=4,
                   normalise=True, orthogonal=True)
    cores = [c.clone().requires_grad_() for c in x.cores]
    assert tx.TTVector(cores).cores[0] is cores[0]  # the leaves are kept
    opt = torch.optim.Adam(cores, lr=0.05)
    value0 = float(cost(x))
    for _ in range(100):
        opt.zero_grad()
        val = cost(tx.TTVector(cores))
        val.backward()
        opt.step()
    e_dense = np.linalg.eigvalsh(tx.qtto_to_matrix(H).numpy())[0]
    assert float(val) < value0
    assert float(val) - e_dense < 1e-2


# ---------------------------------------------------------------------------
# TestManifold and TestConverters, mirrored
# ---------------------------------------------------------------------------


def vec(x):
    return tx.ttv_to_tensor(x).reshape(-1).numpy()


def test_manifold_ops():
    p = t_vec(rand_cores(17, (2, 2, 2), 2))
    X = t_vec(rand_cores(18, (2, 2, 2), 2))
    M = tx.ttvector_manifold(p)
    assert isinstance(M, tman.TTVectorSpace)
    assert np.isclose(float(M.inner(p, X, X)), vec(X) @ vec(X))
    assert np.isclose(float(M.norm(p, X)), np.linalg.norm(vec(X)))
    assert np.isclose(float(M.distance(p, X)),
                      np.linalg.norm(vec(p) - vec(X)))
    z = M.zero_vector(p)
    assert np.allclose(vec(z), 0.0) and z.ranks == p.ranks
    moved = M.retract(p, X, 0.5)
    assert np.allclose(vec(moved), vec(p) + 0.5 * vec(X), atol=1e-12)
    rounded = M.retract(p, X, 0.5, max_bond=2)
    assert max(rounded.ranks) <= 2


def test_manifold_names_match_ttnx():
    assert set(jman.__all__) <= set(tman.__all__)
    assert {"TTVectorSpace"} <= set(tman.__all__)


def test_to_ttvector_contracts_like_ttnx():
    rng = np.random.default_rng(1234)
    cores = [rng.standard_normal((1, 3, 2)), rng.standard_normal((2, 4, 2)),
             rng.standard_normal((2, 2, 1))]
    tt = to_ttvector(cores, device=CPU)
    assert tt.dims == (3, 4, 2)
    ref = np.einsum("aib,bjc,ckd->aijkd", *cores)[0, ..., 0]
    assert np.allclose(tx.ttv_to_tensor(tt).numpy(), ref)
    assert np.allclose(
        np.asarray(ttnx.ttv_to_tensor(ttnx.to_ttvector(cores))), ref)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tt_round", "tt_compress"])
def test_rounding_refuses_autodiff_in_both_packages(name):
    cores = rand_cores(19, (2,) * 5, 3)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jax.grad(lambda x: ttnx.norm(getattr(ttnx, name)(x, max_bond=2)))(
            j_vec(cores))
    leaves = [torch.as_tensor(c).requires_grad_() for c in cores]
    with pytest.raises(RuntimeError, match="requires grad"):
        tx.norm(getattr(tx, name)(tx.TTVector(leaves), max_bond=2))


def _wrapper_cases():
    """Each registered kernel wrapper with CPU inputs of a shape its plain
    version takes: ``(wrapper, args, kwargs)``."""
    rng = np.random.default_rng(20)

    def t(*shape, dtype=torch.float64):
        return torch.as_tensor(rng.standard_normal(shape) / 4).to(dtype)

    d, R, n, RA, Rb, B, M = 3, 4, 2, 3, 2, 2, 6
    g = t(M, M)
    K = g @ g.T + torch.eye(M, dtype=torch.float64)
    v0 = t(M)
    v0 = v0 / v0.norm()
    masks = torch.ones((d + 1, R), dtype=torch.float64)
    masks[0, 1:] = 0.0
    masks[-1, 1:] = 0.0
    f32 = dict(dtype=torch.float32)
    return {
        "gram_chain_fused": (gram.gram_chain_fused, (t(d, R, n, R),), {}),
        "right_env_chain_fused": (env_chain.right_env_chain_fused,
                                  (t(d, R, n, R), t(d, RA, n, n, RA),
                                   t(d, Rb, n, Rb)), {}),
        "left_env_chain_fused": (env_chain.left_env_chain_fused,
                                 (t(d, R, n, R), t(d, RA, n, n, RA),
                                  t(d, Rb, n, Rb)), {}),
        "env_chain_fused_batched": (env_chain.env_chain_fused_batched,
                                    (t(B, d, R, n, R), t(d, RA, n, n, RA),
                                     t(B, d, Rb, n, Rb)), {}),
        "env_chain_A_fused": (env_chain.env_chain_A_fused,
                              (t(d, R, n, R), t(d, RA, n, n, RA)), {}),
        "lanczos_fused": (lanczos.lanczos_fused, (K, v0), dict(iters=3)),
        "als_fwd_bwd_fused_batched": (
            als_sweep_fused.als_fwd_bwd_fused_batched,
            (t(d, RA, n, n, RA), t(B, d, R, n, R), t(B, d, R, n, R), masks),
            dict(cg_iters=2, ns_iters=(2, 2))),
        "two_site_merge": (contraction.two_site_merge,
                           (t(B, 3, 4, **f32), t(B, 4, 5, **f32)), {}),
        "matmul_chain": (contraction.matmul_chain,
                         (t(B, 3, 4, **f32), t(B, 4, 4, **f32)),
                         dict(iters=2)),
        "merge_resplit_chain": (contraction.merge_resplit_chain,
                                (t(B, 3, 4, **f32), t(B, 4, 5, **f32),
                                 t(B, 5, 4, **f32)), dict(iters=2)),
        "cg_solve_fused": (local_cg.cg_solve_fused, (K, t(M)),
                           dict(x0=t(M), iters=3)),
        "bicgstab_solve_fused": (local_cg.bicgstab_solve_fused, (K, t(M)),
                                 dict(iters=3)),
        "cg_matfree_fused": (local_cg_mf.cg_matfree_fused,
                             (t(R, RA, R), t(RA, n, n, RA), t(R, RA, R),
                              t(R, n, R), torch.ones(R, n, R,
                                                     dtype=torch.float64)),
                             dict(x0=t(R, n, R), iters=3)),
        "cg_matfree_fused_batched": (
            local_cg_mf.cg_matfree_fused_batched,
            (t(B, R, RA, R), t(RA, n, n, RA), t(B, R, RA, R), t(B, R, n, R),
             torch.ones(R, n, R, dtype=torch.float64)),
            dict(x0=t(B, R, n, R), iters=3)),
        "qr_batched": (qr_batched.qr_batched, (t(B, n * R, R),),
                       dict(rows=False)),
    }


WRAPPERS = sorted(_wrapper_cases())


def test_every_registered_wrapper_has_a_refusal_case():
    assert set(WRAPPERS) == set(dispatch.launch_counts())


@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrapper_refuses_gradients_at_the_gate(name):
    wrapper, args, kwargs = _wrapper_cases()[name]
    slots = [("arg", i) for i, a in enumerate(args)] + [
        ("kw", k) for k, v in kwargs.items() if isinstance(v, torch.Tensor)]
    for kind, slot in slots:
        a = list(args)
        kw = dict(kwargs)
        if kind == "arg":
            a[slot] = a[slot].clone().requires_grad_()
        else:
            kw[slot] = kw[slot].clone().requires_grad_()
        with pytest.raises(RuntimeError, match=f"{name}: the kernel has no "
                                               f"backward"):
            wrapper(*a, **kw)
        with torch.no_grad():  # no gradient asked: the plain version runs
            out = wrapper(*a, **kw)
        assert all(not o.requires_grad for o in
                   (out if isinstance(out, tuple) else (out,)))
    assert dispatch.route_counts()[name] == {}


# ---------------------------------------------------------------------------
# debug_nans
# ---------------------------------------------------------------------------


def _gram_input_with_nan():
    y = torch.as_tensor(np.random.default_rng(21).standard_normal(
        (3, 4, 2, 4)))
    y[-1, 0, 0, 0] = float("nan")
    return y


def test_debug_nans_raises_on_a_torch_op():
    x = torch.tensor([0.0, 1.0], dtype=torch.float64)
    with debug_nans():
        with pytest.raises(FloatingPointError, match="div"):
            x / x
        with pytest.raises(FloatingPointError, match="__setitem__"):
            x[0] = float("nan")
    assert torch.isnan(x / x).any()  # off again


def test_debug_nans_raises_in_a_kernel_wrappers_plain_path():
    y = _gram_input_with_nan()
    with debug_nans():
        with pytest.raises(FloatingPointError, match="NaN in the output of"):
            gram.gram_chain_fused(y)


def test_kernel_wrapper_checks_its_own_outputs_under_the_trap():
    """A CUDA launch is invisible to the function mode: the wrapper checks
    what it returns, and names the kernel."""
    y = _gram_input_with_nan()
    saved = dispatch.NAN_TRAP.on
    dispatch.NAN_TRAP.on = True
    try:
        with pytest.raises(FloatingPointError, match="gram_chain_fused"):
            gram.gram_chain_fused(y)
    finally:
        dispatch.NAN_TRAP.on = saved


def test_debug_nans_off_does_not_raise():
    y = _gram_input_with_nan()
    assert torch.isnan(gram.gram_chain_fused(y)).any()
    with debug_nans():
        with debug_nans(False):
            assert torch.isnan(gram.gram_chain_fused(y)).any()
            assert not torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError):
            gram.gram_chain_fused(y)


def test_debug_nans_checks_the_backward_pass():
    a = torch.tensor([1.0, -1.0], dtype=torch.float64, requires_grad=True)
    with torch.no_grad():
        b = torch.sqrt(a)  # a NaN made outside the trap
    loss = (a * b).sum()
    with debug_nans():
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            loss.backward()


@pytest.mark.parametrize("raise_inside", [False, True])
def test_debug_nans_restores_the_previous_state(raise_inside):
    anomaly = torch.is_anomaly_enabled()
    assert not dispatch.NAN_TRAP.on
    try:
        with debug_nans():
            assert dispatch.NAN_TRAP.on and torch.is_anomaly_enabled()
            with debug_nans(False):
                assert not dispatch.NAN_TRAP.on
            assert dispatch.NAN_TRAP.on
            if raise_inside:
                raise KeyError("inside")
    except KeyError:
        assert raise_inside
    assert not dispatch.NAN_TRAP.on
    assert torch.is_anomaly_enabled() == anomaly
    x = torch.tensor([0.0])
    assert torch.isnan(x / x).all()
