"""ttnx_torch core parity against ttnx: containers, algebra, decomposition,
canonical forms, the slice's constructors, and import hygiene.

Inputs are made with numpy from a seed and handed to both packages; the
results are compared as dense tensors (gauge-free) in float64 to 1e-12.
"""

import ast
import inspect
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ttnx
from ttnx.core import algebra as jalg
from ttnx.core import canonical as jcan
from ttnx.core import decomp as jdec
from ttnx.core import tt as jtt

import ttnx_torch
from ttnx_torch.core import algebra as talg
from ttnx_torch.core import canonical as tcan
from ttnx_torch.core import decomp as tdec
from ttnx_torch.core import tt as ttt
from ttnx_torch.ops.operators import toeplitz_to_qtto
from ttnx_torch.ops.qtt import qtt_sin
from ttnx_torch.utils.convert import (stack_from_numpy, to_numpy,
                                      ttoperator_from_numpy,
                                      ttvector_from_numpy)

TOL = 1e-12
REPO = Path(__file__).resolve().parent.parent


def _cores(rng, dims, ranks, op=False, complex_=False):
    out = []
    for k, n in enumerate(dims):
        shape = ((ranks[k], n, n, ranks[k + 1]) if op
                 else (ranks[k], n, ranks[k + 1]))
        c = rng.standard_normal(shape)
        if complex_:
            c = c + 1j * rng.standard_normal(shape)
        out.append(c)
    return out


def _pair_vec(cores, ot=None):
    return (jtt.TTVector([jnp.asarray(c) for c in cores], ot),
            ttvector_from_numpy(cores, ot, device="cpu"))


def _pair_op(cores):
    return (jtt.TTOperator([jnp.asarray(c) for c in cores]),
            ttoperator_from_numpy(cores, device="cpu"))


def _dense(x):
    if isinstance(x, (ttt.TTVector,)):
        return tdec.ttv_to_tensor(x).numpy()
    if isinstance(x, ttt.TTOperator):
        return tdec.tto_to_tensor(x).numpy()
    if isinstance(x, jtt.TTOperator):
        return np.asarray(jdec.tto_to_tensor(x))
    return np.asarray(jdec.ttv_to_tensor(x))


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.max(np.abs(ref))))
    assert float(np.max(np.abs(got - ref))) <= tol * scale


DIMS = (2, 3, 2, 2)
RANKS = (1, 2, 3, 2, 1)


@pytest.fixture
def vecs():
    rng = np.random.default_rng(7)
    a = _pair_vec(_cores(rng, DIMS, RANKS))
    b = _pair_vec(_cores(rng, DIMS, (1, 3, 2, 2, 1)))
    return a, b


@pytest.fixture
def ops():
    rng = np.random.default_rng(8)
    A = _pair_op(_cores(rng, DIMS, (1, 2, 2, 3, 1), op=True))
    B = _pair_op(_cores(rng, DIMS, (1, 3, 1, 2, 1), op=True))
    return A, B


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------


def test_container_metadata(vecs, ops):
    (ja, ta), _ = vecs
    (jA, tA), _ = ops
    assert ta.dims == ja.dims and ta.ranks == ja.ranks and ta.N == ja.N
    assert tA.dims == jA.dims and tA.ranks == jA.ranks
    assert tA.in_dims == jA.in_dims and tA.out_dims == jA.out_dims
    assert ta.dtype == torch.float64 and not ta.is_complex
    assert ta.astype(torch.float32).dtype == torch.float32
    assert "TTVector" in repr(ta) and "TTOperator" in repr(tA)
    _close(_dense(tA.T), _dense(jA.T))
    _close(_dense(tA.H), _dense(jA.H))


@pytest.mark.parametrize("rks,dims,rmax", [
    ((1, 9, 9, 9, 1), (2, 2, 2, 2), 1024),
    ((1, 5, 5, 5, 5, 1), (2, 3, 2, 2, 2), 4),
    ((1, 64, 64, 64, 64, 64, 1), (2,) * 6, 16),
])
def test_r_and_d_to_rks(rks, dims, rmax):
    assert ttt.r_and_d_to_rks(rks, dims, rmax) == jtt.r_and_d_to_rks(
        rks, dims, rmax)


def test_factories_match():
    _close(_dense(ttt.id_tto(4, device="cpu")), _dense(jtt.id_tto(4)))
    _close(_dense(ttt.zeros_tt(DIMS, rmax=3, device="cpu")),
           _dense(jtt.zeros_tt(DIMS, rmax=3)))
    assert (ttt.zeros_tt(DIMS, rmax=3, device="cpu").ranks
            == jtt.zeros_tt(DIMS, rmax=3).ranks)
    _close(_dense(ttt.ones_tt(DIMS, device="cpu")), _dense(jtt.ones_tt(DIMS)))
    assert (ttt.zeros_tto(DIMS, rmax=2, device="cpu").ranks
            == jtt.zeros_tto(DIMS, rmax=2).ranks)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_rand_tt_generator(dtype):
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    x = ttt.rand_tt(g1, (2,) * 5, rmax=3, dtype=dtype)
    y = ttt.rand_tt(g2, (2,) * 5, rmax=3, dtype=dtype)
    assert x.ranks == jtt.r_and_d_to_rks([3] * 6, (2,) * 5, rmax=3)
    for a, b in zip(x.cores, y.cores):
        assert torch.equal(a, b) and a.dtype == dtype
    q = ttt.rand_tt(torch.Generator().manual_seed(4), (2,) * 5, rmax=3,
                    normalise=True, orthogonal=True)
    for c in q.cores[:-1]:
        m = c.reshape(-1, c.shape[2])
        _close((m.T @ m).numpy(), np.eye(m.shape[1]))


def test_increase_ranks_and_concatenate(vecs):
    (ja, ta), (jb, tb) = vecs
    big = ttt.increase_ranks(ta, 5)
    _close(_dense(big), _dense(ja))
    assert big.ranks == jtt.increase_ranks(ja, 5).ranks
    noisy = ttt.increase_ranks(ta, 5, noise=1e-3,
                               generator=torch.Generator().manual_seed(0))
    assert noisy.ranks == big.ranks
    cat = ttt.concatenate(ta, tb)
    _close(_dense(cat), _dense(jtt.concatenate(ja, jb)))
    with pytest.raises(ValueError):
        ttt.increase_ranks(ta, 2)


# ---------------------------------------------------------------------------
# Algebra
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["add", "sub", "hadamard", "kron_tt"])
def test_vector_binary(vecs, name):
    (ja, ta), (jb, tb) = vecs
    _close(_dense(getattr(talg, name)(ta, tb)),
           _dense(getattr(jalg, name)(ja, jb)))


@pytest.mark.parametrize("name", ["add_op", "sub_op", "matmul",
                                  "inner_core_product", "kron_tto"])
def test_operator_binary(ops, name):
    (jA, tA), (jB, tB) = ops
    _close(_dense(getattr(talg, name)(tA, tB)),
           _dense(getattr(jalg, name)(jA, jB)))


@pytest.mark.parametrize("a", [2.5, -1.0, 0, 1j])
def test_scale(vecs, ops, a):
    (ja, ta), _ = vecs
    (jA, tA), _ = ops
    _close(_dense(talg.scale(a, ta)), _dense(jalg.scale(a, ja)))
    _close(_dense(talg.scale_op(a, tA)), _dense(jalg.scale_op(a, jA)))


def test_scale_keeps_f32():
    x = ttt.ones_tt(DIMS, dtype=torch.float32, device="cpu")
    assert talg.scale(0.5, x).dtype == torch.float32
    eye = ttt.id_tto(3, dtype=torch.float32, device="cpu")
    assert (0.5 * eye).dtype == torch.float32


def test_matvec_dot_norm(vecs, ops):
    (ja, ta), (jb, tb) = vecs
    (jA, tA), _ = ops
    _close(_dense(tA @ ta), _dense(jA @ ja))
    _close(float(talg.dot(ta, tb)), float(jalg.dot(ja, jb)))
    _close(float(talg.norm(ta)), float(jalg.norm(ja)))
    _close(float(talg.euclidean_distance(ta, tb)),
           float(jalg.euclidean_distance(ja, jb)))
    _close(float(talg.euclidean_distance_normalized(ta, tb)),
           float(jalg.euclidean_distance_normalized(ja, jb)))
    _close(_dense(talg.linear_combination([ta, tb], [2.0, -0.5])),
           _dense(jalg.linear_combination([ja, jb], [2.0, -0.5])))


def test_complex_dot_conjugates():
    rng = np.random.default_rng(11)
    ca, cb = (_cores(rng, DIMS, RANKS, complex_=True) for _ in range(2))
    ja, ta = _pair_vec(ca)
    jb, tb = _pair_vec(cb)
    got = complex(talg.dot(ta, tb))
    ref = complex(jalg.dot(ja, jb))
    assert abs(got - ref) <= TOL * abs(ref)
    _close(_dense(talg.outer_product(ta, tb)),
           _dense(jalg.outer_product(ja, jb)))


def test_diag_and_hadamard_ttm(vecs):
    (ja, ta), (jb, tb) = vecs
    _close(_dense(talg.ttv_to_diag_tto(ta)), _dense(jalg.ttv_to_diag_tto(ja)))
    _close(_dense(talg.hadamard_ttm(ta, tb)),
           _dense(jalg.hadamard_ttm(ja, jb)))


def test_rectangular_matvec():
    rng = np.random.default_rng(5)
    cores = [rng.standard_normal((1, 2, 2, 2)),
             rng.standard_normal((2, 2, 1, 2)),
             rng.standard_normal((2, 2, 2, 1))]
    jA, tA = _pair_op(cores)
    ja, ta = _pair_vec(_cores(rng, (2, 2), (1, 2, 1)))
    _close(_dense(talg.matvec(tA, ta)), _dense(jalg.matvec(jA, ja)))


# ---------------------------------------------------------------------------
# Decomposition and canonical forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index", [0, 2, 3])
def test_ttv_decomp(index):
    t = np.random.default_rng(2).standard_normal(DIMS)
    tx = tdec.ttv_decomp(t, index=index, device="cpu")
    jx = jdec.ttv_decomp(t, index=index)
    assert tx.ranks == jx.ranks and tx.ot == jx.ot
    _close(tdec.ttv_to_tensor(tx).numpy(), t)


def test_tto_decomp_and_matricize(ops, vecs):
    (jA, tA), _ = ops
    dense = _dense(jA)
    back = tdec.tto_decomp(dense, device="cpu")
    _close(_dense(back), dense, tol=1e-10)
    (ja, ta), _ = vecs
    for core in (2, 4):
        _close(tdec.matricize(ta, core).numpy(),
               np.asarray(jdec.matricize(ja, core)))
    _close(_dense(tdec.ttv_to_tto(tdec.tto_to_ttv(tA))), _dense(jA))


@pytest.mark.parametrize("center", [0, 1, 3])
def test_orthogonalize(vecs, center):
    (ja, ta), _ = vecs
    y = tcan.orthogonalize(ta, center)
    _close(_dense(y), _dense(jcan.orthogonalize(ja, center)))
    assert y.ot == jcan.orthogonalize(ja, center).ot
    for c in y.cores[:center]:
        m = c.reshape(-1, c.shape[2])
        _close((m.T @ m).numpy(), np.eye(m.shape[1]))


@pytest.mark.parametrize("max_bond,rel_tol", [(None, 0.0), (2, 0.0),
                                              (None, 1e-1)])
def test_tt_round(vecs, max_bond, rel_tol):
    (ja, ta), (jb, tb) = vecs
    tx, jx = talg.add(ta, tb), jalg.add(ja, jb)
    got = tcan.tt_round(tx, max_bond=max_bond, rel_tol=rel_tol)
    ref = jcan.tt_round(jx, max_bond=max_bond, rel_tol=rel_tol)
    assert got.ranks == ref.ranks
    _close(_dense(got), _dense(ref), tol=1e-10)


def test_svdtrunc_compress_entropy(vecs):
    (ja, ta), _ = vecs
    m = np.random.default_rng(9).standard_normal((6, 5))
    u, s, vt = tcan.svdtrunc(torch.as_tensor(m), max_bond=3)
    ju, js, jvt = jcan.svdtrunc(jnp.asarray(m), max_bond=3)
    _close(s.numpy(), np.asarray(js))
    _close((u * s) @ vt, (np.asarray(ju) * np.asarray(js)) @ np.asarray(jvt))
    _close(_dense(tcan.tt_compress(ta, max_bond=2)),
           _dense(jcan.tt_compress(ja, max_bond=2)), tol=1e-10)
    _close(tcan.entanglement_entropy(ta), jcan.entanglement_entropy(ja),
           tol=1e-10)


# ---------------------------------------------------------------------------
# The slice's constructors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 5])
def test_toeplitz_to_qtto(d):
    _close(_dense(toeplitz_to_qtto(2.0, -1.0, -0.5, d, device="cpu")),
           _dense(ttnx.toeplitz_to_qtto(2.0, -1.0, -0.5, d)))


@pytest.mark.parametrize("lam", [1.0, 3.0])
def test_qtt_sin(lam):
    d = 6
    hg = 1.0 / (2 ** d + 1)
    got = qtt_sin(d, a=hg, b=1 - hg, lam=lam, device="cpu")
    _close(_dense(got), _dense(ttnx.qtt_sin(d, a=hg, b=1 - hg, lam=lam)))
    grid = np.arange(1, 2 ** d + 1) * hg
    _close(_dense(got).reshape(-1), np.sin(lam * math.pi * grid))


def test_convert_round_trip(vecs):
    (ja, ta), _ = vecs
    back = ttvector_from_numpy(to_numpy(ta), device="cpu")
    for a, b in zip(back.cores, ta.cores):
        assert torch.equal(a, b)
    s = stack_from_numpy(np.ones((2, 3)), dtype=torch.float32, device="cpu")
    assert s.dtype == torch.float32 and to_numpy(s).shape == (2, 3)
    assert isinstance(to_numpy((s, [s]))[1], list)
    with pytest.raises(TypeError):
        to_numpy(object())


def test_public_names():
    for name in ttnx_torch.__all__:
        assert hasattr(ttnx_torch, name), name


# ttnx's manifold utilities wait for the port's autograd interop
MANIFOLD = {"ttvector_manifold", "rayleigh_quotient",
            "manifold_gradient_descent"}


def test_every_public_name_of_ttnx_resolves_on_the_port():
    names = {n for n in dir(ttnx) if not n.startswith("_")
             and not inspect.ismodule(getattr(ttnx, n))}
    missing = sorted(n for n in names - MANIFOLD
                     if not hasattr(ttnx_torch, n))
    assert not missing, missing
    assert not MANIFOLD & set(ttnx_torch.__all__)


# ---------------------------------------------------------------------------
# Import hygiene: the port and the chip smoke import neither jax nor ttnx
# ---------------------------------------------------------------------------


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


PORT_FILES = sorted((REPO / "ttnx_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "ttnx"}
    assert not bad, f"{path.name} imports {sorted(bad)}"


# ---------------------------------------------------------------------------
# One thin SVD for the whole package
# ---------------------------------------------------------------------------

SVD_CALL = re.compile(r"\b(?:torch\.svd|linalg\.svd)\(")


def test_every_thin_svd_goes_through_the_helper():
    """The one torch SVD call in ttnx_torch is ``core/linalg.thin_svd``'s,
    which picks cuSOLVER's ``gesvd`` on the card (numpy's host SVDs of
    ``core/decomp.py`` are not torch calls and stay)."""
    found = []
    for path in sorted((REPO / "ttnx_torch").rglob("*.py")):
        for line in path.read_text().splitlines():
            code = line.split("#")[0].replace("np.linalg.svd(", "")
            if SVD_CALL.search(code):
                found.append(str(path.relative_to(REPO)))
    assert found == ["ttnx_torch/core/linalg.py"], found


@pytest.mark.parametrize("shape,dtype", [((40, 7), torch.float64),
                                         ((5, 9), torch.complex128),
                                         ((64, 16), torch.float32)])
def test_thin_svd_on_the_cpu(shape, dtype):
    from ttnx_torch.core.linalg import thin_svd

    g = torch.Generator().manual_seed(0)
    m = torch.randn(shape, generator=g, dtype=dtype)
    u, s, vh = thin_svd(m)
    k = min(shape)
    assert u.shape == (shape[0], k) and vh.shape == (k, shape[1])
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    eye = torch.eye(k, dtype=dtype)
    assert float((u.conj().T @ u - eye).abs().max()) <= tol
    assert float(((u * s.to(dtype)) @ vh - m).abs().max()) <= tol * float(
        m.abs().max())
