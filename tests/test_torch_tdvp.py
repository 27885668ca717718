"""Slice 3 of ttnx_torch: the TDVP scan tier against ttnx on the CPU.

``tdvp1_step`` and ``tdvp2_step`` in the real imaginary-time form
(``imag_real=True``) and in complex real time, with Lanczos and dense
local exponentials, the ``tdvp1_scan``/``tdvp2_scan`` drivers and the
batched steps with one step size per problem, all in float64 on identical
numpy inputs (d = 6, rmax <= 4). TDVP runs no kernel. Tolerance: 1e-10 on
dense states (QR/SVD signs are a gauge, so cores are not compared).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ttnx
from ttnx.core.decomp import ttv_to_tensor as j_dense
from ttnx.core.tt import TTVector as JVec
from ttnx.parallel.batch import batched_tdvp1_steps as j_batched1
from ttnx.parallel.batch import batched_tdvp2_steps as j_batched2
from ttnx.solvers import tdvp_scan as jt
from ttnx.solvers.als_scan import unpack_tt as j_unpack

import ttnx_torch
from ttnx_torch.core.decomp import ttv_to_tensor as t_dense
from ttnx_torch.entry import tdvp_problem
from ttnx_torch.parallel import batched_tdvp1_steps, batched_tdvp2_steps
from ttnx_torch.solvers import tdvp_scan as tt
from ttnx_torch.solvers.als_scan import unpack_tt
from ttnx_torch.utils.convert import (stack_from_numpy, ttoperator_from_numpy,
                                      ttvector_from_numpy)

D, RMAX = 6, 4
# The 'gram' split resolves singular values down to sqrt(eps) |s| (1.5e-8
# in f64); an absolute cut below that keeps rounding-decided directions.
GRAM_TRUNCERR = 1e-6


def _cpu(a):
    return stack_from_numpy(a, device="cpu")


def _close(got, ref, tol):
    got, ref = np.asarray(got).reshape(-1), np.asarray(ref).reshape(-1)
    err = float(np.linalg.norm(got - ref))
    assert err <= tol * float(np.linalg.norm(ref)), err


def _problem(kind, seed=0):
    """(A_stack, x_stack, masks) numpy float64: a real symmetric generator
    (the heat operator for imaginary time, the XXZ chain for real time) and
    a normalized site-0-canonical random rank-2 state padded to RMAX."""
    rng = np.random.default_rng(seed)
    if kind == "heat":
        hg = 1.0 / (2 ** D + 1)
        H = (0.1 / hg ** 2) * ttnx_torch.toeplitz_to_qtto(-2.0, 1.0, 1.0, D,
                                                          device="cpu")
    else:
        H = ttnx_torch.xxz_tto(D, delta=0.7, h=0.3, device="cpu")
    RA = max(H.ranks)
    A = np.stack([np.pad(c.numpy(), ((0, RA - c.shape[0]), (0, 0), (0, 0),
                                     (0, RA - c.shape[3])))
                  for c in H.cores])
    rks = [1] + [min(2, 2 ** k, 2 ** (D - k)) for k in range(1, D)] + [1]
    cores = [rng.standard_normal((rks[k], 2, rks[k + 1])) for k in range(D)]
    for k in range(D - 1, 0, -1):  # right-orthonormal cores 1..D-1
        rl, nn, rr = cores[k].shape
        q, r = np.linalg.qr(cores[k].reshape(rl, nn * rr).T)
        cores[k] = q.T.reshape(rl, nn, rr)
        cores[k - 1] = np.einsum("anb,cb->anc", cores[k - 1], r)
    cores[0] /= np.linalg.norm(cores[0])
    x = np.zeros((D, RMAX, 2, RMAX))
    for k, c in enumerate(cores):
        x[k, :c.shape[0], :, :c.shape[2]] = c
    m = np.zeros((D + 1, RMAX))
    for k, r in enumerate(rks):
        m[k, :r] = 1.0
    return A, x, m


def _j_state(x, m):
    rks = [int(v) for v in np.asarray(m).real.sum(axis=1)]
    return np.asarray(j_dense(j_unpack(jnp.asarray(x), rks)))


def _t_state(x, m):
    rks = [int(v) for v in m.real.sum(dim=1).tolist()]
    return t_dense(unpack_tt(x, rks)).numpy()


# (imag_real, dt): the real imaginary-time form with the real step, or
# complex real time
FORMS = [(True, 2e-4), (False, 0.05)]


def _inputs(imag_real, seed=0):
    A, x, m = _problem("heat" if imag_real else "xxz", seed)
    dt = np.float64 if imag_real else np.complex128
    return A.astype(dt), x.astype(dt), m


@pytest.mark.parametrize("expm", ["lanczos", "dense"])
@pytest.mark.parametrize("imag_real,h", FORMS, ids=["imag_real", "complex"])
def test_tdvp1_step_matches_ttnx(imag_real, h, expm):
    A, x, m = _inputs(imag_real)
    kw = dict(expm=expm, krylov_dim=8, imag_real=imag_real)
    ref = jt.tdvp1_step(jnp.asarray(A), jnp.asarray(x), jnp.asarray(m),
                        jnp.asarray(h, A.dtype), **kw)
    got = tt.tdvp1_step(_cpu(A), _cpu(x),
                        _cpu(m), h, **kw)
    assert got.dtype == torch.float64 if imag_real else torch.complex128
    _close(_t_state(got, _cpu(m)), _j_state(ref, m), 1e-10)


@pytest.mark.parametrize("expm,split", [("lanczos", "gram"),
                                        ("dense", "svd")])
@pytest.mark.parametrize("imag_real,h", FORMS, ids=["imag_real", "complex"])
def test_tdvp2_step_matches_ttnx(imag_real, h, expm, split):
    A, x, m = _inputs(imag_real)
    kw = dict(expm=expm, krylov_dim=8, imag_real=imag_real, split=split)
    te = GRAM_TRUNCERR if split == "gram" else 1e-10
    rx, rm = jt.tdvp2_step(jnp.asarray(A), jnp.asarray(x), jnp.asarray(m),
                           jnp.asarray(h, A.dtype), jnp.float64(te),
                           jnp.int32(RMAX), **kw)
    gx, gm = tt.tdvp2_step(_cpu(A), _cpu(x),
                           _cpu(m), h, te, RMAX, **kw)
    assert np.array_equal(gm.numpy(), np.asarray(rm))
    _close(_t_state(gx, gm), _j_state(rx, rm), 1e-10)


def _heat_and_sine(d):
    hg = 1.0 / (2 ** d + 1)
    Aj = (0.1 / hg ** 2) * ttnx.toeplitz_to_qtto(-2.0, 1.0, 1.0, d)
    uj = ttnx.qtt_sin(d, a=hg, b=1 - hg)
    At = ttoperator_from_numpy([np.asarray(c) for c in Aj.cores], device="cpu")
    ut = ttvector_from_numpy([np.asarray(c) for c in uj.cores], device="cpu")
    return Aj, uj, At, ut


@pytest.mark.parametrize("dtype", [None, "float64"], ids=["c128", "f64"])
def test_tdvp1_scan_matches_ttnx(dtype):
    Aj, uj, At, ut = _heat_and_sine(D)
    steps = [1e-4] * 3
    ref = jt.tdvp1_scan(Aj, uj, steps, imaginary_time=True, rmax=RMAX,
                        krylov_dim=8,
                        dtype=None if dtype is None else jnp.float64)
    got = tt.tdvp1_scan(At, ut, steps, imaginary_time=True, rmax=RMAX,
                        krylov_dim=8,
                        dtype=None if dtype is None else torch.float64)
    _close(t_dense(got).numpy(), np.asarray(j_dense(ref)), 1e-10)


def test_tdvp2_scan_matches_ttnx_real_time():
    Hj = ttnx.xxz_tto(D, delta=0.7, h=0.3)
    cores = [np.asarray(c) for c in ttnx.qtt_sin(D).cores]
    u0j = JVec([jnp.asarray(c) for c in cores])
    Ht = ttoperator_from_numpy([np.asarray(c) for c in Hj.cores], device="cpu")
    ref = jt.tdvp2_scan(Hj, u0j, [0.05] * 2, rmax=RMAX, krylov_dim=8,
                        truncerr=1e-10)
    got = tt.tdvp2_scan(Ht, ttvector_from_numpy(cores, device="cpu"),
                        [0.05] * 2, rmax=RMAX, krylov_dim=8, truncerr=1e-10)
    assert got.ranks == ref.ranks
    _close(t_dense(got).numpy(), np.asarray(j_dense(ref)), 1e-10)


def test_lanczos_rejects_non_hermitian_generator():
    Aj, uj, At, ut = _heat_and_sine(4)
    At = ttoperator_from_numpy([np.asarray(c) for c in ttnx.toeplitz_to_qtto(
        2.0, -1.0, -0.5, 4).cores], device="cpu")
    with pytest.raises(ValueError, match="Hermitian"):
        tt.tdvp1_scan(At, ut, [0.01])
    with pytest.raises(ValueError):
        tt.tdvp1_scan(At, ut, [0.01], expm="dense", dtype=torch.float64)


def _batch(imag_real, B=3):
    As, xs, ms = [], [], []
    for i in range(B):
        A, x, m = _inputs(imag_real, seed=10 + i)
        As.append(A)
        xs.append(x)
        ms.append(m)
    return np.stack(As), np.stack(xs), np.stack(ms)


@pytest.mark.parametrize("imag_real,h", [(True, [1e-4, 2e-4, 3e-4]),
                                         (False, [0.02, 0.04, 0.06]),
                                         (True, 2e-4)],
                         ids=["imag_real", "complex", "imag_real-scalar"])
def test_batched_tdvp1_steps_match_ttnx(imag_real, h):
    """One step per problem (a tensor), or one Python float for all."""
    A, x, m = _batch(imag_real)
    A = A[0]  # one shared generator
    kw = dict(n_steps=2, krylov_dim=8, imag_real=imag_real)
    hj = jnp.asarray(h, x.dtype)
    ht = h if np.isscalar(h) else torch.as_tensor(np.asarray(h, x.dtype))
    ref = j_batched1(jnp.asarray(A), jnp.asarray(x), jnp.asarray(m), hj,
                     **kw)
    got = batched_tdvp1_steps(_cpu(A), _cpu(x),
                              _cpu(m), ht, **kw)
    for i in range(len(x)):
        _close(_t_state(got[i], _cpu(m[i])),
               _j_state(np.asarray(ref)[i], m[i]), 1e-10)


def test_batched_tdvp2_steps_match_ttnx():
    A, x, m = _batch(True)  # one generator per problem (6-D)
    h = [1e-4, 2e-4, 3e-4]
    kw = dict(n_steps=2, krylov_dim=8, imag_real=True, split="gram")
    rx, rm = j_batched2(jnp.asarray(A), jnp.asarray(x), jnp.asarray(m),
                        jnp.asarray(h), GRAM_TRUNCERR, RMAX, **kw)
    gx, gm = batched_tdvp2_steps(_cpu(A), _cpu(x),
                                 _cpu(m),
                                 torch.tensor(h, dtype=torch.float64),
                                 GRAM_TRUNCERR, RMAX, **kw)
    assert np.array_equal(gm.numpy(), np.asarray(rm))
    for i in range(len(h)):
        _close(_t_state(gx[i], gm[i]),
               _j_state(np.asarray(rx)[i], np.asarray(rm)[i]), 1e-10)


def test_tdvp_problem_is_site0_canonical():
    p = tdvp_problem(torch.device("cpu"), d=6, rmax=4, dtype=torch.float64)
    x = p["x_stack"]
    for k in range(1, 6):  # right-orthonormal cores 1..d-1
        c = x[k].reshape(4, -1)
        g = c @ c.T
        r = p["u_rks"][k]
        assert torch.allclose(g[:r, :r], torch.eye(r, dtype=g.dtype),
                              atol=1e-12)
    dense = _t_state(x, p["masks"])
    _close(dense, t_dense(p["u0"]).numpy(), 1e-12)
