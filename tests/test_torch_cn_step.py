"""The slice end to end: the Crank–Nicolson step of ttnx_torch against
ttnx's on the same problem, in float64 on the CPU (plain versions of the
kernels), compared as represented (dense) vectors.

* d=8, rmax=8: the dense-K local CG path (kernel B3), 3 steps.
* d=6, rmax=32: the matrix-free local CG path (kernel B4), 2 steps. ttnx's
  matrix-free kernel computes its products in float32 even for float64
  input (3.4e-8 off its own float64 path here), so this case holds the port
  to ttnx's float64 einsum CG — the computation that kernel fuses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ttnx
from ttnx.core.decomp import ttv_to_tensor as j_dense
from ttnx.solvers import round_scan as j_rs
from ttnx.solvers.als_scan import als_linsolve_scan as j_linsolve

import ttnx_torch as tx
from ttnx_torch.core.decomp import ttv_to_tensor as t_dense
from ttnx_torch.solvers import round_scan as t_rs
from ttnx_torch.utils.convert import ttvector_from_numpy

TOL = 1e-10


def _rel(got, ref):
    got, ref = np.asarray(got).reshape(-1), np.asarray(ref).reshape(-1)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _host(pkg):
    """The port's constructors take a required device: the CPU here."""
    return dict(device="cpu") if pkg is tx else {}


def _laplacian(pkg, d):
    hg = 1.0 / (2 ** d + 1)
    return (-1.0 / hg ** 2) * pkg.toeplitz_to_qtto(2.0, -1.0, -1.0, d,
                                                   **_host(pkg)), hg


def _run(pkg, rs, d, rmax, steps, dtype, h=1e-6, **kw):
    A, hg = _laplacian(pkg, d)
    step, pack, unpack = rs.make_cn_step(
        A, h, rmax=rmax, dims=(2,) * d,
        u_rks=(1,) + (rmax,) * (d - 1) + (1,), dtype=dtype, **kw)
    u = pack(pkg.qtt_sin(d, a=hg, b=1 - hg, **_host(pkg)))
    for _ in range(steps):
        u = step(u)
    return unpack(u)


def _both(d, rmax, steps, j_kw=None, **kw):
    j_kw = dict(kw, **(j_kw or {}))
    ref = np.asarray(j_dense(_run(ttnx, j_rs, d, rmax, steps, jnp.float64,
                                  **j_kw)))
    got = t_dense(_run(tx, t_rs, d, rmax, steps, torch.float64,
                       **kw)).numpy()
    return got, ref


FLAGSHIP = dict(sweep_count=2, solver="cg_fused", round_method="gram_chain",
                precision="highest", cg_iters=16)


def test_cn_step_dense_cg_path_matches_ttnx():
    got, ref = _both(8, 8, 3, **FLAGSHIP)
    assert _rel(got, ref) <= TOL


def test_cn_step_matfree_cg_path_matches_ttnx():
    got, ref = _both(6, 32, 2, j_kw=dict(solver="cg"), **FLAGSHIP)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("kw,j_kw,tol", [
    # ttnx's masked QR sweep drops weight on scattered masks (see
    # test_rounding_matches_oracle): hold 'svd' to ttnx's exact Gram chain
    (dict(round_method="svd", solver="lu"),
     dict(round_method="gram_chain"), 1e-10),
    # the Gram-form rounding squares the condition number of directions
    # below sqrt(eps) * sigma_max, so two LAPACK eigh builds part at ~1e-8
    (dict(round_method="gram", solver="cg", orth="polar", cg_iters=40),
     None, 1e-6),
    (dict(round_method="gram_chain", solver="bicgstab", cg_iters=24),
     None, 1e-10),
    (dict(round_method="gram_chain", solver="lu", round_rhs=False),
     None, 1e-10),
    # dense-K BiCGStab (kernel B10's plain version) against ttnx's kernel
    (dict(round_method="gram_chain", solver="bicgstab_fused", cg_iters=24),
     None, 1e-10),
], ids=["svd-lu", "gram-cg-polar", "gramchain-bicgstab", "unrounded-lu",
        "gramchain-bicgstab_fused"])
def test_cn_step_options_match_ttnx(kw, j_kw, tol):
    got, ref = _both(6, 4, 1, j_kw=j_kw, sweep_count=2, **kw)
    assert _rel(got, ref) <= tol


def test_cn_step_closed_form():
    """One eigenmode decays at exp(-lambda_1 t): ranks 8, 5 steps."""
    d, rmax = 8, 8
    A, hg = _laplacian(tx, d)
    step, pack, unpack = t_rs.make_cn_step(
        A, 1e-7, rmax=rmax, dims=(2,) * d,
        u_rks=(1,) + (rmax,) * (d - 1) + (1,), sweep_count=3,
        round_method="gram_chain")
    u0 = tx.qtt_sin(d, a=hg, b=1 - hg, device="cpu")
    u = pack(u0)
    for _ in range(5):
        u = step(u)
    lam1 = (2 - 2 * np.cos(np.pi / (2 ** d + 1))) / hg ** 2
    expect = t_dense(u0).numpy() * np.exp(-lam1 * 5e-7)
    assert _rel(t_dense(unpack(u)).numpy(), expect) < 1e-12


def test_make_cn_evolve_matches_stepping():
    d, rmax = 6, 8
    A, hg = _laplacian(tx, d)
    kw = dict(dims=(2,) * d, u_rks=(1,) + (rmax,) * (d - 1) + (1,),
              sweep_count=2)
    step, pack, _ = t_rs.make_cn_step(A, 1e-6, rmax, **kw)
    evolve, pack2, _ = t_rs.make_cn_evolve(A, 1e-6, rmax, n_steps=3, **kw)
    u0 = tx.qtt_sin(d, a=hg, b=1 - hg, device="cpu")
    u = pack(u0)
    for _ in range(3):
        u = step(u)
    assert torch.allclose(evolve(pack2(u0)), u, atol=1e-12, rtol=0)


@pytest.mark.parametrize("method,tol", [("svd", 1e-10), ("gram", 1e-6),
                                        ("gram_chain", 1e-10)])
def test_rounding_matches_oracle(method, tol):
    """matvec_padded + rounding of an applied chain whose masks are
    scattered (state ranks below rmax near the ends) against the exact
    rounding of the unpadded TT (ttnx.tt_round). ttnx's own 'svd' sweep
    misses it by about 1e-2 on this input (its masked QR drops weight)."""
    d, rmax = 6, 4
    rng = np.random.default_rng(1)
    ranks = (1, 2, 4, 4, 4, 2, 1)
    cores = [rng.standard_normal((ranks[k], 2, ranks[k + 1]))
             for k in range(d)]
    A_j, _ = _laplacian(ttnx, d)
    A_t, _ = _laplacian(tx, d)
    x_j = ttnx.TTVector([jnp.asarray(c) for c in cores])
    RA = max(A_j.ranks)
    big_j = j_rs.matvec_padded(ttnx.solvers.als_scan.pack_op(A_j, RA),
                               ttnx.solvers.als_scan.pack_tt(x_j, rmax))
    big = t_rs.matvec_padded(tx.pack_op(A_t, RA),
                             tx.pack_tt(ttvector_from_numpy(
                                 cores, device="cpu"), rmax))
    assert _rel(big.numpy(), np.asarray(big_j)) <= 1e-14
    masks_A = np.zeros((d + 1, RA))
    for i, r in enumerate(A_j.ranks):
        masks_A[i, :r] = 1.0
    mu = tx.rank_masks(ranks, rmax, device="cpu").numpy()
    masks_big = torch.as_tensor(np.stack(
        [np.outer(masks_A[i], mu[i]).reshape(-1) for i in range(d + 1)]))
    big_rks = [min(a * b, RA * rmax) for a, b in zip(A_j.ranks, ranks)]
    out_rks = t_rs.round_masks(big_rks, rmax, (2,) * d)
    assert out_rks == j_rs.round_masks(big_rks, rmax, (2,) * d)
    m_out = tx.rank_masks(out_rks, rmax, device="cpu")
    if method == "gram_chain":
        y = t_rs.tt_round_gram(big, rmax, m_out)
    else:
        y = t_rs.tt_round_scan(big, masks_big, rmax, m_out, method=method)
    oracle = ttnx.tt_round(A_j @ x_j, max_bond=rmax)
    assert _rel(t_dense(tx.unpack_tt(y, out_rks)).numpy(),
                np.asarray(j_dense(oracle))) <= tol


def test_als_linsolve_scan_matches_ttnx():
    d = 6
    rng = np.random.default_rng(2)
    ranks = (1, 2, 3, 3, 3, 2, 1)
    x0 = [rng.standard_normal((ranks[k], 2, ranks[k + 1])) for k in range(d)]
    A_j = ttnx.id_tto(d) + 0.1 * ttnx.toeplitz_to_qtto(2.0, -1.0, -1.0, d)
    A_t = tx.id_tto(d, device="cpu") + 0.1 * tx.toeplitz_to_qtto(
        2.0, -1.0, -1.0, d, device="cpu")
    ref = j_linsolve(A_j, ttnx.qtt_sin(d), ttnx.TTVector(
        [jnp.asarray(c) for c in x0]), sweep_count=4)
    got = tx.als_linsolve_scan(A_t, tx.qtt_sin(d, device="cpu"),
                               ttvector_from_numpy(x0, device="cpu"),
                               sweep_count=4)
    assert _rel(t_dense(got).numpy(), np.asarray(j_dense(ref))) <= TOL


def test_entry_runs_on_cpu():
    """The flagship entry point (d=12, rank 16, f32) takes one finite
    step on the CPU through the plain versions."""
    from ttnx_torch.entry import entry

    fn, (u,) = entry(torch.device("cpu"))
    out = fn(u)
    assert out.shape == (12, 16, 2, 16) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())


def test_matmul_precision_restores_flags():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with t_rs.matmul_precision("highest"):
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
