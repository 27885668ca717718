"""The batched ALS's gauge QR (``ttnx_torch.kernels.qr_batched``).

CPU tests: the wrapper's CPU route is ``torch.linalg.qr`` in the two
layouts, bit for bit, and launches nothing; ``rows=True`` gives the
transposed factors of the transposed stack; stacks with the zero rows and
columns that ``rank_masks`` leaves at the ends of a chain, and a rank
deficient stack, are factored (``Q R = V``, orthonormal live columns); the
gradient gate; the shapes and dtypes the kernel refuses. The kernel's own
arithmetic runs on the CPU in ``test_torch_qr_emulated.py``.

Card tests (marked ``cuda``, skipped without a card; this file imports no
jax): the kernel against ``torch.linalg.qr`` on the card at the batched
ALS's shapes ``(512, 128, 64)`` and ``(512, 64, 32)``, both layouts, f32
and f64, on masked well-conditioned stacks. Tolerances, relative to the
largest entry: factors 1e-4 in f32 (two Householder orders of f32 FMAs on
matrices of condition about 10) and 1e-10 in f64; ``||QR - V|| / ||V||``
and ``max |Q^T Q - I|`` on live columns 1e-5 in f32 (a few ulps times
sqrt(m)) and 1e-12 in f64. And ``als_sweeps_b`` at B = 512 on the bench's
heat operator: the represented vectors with the kernel's gauge agree with
those of the ``torch.linalg.qr`` gauge to 1e-5 (f32), and one call
launches the kernel 22 times (2 (d - 1) sites).
"""

import numpy as np
import pytest
import torch

from ttnx_torch.entry import batched_als_problem, flat_spectrum_stack
from ttnx_torch.kernels import dispatch
from ttnx_torch.kernels.qr_batched import (MAX_ROWS, kernel_shape,
                                           qr_batched, qr_batched_plain)
from ttnx_torch.solvers import als_scan_batched
from ttnx_torch.solvers.als_scan import rank_masks

from kernel_launches import launches

DTYPES = [torch.float32, torch.float64]
N = 2


def _masked(rng, B, R, m_l, m_r, rows, boost=0.0):
    """``B`` local solutions ``(B, R, n, R)`` with a Gaussian live block,
    zero where the rank masks ``m_l``/``m_r`` are (as the ALS leaves them),
    as the QR's input: ``(B, R n, R)`` or, with ``rows``, ``(B, R, n R)``.
    ``boost`` adds that multiple of the identity to the live block of the
    matrix factored, to bound its condition number."""
    R_ = len(m_l)
    V = rng.standard_normal((B, R_, N, R_))
    V = V * (m_l[:, None, None] * m_r[None, None, :])
    M = V.reshape(B, R_, N * R_).transpose(0, 2, 1) if rows else \
        V.reshape(B, R_ * N, R_)
    live_rows, live_cols = (np.flatnonzero(np.tile(m_r, N)),
                            np.flatnonzero(m_l)) if rows else (
        np.flatnonzero(m_l.repeat(N)), np.flatnonzero(m_r))
    for i, c in zip(live_rows, live_cols):
        M[:, i, c] += boost
    return np.ascontiguousarray(M.transpose(0, 2, 1) if rows else M)


def _chain_sites(d, R):
    """(m_l, m_r, rows) of every site of a forward and a backward half
    sweep of a chain of full feasible ranks padded to R."""
    rks = [min(N ** k, N ** (d - k), R) for k in range(d + 1)]
    masks = rank_masks(rks, R, device="cpu").numpy()
    fwd = [(masks[k], masks[k + 1], False) for k in range(d - 1)]
    bwd = [(masks[k], masks[k + 1], True) for k in range(d - 1, 0, -1)]
    return fwd + bwd


def _factors_hold(V, q, r, rows, live_cols, tol):
    """Q R = V and the live columns of Q orthonormal, in float64."""
    V, q, r = (torch.as_tensor(a).double().cpu() for a in (V, q, r))
    if rows:
        V, q, r = V.transpose(1, 2), q.transpose(1, 2), r.transpose(1, 2)
    res = torch.linalg.norm(q @ r - V) / torch.linalg.norm(V)
    assert float(res) <= tol, float(res)
    assert bool((r.tril(-1) == 0).all())
    ql = q[:, :, live_cols]
    eye = torch.eye(ql.shape[2], dtype=torch.float64)
    orth = float((ql.transpose(1, 2) @ ql - eye).abs().max())
    assert orth <= tol, orth


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [False, True], ids=["cols", "rows"])
def test_cpu_route_is_torch_qr_bit_for_bit(dtype, rows):
    rng = np.random.default_rng(3)
    V = torch.as_tensor(rng.standard_normal((5, 12, 24) if rows
                                            else (5, 24, 12)), dtype=dtype)
    dispatch.reset_launch_counts()
    q, r = qr_batched(V, rows=rows)
    assert dispatch.route_counts()["qr_batched"] == {}
    if rows:
        q0, r0 = torch.linalg.qr(V.transpose(1, 2))
        q0, r0 = q0.transpose(1, 2), r0.transpose(1, 2)
    else:
        q0, r0 = torch.linalg.qr(V)
    assert torch.equal(q, q0) and torch.equal(r, r0)
    assert q.shape == V.shape and r.shape == (5, 12, 12)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rows_layout_transposes_the_factors(dtype):
    rng = np.random.default_rng(4)
    V = torch.as_tensor(rng.standard_normal((3, 8, 16)), dtype=dtype)
    qt, rt = qr_batched_plain(V, rows=True)
    q, r = qr_batched_plain(V.transpose(1, 2).contiguous())
    assert torch.equal(qt, q.transpose(1, 2))
    assert torch.equal(rt, r.transpose(1, 2))
    # Q^T and R^T rebuild the stack as it is laid out: R^T Q^T = V
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((rt @ qt - V).abs().max()) <= tol


def test_masked_chain_ends_and_rank_deficient_stacks():
    """Every site of a d = 6 chain padded to R = 8 (live blocks 2 x 2 up
    to 16 x 8, zero rows and columns around them) and a stack whose live
    block has rank 3 of 8: Q R = V and the live columns of Q orthonormal,
    in both layouts, through the CPU route."""
    rng = np.random.default_rng(5)
    for m_l, m_r, rows in _chain_sites(6, 8):
        V = torch.as_tensor(_masked(rng, 4, 8, m_l, m_r, rows))
        q, r = qr_batched(V, rows=rows)
        live = np.flatnonzero(m_l if rows else m_r)
        _factors_hold(V, q, r, rows, live, 1e-12)
    low = rng.standard_normal((4, 16, 3)) @ rng.standard_normal((4, 3, 8))
    q, r = qr_batched(torch.as_tensor(low))
    _factors_hold(low, q, r, False, np.arange(8), 1e-12)
    assert float(r.diagonal(dim1=1, dim2=2)[:, 3:].abs().max()) <= 1e-12


def test_refuses_gradients():
    V = torch.randn(2, 8, 4, dtype=torch.float64, requires_grad=True)
    with pytest.raises(RuntimeError, match="qr_batched: the kernel has no "
                                           "backward"):
        qr_batched(V)
    with torch.no_grad():
        q, r = qr_batched(V)
    assert not q.requires_grad and not r.requires_grad


@pytest.mark.parametrize("shape,rows,dtype,error", [
    ((4, 129, 64), False, torch.float32, ValueError),   # m > 128
    ((4, 64, 129), True, torch.float32, ValueError),
    ((4, 32, 64), False, torch.float32, ValueError),    # k > m
    ((4, 64, 32), True, torch.float64, ValueError),
    ((0, 64, 32), False, torch.float32, ValueError),    # no matrix
    ((64, 32), False, torch.float32, ValueError),       # not a stack
    ((4, 64, 32), False, torch.complex64, TypeError),
    ((4, 64, 32), False, torch.bfloat16, TypeError),
], ids=["m>128", "m>128-rows", "k>m", "k>m-rows", "empty", "2-D",
        "complex", "bf16"])
def test_kernel_refuses_shapes_and_dtypes(shape, rows, dtype, error):
    with pytest.raises(error, match="qr_batched"):
        kernel_shape(torch.zeros(shape, dtype=dtype), rows)


def test_kernel_takes_the_batched_als_shapes():
    for R in (16, 32, 64):
        assert kernel_shape(torch.zeros(3, N * R, R)) == (3, N * R, R)
        assert kernel_shape(torch.zeros(3, R, N * R), True) == (3, N * R, R)
    assert kernel_shape(torch.zeros(1, MAX_ROWS, MAX_ROWS,
                                    dtype=torch.float64)) == (1, 128, 128)


# ---------------------------------------------------------------------------
# Card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, ref, tol):
    err = float((got - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [False, True], ids=["cols", "rows"])
@pytest.mark.parametrize("R", [64, 32])
def test_kernel_against_torch_qr_on_card(cuda, dtype, rows, R):
    """512 matrices at the batched ALS's shape: a third full, a third
    masked like the first forward (or last backward) site of a d = 12
    chain, a third like a middle site with 3 dead rows and columns; the
    live blocks are Gaussian plus 3 I (condition about 10)."""
    rng = np.random.default_rng(R + rows)
    full = np.ones(R)
    cut = np.r_[np.ones(R - 3), np.zeros(3)]
    end = np.r_[np.ones(2), np.zeros(R - 2)]
    one = np.r_[np.ones(1), np.zeros(R - 1)]
    edge = (end, one) if rows else (one, end)
    parts = [_masked(rng, 171, R, full, full, rows, 3.0),
             _masked(rng, 171, R, *edge, rows, 3.0),
             _masked(rng, 170, R, cut, cut, rows, 3.0)]
    V = torch.as_tensor(np.concatenate(parts), dtype=dtype, device=cuda)
    with launches(qr_batched) as added:
        q, r = qr_batched(V, rows=rows)
    torch.cuda.synchronize()
    assert added == {"kernel": 1}
    q0, r0 = qr_batched_plain(V, rows=rows)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    _close(q, q0, tol)
    _close(r, r0, tol)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for sl, (m_l, m_r) in zip((slice(0, 171), slice(171, 342),
                               slice(342, 512)),
                              ((full, full), edge, (cut, cut))):
        live = np.flatnonzero(m_l if rows else m_r)
        _factors_hold(V[sl], q[sl], r[sl], rows, live, tol)


def _dense(x):
    """The represented vectors ``(B, n^d)`` of a padded stack ``(B, d, R,
    n, R)`` (left and right boundary index 0), in float64."""
    x = x.double()
    B, d, R = x.shape[:3]
    v = x[:, 0, 0]
    for k in range(1, d):
        v = torch.einsum("bNr,brns->bNns", v, x[:, k]).reshape(B, -1, R)
    return v[..., 0]


@pytest.mark.cuda
@pytest.mark.parametrize("data", ["bench", "distinct"])
def test_als_sweeps_b_gauge_on_card(cuda, data, monkeypatch):
    """``als_sweeps_b`` (B = 512, d = 12, rank 64, f32, 16 warm CG
    iterations, ``cg_fused``) on the bench's heat operator, with the
    kernel's gauge and with ``torch.linalg.qr``'s: the bench's broadcast
    three-mode state, and 512 distinct flat-spectrum states."""
    p = batched_als_problem(cuda, batch=512)
    A, bb, xb, masks = p["lhs_stack"], p["b_batch"], p["x_batch"], p["masks"]
    if data == "distinct":
        rng = np.random.default_rng(23)
        bb = np.stack([flat_spectrum_stack(rng, p["u_rks"], 64)
                       for _ in range(512)])
        xb = bb + 0.3 * np.stack([flat_spectrum_stack(rng, p["u_rks"], 64)
                                  for _ in range(512)])
        bb, xb = (torch.as_tensor(a, dtype=torch.float32, device=cuda)
                  for a in (bb, xb))

    def run():
        return als_scan_batched.als_sweeps_b(A, bb, xb, masks, 2,
                                             cg_iters=16, solver="cg_fused")

    dispatch.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert dispatch.route_counts()["qr_batched"] == {"kernel": 22}
    monkeypatch.setattr(als_scan_batched, "qr_batched", qr_batched_plain)
    ref = run()
    torch.cuda.synchronize()
    assert dispatch.route_counts()["qr_batched"] == {"kernel": 22}
    g, r = _dense(got), _dense(ref)
    rel = torch.linalg.norm(g - r, dim=1) / torch.linalg.norm(r, dim=1)
    assert float(rel.max()) <= 1e-5, float(rel.max())
