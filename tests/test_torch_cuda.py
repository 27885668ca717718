"""The Hopper kernels B1-B13 against their plain versions on a CUDA card.

Every test here needs a card and skips without one. This file imports no
jax, so on a machine with a card and no jax it runs without the suite's
conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Shapes are deliberately ragged (not multiples of the 64-wide GEMM tiles)
so the edge masking of every kernel is exercised, and the batched kernels
get distinct problems per batch element. Tolerances: 1e-10 in float64;
1e-5 in float32 for B1/B2/B6/B8/B13 and 1e-4 for B3/B4/B5/B7/B9/B10/B11/
B12 (CG, BiCGStab and Lanczos amplify the rounding of f32 products, and
the chains repeat it); relative to the largest entry. bf16 chains: one
bf16 ulp (2^-8) for each rounding of the chain, where f32 sums taken in
another order cross a rounding boundary. B11 and B13 are held on every
kernel route their wrappers choose by shape (each launch filed under
its route in ``dispatch.route_counts()``): B11 ``wgmma``
(r <= 64) and ``wmma`` (r = 80), B13 ``mma`` (16-byte rows and ragged
ones) and ``wmma`` (the largest shape); B11 also at the bench's 2048
iterations on the norm-keeping input (rel Frobenius 1e-3, norm within 1 %).
B12 likewise: ``wgmma`` (k <= 128, ragged) and ``wmma`` (k = 160), and
at the bench's 1024 iterations on its norm-keeping input. B10 on both of
its routes: ``cluster`` (f32, M <= 668, two launches bit-identical) and
``l2`` (f64, M = 669 and 999). B3 and B9 likewise: ``cluster`` (f32,
B3 at M <= 672 on 8 CTAs, B9 at M <= 1024 on 16 with rows streamed from
L2; two launches bit-identical; B9's breakdown) and ``l2`` (f64, B3 at M
= 673, B9 at M = 1100). B7 is held on both of its routes:
``site`` (f32 at R = 64 and 32, with and without the polish stage) and
``folded`` (f64, the ragged R = 40 stack and the bf16 refine stage). B4
on ``cluster`` and B5 on ``resident`` (f32 at R = 64 and 32, warm and
cold, a rank mask and a scattered one; B4's cluster also against B5 on the
same problem, two launches bit-identical), both on ``streamed`` (f64, R =
20 and 40).
B1 on both of its routes: ``grid`` (f32 at RB = 64, 128, 256, one
cooperative launch; two launches bit-identical) and ``staged`` (f64 at
those RB, f32 at RB = 96 and the ragged shapes). B8 likewise: ``cluster``
(f32 at R = 64, 32, 16 with RA = 5; two launches bit-identical) and
``staged`` (f64, RA = 4). The ALS eigensolve's two env stacks a sweep go
through B8: route ``cluster`` on the XXX chain in f32 at d = 12, R = 32
(energy within 1e-5 of the dense ground energy), ``staged`` on the
Laplacian (RA = 3) and in f64 (energies within 1e-4, f32, and 1e-10, f64,
of the largest of the same solve on the CPU in f64). One MALS sweep on the card
gives the CPU's realized ranks and state (1e-10, f64). The eager tier runs
no kernel: ``thin_svd`` keeps f32 singular vectors orthonormal to 5e-6,
an eager ALS solve and ``expm_multiply`` on the card give the CPU's
results (1e-10, f64), and the port's LOBPCG finds a seeded top eigenpair
at M = 4096 in f32 (1e-5). The cross runs no kernel either: the batched
device maxvol gives the CPU's rows exactly, and a checkpoint round trip on
the card keeps the bits. The distributed layer's collectives run on CUDA
tensors in two gloo ranks on the card (the ``gloo-cuda`` route), exactly.
"""

import numpy as np
import pytest
import torch

from ttnx_torch.core.decomp import ttv_to_tensor
from ttnx_torch.entry import (als_eig_problem, batched_als_problem,
                              dense_xxx_groundstate, flat_spectrum_stack,
                              mals_problem, norm_keeping_contraction_problem,
                              norm_keeping_matmul_problem)
from ttnx_torch.kernels import dispatch
from ttnx_torch.kernels.contraction import (chain_route, matmul_chain,
                                            matmul_chain_plain,
                                            matmul_chain_route, merge_route,
                                            merge_resplit_chain,
                                            merge_resplit_chain_plain,
                                            two_site_merge,
                                            two_site_merge_plain)
from ttnx_torch.kernels.als_sweep_fused import (als_fwd_bwd_fused_batched,
                                                als_fwd_bwd_plain,
                                                sweep_route)
from ttnx_torch.kernels.env_chain import (env_A_route, env_chain_A_fused,
                                          env_chain_A_plain,
                                          env_chain_batched_plain,
                                          env_chain_fused_batched,
                                          left_env_chain_fused,
                                          left_env_chain_plain,
                                          right_env_chain_fused,
                                          right_env_chain_plain)
from ttnx_torch.kernels.gram import (GRID_RANKS, gram_chain_fused,
                                     gram_chain_plain, gram_route)
from ttnx_torch.kernels.lanczos import (lanczos_fused, lanczos_plain,
                                        lanczos_route)
from ttnx_torch.kernels.local_cg import (bicgstab_route,
                                         bicgstab_solve_fused,
                                         bicgstab_solve_plain, cg_route,
                                         cg_solve_fused, cg_solve_plain)
from ttnx_torch.kernels.local_cg_mf import (cg_matfree_batched_plain,
                                            cg_matfree_fused,
                                            cg_matfree_fused_batched,
                                            cg_matfree_plain, matfree_route)
from ttnx_torch.ops.operators import laplacian
from ttnx_torch.solvers import als_scan
from ttnx_torch.solvers.als_scan import rank_masks
from ttnx_torch.solvers.mals_scan import mals_linsolve_scan

from kernel_launches import launches

DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, ref, tol):
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        err = float((g - r).abs().max())
        assert err <= tol * float(r.abs().max()), err


def _tol(dtype, loose=False):
    if dtype == torch.float64:
        return 1e-10
    return 1e-4 if loose else 1e-5


def _on(dev, dtype, *arrays):
    return [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays]


def _local(rng, R, RA, n=2):
    def env():
        e = np.zeros((R, RA, R))
        for w in range(RA):
            g = rng.standard_normal((R, R)) / np.sqrt(R)
            e[:, w] = g @ g.T + (np.eye(R) if w == 0 else 0.0)
        return e

    Ac = np.zeros((RA, n, n, RA))
    Ac[0, :, :, 0] = np.eye(n)
    for w in range(1, RA):
        s = rng.standard_normal((n, n)) * 0.1
        Ac[w, :, :, w] = s @ s.T
    mask = np.ones((R, n, R))
    mask[R - 3:] = 0.0
    mask[:, :, R - 2:] = 0.0
    rhs = rng.standard_normal((R, n, R)) * mask
    x0 = rng.standard_normal((R, n, R))
    return env(), Ac, env(), rhs, mask, x0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,R", [(5, 20), (4, 70)])
def test_gram_chain_kernel(cuda, dtype, d, R):
    y = np.random.default_rng(R).standard_normal((d, R, 2, R)) / np.sqrt(R)
    (yt,) = _on(cuda, dtype, y)
    with launches(gram_chain_fused) as added:
        got = gram_chain_fused(yt)
    torch.cuda.synchronize()
    assert added == {gram_route(dtype, d, R, 2): 1}
    _close(got, gram_chain_plain(yt), _tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("R", GRID_RANKS)
def test_gram_chain_grid_route(cuda, R):
    """B1 in f32 at the heat CN step's RB, d = 12: one launch on route
    grid, within 1e-5 of plain, two launches bit-identical."""
    y = np.random.default_rng(R).standard_normal((12, R, 2, R)) / np.sqrt(
        2 * R)
    y[:, R - 7:] = 0.0
    (yt,) = _on(cuda, torch.float32, y)
    with launches(gram_chain_fused) as added:
        got, again = gram_chain_fused(yt), gram_chain_fused(yt)
    torch.cuda.synchronize()
    assert added == {"grid": 2}
    assert torch.equal(got, again)
    _close(got, gram_chain_plain(yt), 1e-5)


@pytest.mark.cuda
def test_gram_chain_grid_refuses_unaligned_view(cuda):
    """Route grid reads y in 16-byte copies: a contiguous view one float
    off an aligned base is refused with a ValueError, not launched."""
    R = GRID_RANKS[0]
    flat = torch.zeros(4 * R * 2 * R + 1, dtype=torch.float32, device=cuda)
    y = flat[1:].view(4, R, 2, R)
    assert y.is_contiguous() and y.data_ptr() % 16
    with launches(gram_chain_fused) as added, pytest.raises(
            ValueError, match="16-byte"):
        gram_chain_fused(y)
    assert added == {}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,R", [(torch.float64, 64),
                                     (torch.float64, 256),
                                     (torch.float32, 96)])
def test_gram_chain_staged_outside_the_grid_shapes(cuda, dtype, R):
    """f64 at the grid route's RB and f32 at the convection step's RB =
    96 stay on route staged."""
    y = np.random.default_rng(R + 1).standard_normal((6, R, 2, R)) / np.sqrt(
        2 * R)
    (yt,) = _on(cuda, dtype, y)
    with launches(gram_chain_fused) as added:
        got = gram_chain_fused(yt)
    torch.cuda.synchronize()
    assert added == {"staged": 1}
    _close(got, gram_chain_plain(yt), _tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
def test_env_chain_kernel(cuda, dtype, left):
    rng = np.random.default_rng(3)
    d, R, RA, Rb = 4, 20, 3, 12
    x = rng.standard_normal((d, R, 2, R)) / np.sqrt(R)
    A = rng.standard_normal((d, RA, 2, 2, RA)) / RA
    b = rng.standard_normal((d, Rb, 2, Rb)) / np.sqrt(Rb)
    args = _on(cuda, dtype, x, A, b)
    kernel = left_env_chain_fused if left else right_env_chain_fused
    plain = left_env_chain_plain if left else right_env_chain_plain
    got = kernel(*args)
    torch.cuda.synchronize()
    _close(got, plain(*args), _tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_cg_solve_kernel(cuda, dtype, warm):
    rng = np.random.default_rng(5)
    M = 300
    g = rng.standard_normal((M, M)) / np.sqrt(M)
    K, rhs, x0 = _on(cuda, dtype, g @ g.T + np.eye(M),
                     rng.standard_normal(M), rng.standard_normal(M))
    kw = dict(x0=x0 if warm else None, iters=12)
    with launches(cg_solve_fused) as added:
        got = cg_solve_fused(K, rhs, **kw)
    torch.cuda.synchronize()
    assert added == {cg_route(dtype, M): 1}
    _close(got, cg_solve_plain(K, rhs, **kw), _tol(dtype, loose=True))


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("dtype,M,route", [
    (torch.float32, 5, "cluster"), (torch.float32, 37, "cluster"),
    (torch.float32, 509, "cluster"), (torch.float32, 512, "cluster"),
    (torch.float32, 672, "cluster"), (torch.float32, 673, "l2"),
    (torch.float64, 512, "l2")])
def test_cg_solve_kernel_routes(cuda, dtype, M, route, warm):
    """B3 on each route, at its edges (a CTA of the cluster owning no row
    at M = 5, M neither a multiple of 4 nor of 8, the largest cluster M
    and one past it), against the plain version, and deterministic: two
    launches give the same bits."""
    rng = np.random.default_rng(M + 2)
    g = rng.standard_normal((M, M)) / np.sqrt(M)
    K, rhs, x0 = _on(cuda, dtype, g @ g.T + np.eye(M),
                     rng.standard_normal(M), rng.standard_normal(M))
    kw = dict(x0=x0 if warm else None, iters=3 if M < 8 else 16)
    assert cg_route(dtype, M) == route
    with launches(cg_solve_fused) as added:
        got = cg_solve_fused(K, rhs, **kw)
        again = cg_solve_fused(K, rhs, **kw)
    torch.cuda.synchronize()
    assert added == {route: 2}
    assert torch.equal(got, again)
    _close(got, cg_solve_plain(K, rhs, **kw), _tol(dtype, loose=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("R,RA", [(20, 3), (40, 4)])
def test_cg_matfree_kernel(cuda, dtype, warm, R, RA):
    L, Ac, Renv, rhs, mask, x0 = _on(cuda, dtype, *_local(
        np.random.default_rng(R), R, RA))
    kw = dict(x0=x0 if warm else None, iters=10)
    with launches(cg_matfree_fused) as added:
        got = cg_matfree_fused(L, Ac, Renv, rhs, mask, **kw)
    torch.cuda.synchronize()
    assert added == {"streamed": 1}
    _close(got, cg_matfree_plain(L, Ac, Renv, rhs, mask, **kw),
           _tol(dtype, loose=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_cg_matfree_batched_kernel(cuda, dtype, warm):
    rng = np.random.default_rng(11)
    B, R, RA = 3, 40, 4
    local = [_local(rng, R, RA) for _ in range(B)]
    L, Renv, rhs, x0 = (np.stack([p[k] for p in local]) for k in (0, 2, 3, 5))
    L_, Ac, Renv_, rhs_, mask, x0_ = _on(cuda, dtype, L, local[0][1], Renv,
                                         rhs, local[0][4], x0)
    kw = dict(x0=x0_ if warm else None, iters=10)
    with launches(cg_matfree_fused_batched) as added:
        got = cg_matfree_fused_batched(L_, Ac, Renv_, rhs_, mask, **kw)
    torch.cuda.synchronize()
    assert added == {"streamed": 1}
    _close(got, cg_matfree_batched_plain(L_, Ac, Renv_, rhs_, mask, **kw),
           _tol(dtype, loose=True))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [64, 32])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("scattered", [False, True],
                         ids=["rank-mask", "scattered-mask"])
def test_cg_matfree_resident_route(cuda, R, B, warm, scattered):
    """B4 (B = 1, route cluster) and B5 (B = 3, route resident) in f32 at
    (R, 2, 4) against their plain versions, with the solvers' kind of mask
    and with a scattered 0/1 mask that is no outer product."""
    rng = np.random.default_rng(R + B)
    local = [_local(rng, R, 4) for _ in range(B)]
    mask = local[0][4]
    if scattered:
        mask = (rng.random(mask.shape) < 0.8).astype(float)
    L, Renv, rhs, x0 = (np.stack([p[k] for p in local]) for k in (0, 2, 3, 5))
    L, Ac, Renv, rhs, mask, x0 = _on(cuda, torch.float32, L, local[0][1],
                                     Renv, rhs, mask, x0)
    route = "cluster" if B == 1 else "resident"
    assert matfree_route(torch.float32, R, 2, 4, batched=B > 1) == route
    kw = dict(x0=x0 if warm else None, iters=16)
    if B == 1:
        kw["x0"] = None if kw["x0"] is None else kw["x0"][0]
        wrapper, plain, args = cg_matfree_fused, cg_matfree_plain, (
            L[0], Ac, Renv[0], rhs[0], mask)
    else:
        wrapper, plain, args = (cg_matfree_fused_batched,
                                cg_matfree_batched_plain,
                                (L, Ac, Renv, rhs, mask))
    with launches(wrapper) as added:
        got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert added == {route: 1}
    _close(got, plain(*args, **kw), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [64, 32])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("scattered", [False, True],
                         ids=["rank-mask", "scattered-mask"])
def test_cg_matfree_cluster_route(cuda, R, warm, scattered):
    """B4 on route cluster in f32 at (R, 2, 4): one launch filed under
    ``cluster`` in ``route_counts()``, within 1e-4 of its plain version and
    of B5 (route resident) on the same problem as a batch of one, two
    launches bit-identical."""
    rng = np.random.default_rng(3 * R + 2 * warm + scattered)
    L, Ac, Renv, rhs, mask, x0 = _local(rng, R, 4)
    if scattered:
        mask = (rng.random(mask.shape) < 0.8).astype(float)
    L, Ac, Renv, rhs, mask, x0 = _on(cuda, torch.float32, L, Ac, Renv, rhs,
                                     mask, x0)
    kw = dict(x0=x0 if warm else None, iters=16)
    dispatch.reset_launch_counts()
    got = cg_matfree_fused(L, Ac, Renv, rhs, mask, **kw)
    again = cg_matfree_fused(L, Ac, Renv, rhs, mask, **kw)
    torch.cuda.synchronize()
    assert dispatch.launch_counts()["cg_matfree_fused"] == 2
    assert dispatch.route_counts()["cg_matfree_fused"] == {"cluster": 2}
    assert torch.equal(got, again)
    _close(got, cg_matfree_plain(L, Ac, Renv, rhs, mask, **kw), 1e-4)
    one = cg_matfree_fused_batched(
        L[None], Ac, Renv[None], rhs[None], mask,
        x0=x0[None] if warm else None, iters=16)
    torch.cuda.synchronize()
    assert dispatch.route_counts()["cg_matfree_fused_batched"] == {
        "resident": 1}
    _close(got, one[0], 1e-4)


@pytest.mark.cuda
def test_cg_matfree_f64_at_resident_shape_streams(cuda):
    """f64 at the resident kernel's shape keeps PR 1's kernel."""
    rng = np.random.default_rng(23)
    local = [_local(rng, 64, 4) for _ in range(2)]
    L, Renv, rhs, x0 = (np.stack([p[k] for p in local]) for k in (0, 2, 3, 5))
    args = _on(cuda, torch.float64, L, local[0][1], Renv, rhs, local[0][4])
    kw = dict(x0=_on(cuda, torch.float64, x0)[0], iters=10)
    with launches(cg_matfree_fused_batched) as added:
        got = cg_matfree_fused_batched(*args, **kw)
    torch.cuda.synchronize()
    assert added == {"streamed": 1}
    _close(got, cg_matfree_batched_plain(*args, **kw), 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
@pytest.mark.parametrize("raw", [False, True], ids=["public", "raw"])
def test_env_chain_batched_kernel(cuda, dtype, left, raw):
    rng = np.random.default_rng(13)
    B, d, R, RA, Rb = 3, 4, 20, 3, 12
    x = rng.standard_normal((B, d, R, 2, R)) / np.sqrt(R)
    A = rng.standard_normal((d, RA, 2, 2, RA)) / RA
    b = rng.standard_normal((B, d, Rb, 2, Rb)) / np.sqrt(Rb)
    args = _on(cuda, dtype, x, A, b)
    got = env_chain_fused_batched(*args, left=left, raw=raw)
    torch.cuda.synchronize()
    _close(got, env_chain_batched_plain(*args, left=left, raw=raw),
           _tol(dtype))


def _site_problem(B, d, R, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, d, R, 2, R)) / np.sqrt(2 * R)
    A = rng.standard_normal((d, 4, 2, 2, 4)) / 4
    b = rng.standard_normal((B, d, R, 2, R)) / np.sqrt(2 * R)
    return x, A, b


@pytest.mark.cuda
@pytest.mark.parametrize("R", [16, 32, 64])
@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
def test_env_chain_cluster_route(cuda, R, left):
    """B2 in f32 at (R, 2, 4), Rb = R: one launch on route cluster,
    within 1e-4 of plain, two launches bit-identical."""
    x, A, b = _site_problem(1, 5, R, R + left)
    args = _on(cuda, torch.float32, x[0], A, b[0])
    kernel = left_env_chain_fused if left else right_env_chain_fused
    plain = left_env_chain_plain if left else right_env_chain_plain
    with launches(kernel) as added:
        got, again = kernel(*args), kernel(*args)
    torch.cuda.synchronize()
    assert added == {"cluster": 2}
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    _close(got, plain(*args), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [64, 32])
@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
@pytest.mark.parametrize("raw", [False, True], ids=["public", "raw"])
@pytest.mark.parametrize("shared_b", [False, True], ids=["b", "b_bcast"])
def test_env_chain_resident_route(cuda, R, left, raw, shared_b):
    """B6 in f32 at (R, 2, 4), Rb = R, B = 3: route resident, within 1e-4
    of plain in either layout, with distinct right-hand sides or one
    broadcast over the batch (read in place)."""
    x, A, b = _site_problem(3, 4, R, 2 * R + left)
    xt, At, bt = _on(cuda, torch.float32, x, A, b)
    if shared_b:
        bt = bt[:1].expand_as(bt)
    with launches(env_chain_fused_batched) as added:
        got = env_chain_fused_batched(xt, At, bt, left=left, raw=raw)
    torch.cuda.synchronize()
    assert added == {"resident": 1}
    _close(got, env_chain_batched_plain(xt, At, bt, left=left, raw=raw),
           1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["B2", "B6"])
def test_env_chain_f64_at_site_shapes_stays_staged(cuda, batched):
    x, A, b = _site_problem(2, 3, 32, 9)
    xt, At, bt = _on(cuda, torch.float64, x, A, b)
    if batched:
        kernel, args = env_chain_fused_batched, (xt, At, bt)
        ref = env_chain_batched_plain(*args)
    else:
        kernel, args = right_env_chain_fused, (xt[0], At, bt[0])
        ref = right_env_chain_plain(*args)
    with launches(kernel) as added:
        got = kernel(*args)
    torch.cuda.synchronize()
    assert added == {"staged": 1}
    _close(got, ref, 1e-10)


@pytest.mark.cuda
def test_env_site_layout_matches_the_library(cuda):
    from ttnx_torch.kernels import _build
    from ttnx_torch.kernels.env_chain import site_layout

    for R, S in ((64, 8), (64, 4), (32, 16), (32, 4), (16, 4)):
        assert _build.query("env_site_smem", R, S, 4, 1) == site_layout(
            R, S)["bytes"]
    for R in (64, 32, 16):  # B8: RA = 5, no rhs
        assert _build.query("env_site_smem", R, 4, 5, 0) == site_layout(
            R, 4, 5, False)["bytes"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kw", [
    (torch.float32, {}), (torch.float64, {}),
    (torch.float32, dict(cg_refine=2, cg_polish=2))],
    ids=["f32", "f64", "f32-refine"])
def test_sweep_pair_kernel(cuda, dtype, kw):
    """Distinct flat-spectrum problems (a well-conditioned gauge) in a
    ragged R = 40 stack of ranks up to 32."""
    d, rmax, R, B = 6, 32, 40, 3
    p = batched_als_problem(torch.device("cpu"), batch=1, rmax=rmax, d=d,
                            dtype=torch.float64)
    rks = p["u_rks"]
    rng = np.random.default_rng(17)
    bb = np.stack([flat_spectrum_stack(rng, rks, R) for _ in range(B)])
    xb = bb + 0.3 * np.stack([flat_spectrum_stack(rng, rks, R)
                              for _ in range(B)])
    A = p["lhs_stack"].numpy()
    masks = rank_masks(rks, R, device="cpu").numpy()
    args = _on(cuda, dtype, A, bb, xb, masks)
    kw = dict(kw, cg_iters=12, ns_iters=(16, 6))
    with launches(als_fwd_bwd_fused_batched) as added:
        got = als_fwd_bwd_fused_batched(*args, **kw)
    torch.cuda.synchronize()
    assert added == {"folded": 1}
    _close(got, als_fwd_bwd_plain(*args, **kw), _tol(dtype, loose=True))


def _flat_sweep(dev, dtype, R, B=3, d=12, seed=19):
    """B distinct flat-spectrum problems of the bench's heat operator at
    full rank R (d = 12 reaches rank 64)."""
    p = batched_als_problem(torch.device("cpu"), batch=1, rmax=R, d=d,
                            dtype=torch.float64)
    rng = np.random.default_rng(seed)
    bb = np.stack([flat_spectrum_stack(rng, p["u_rks"], R) for _ in range(B)])
    xb = bb + 0.3 * np.stack([flat_spectrum_stack(rng, p["u_rks"], R)
                              for _ in range(B)])
    return _on(dev, dtype, p["lhs_stack"].numpy(), bb, xb,
               p["masks"].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("R", [64, 32])
@pytest.mark.parametrize("polish", [0, 2])
def test_sweep_pair_site_kernel(cuda, R, polish):
    """The site-resident route (f32, (R, n, RA) = (R, 2, 4), no refine)
    against the plain version at the bench's CG and gauge settings."""
    args = _flat_sweep(cuda, torch.float32, R)
    assert sweep_route(torch.float32, R, 2, 4, 0) == "site"
    with launches(als_fwd_bwd_fused_batched) as added:
        got = als_fwd_bwd_fused_batched(*args, cg_polish=polish)
    torch.cuda.synchronize()
    assert added == {"site": 1}
    _close(got, als_fwd_bwd_plain(*args, cg_polish=polish), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,R,kw", [
    (torch.float64, 64, {}), (torch.float32, 32, dict(cg_refine=2))],
    ids=["f64-r64", "f32-r32-refine"])
def test_sweep_pair_folded_route_at_site_shapes(cuda, dtype, R, kw):
    """At the site kernel's shapes, f64 and the bf16 refine stage keep PR
    2's folded kernel."""
    args = _flat_sweep(cuda, dtype, R, B=2)
    with launches(als_fwd_bwd_fused_batched) as added:
        got = als_fwd_bwd_fused_batched(*args, **kw)
    torch.cuda.synchronize()
    assert added == {"folded": 1}
    _close(got, als_fwd_bwd_plain(*args, **kw), _tol(dtype, loose=True))


@pytest.mark.cuda
@pytest.mark.parametrize("rmax", [8, 24])
def test_cn_step_kernels_match_plain_f64(cuda, rmax):
    """Two f64 CN steps through the kernels equal the plain versions'
    (B3 at rank 8, B4 at rank 24)."""
    import ttnx_torch.solvers.als_scan as als
    import ttnx_torch.solvers.round_scan as rs
    from ttnx_torch.core.decomp import ttv_to_tensor
    from ttnx_torch.ops.operators import toeplitz_to_qtto
    from ttnx_torch.ops.qtt import qtt_sin

    d = 8
    hg = 1.0 / (2 ** d + 1)
    A = (-1.0 / hg ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, d, device=cuda)
    step, pack, unpack = rs.make_cn_step(
        A, 1e-6, rmax=rmax, dims=(2,) * d,
        u_rks=(1,) + (rmax,) * (d - 1) + (1,), sweep_count=2,
        solver="cg_fused", round_method="gram_chain", cg_iters=16)
    u0 = pack(qtt_sin(d, a=hg, b=1 - hg, device=cuda))
    got = step(step(u0))
    plain = {"gram_chain_fused": gram_chain_plain,
             "right_env_chain_fused": right_env_chain_plain,
             "left_env_chain_fused": left_env_chain_plain,
             "cg_solve_fused": cg_solve_plain,
             "cg_matfree_fused": cg_matfree_plain}
    saved = {}
    try:
        for name, fn in plain.items():
            mod = rs if name == "gram_chain_fused" else als
            saved[name] = (mod, getattr(mod, name))
            setattr(mod, name, fn)
        ref = step(step(u0))
    finally:
        for name, (mod, fn) in saved.items():
            setattr(mod, name, fn)
    # represented vectors, not cores: QR/eigh signs may differ
    _close(ttv_to_tensor(unpack(got)), ttv_to_tensor(unpack(ref)), 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
@pytest.mark.parametrize("R", [16, 64])
def test_env_chain_A_kernel(cuda, dtype, left, R):
    """B8 on a masked state (the last three bonds of every core padded)."""
    rng = np.random.default_rng(R)
    d, RA = 5, 5
    x = rng.standard_normal((d, R, 2, R)) / np.sqrt(R)
    x[:, R - 3:] = 0.0
    x[..., R - 3:] = 0.0
    A = rng.standard_normal((d, RA, 2, 2, RA)) / RA
    xt, At = _on(cuda, dtype, x, A)
    with launches(env_chain_A_fused) as added:
        got = env_chain_A_fused(xt, At, left=left)
    torch.cuda.synchronize()
    assert added == {env_A_route(dtype, R, 2, RA): 1}
    assert got.shape == (d + 1, R, RA, R)
    _close(got, env_chain_A_plain(xt, At, left=left), _tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [64, 32, 16])
@pytest.mark.parametrize("left", [False, True], ids=["right", "left"])
def test_env_chain_A_cluster_route(cuda, R, left):
    """B8 in f32 at RA = 5, d = 12: route cluster, within 1e-5 of plain,
    two launches bit-identical."""
    rng = np.random.default_rng(3 * R + left)
    d, RA = 12, 5
    x = rng.standard_normal((d, R, 2, R)) / np.sqrt(2 * R)
    A = rng.standard_normal((d, RA, 2, 2, RA)) / RA
    xt, At = _on(cuda, torch.float32, x, A)
    with launches(env_chain_A_fused) as added:
        got = env_chain_A_fused(xt, At, left=left)
        again = env_chain_A_fused(xt, At, left=left)
    torch.cuda.synchronize()
    assert added == {"cluster": 2}
    assert torch.equal(got, again)
    _close(got, env_chain_A_plain(xt, At, left=left), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,RA", [(torch.float64, 5),
                                      (torch.float32, 4)])
def test_env_chain_A_staged_outside_the_cluster_shapes(cuda, dtype, RA):
    """f64 at the cluster route's shape and f32 at RA = 4 stay on route
    staged."""
    rng = np.random.default_rng(RA)
    d, R = 4, 32
    x = rng.standard_normal((d, R, 2, R)) / np.sqrt(2 * R)
    A = rng.standard_normal((d, RA, 2, 2, RA)) / RA
    xt, At = _on(cuda, dtype, x, A)
    with launches(env_chain_A_fused) as added:
        got = env_chain_A_fused(xt, At)
    torch.cuda.synchronize()
    assert added == {"staged": 1}
    _close(got, env_chain_A_plain(xt, At), _tol(dtype))


def _spread_K(rng, M):
    q, _ = np.linalg.qr(rng.standard_normal((M, M)))
    K = (q * np.linspace(-1.0, 2.0, M)) @ q.T
    v0 = rng.standard_normal(M)
    return 0.5 * (K + K.T), v0 / np.linalg.norm(v0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("iters", [8, 24, 32])
def test_lanczos_kernel(cuda, dtype, iters):
    """B9 on a well-conditioned K (eigenvalues spread over [-1, 2]): Q,
    alphas and betas row by row, relative to each output's largest entry
    (1e-4 f32, 1e-10 f64). In f64 at iters 32 the basis no longer fits
    in shared memory and lives in the output."""
    K, v0 = _on(cuda, dtype, *_spread_K(np.random.default_rng(iters), 1024))
    with launches(lanczos_fused) as added:
        got = lanczos_fused(K, v0, iters=iters)
    torch.cuda.synchronize()
    assert added == {lanczos_route(dtype, 1024): 1}
    ref = lanczos_plain(K, v0, iters=iters)
    for g, r in zip(got, ref):
        _close(g, r, _tol(dtype, loose=True))
    assert float(got[2][-1]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_lanczos_kernel_breakdown(cuda, dtype):
    """Breakdown: in f64 a K of rank 3 with a start inside its range (the
    residual reaches rounding level after three steps), in f32 a diagonal
    K with an eigenvector start (exactly zero after one step; f32 rounding
    stays above the 1e-12 rule otherwise). The kernel breaks down where
    the plain version does, and every later row, alpha and beta is exactly
    zero."""
    rng = np.random.default_rng(7)
    M, iters = 1024, 8
    if dtype == torch.float64:
        q, _ = np.linalg.qr(rng.standard_normal((M, 3)))
        K = (q * np.array([1.0, 2.0, 3.0])) @ q.T
        v0 = q @ np.ones(3) / np.sqrt(3.0)
    else:
        K = np.diag(np.r_[1.0, 2.0, 3.0, np.zeros(M - 3)])
        v0 = np.eye(M)[1]
    K, v0 = _on(cuda, dtype, K, v0)
    with launches(lanczos_fused) as added:
        Q, alphas, betas = lanczos_fused(K, v0, iters=iters)
    torch.cuda.synchronize()
    assert added == {"cluster" if dtype == torch.float32 else "l2": 1}
    rQ, ra, rb = lanczos_plain(K, v0, iters=iters)
    assert torch.equal(betas == 0, rb == 0)
    dead = int(torch.nonzero(betas == 0)[0]) + 1
    assert dead <= (4 if dtype == torch.float64 else 1)
    assert bool((Q[dead:] == 0).all()) and bool((alphas[dead:] == 0).all())
    assert bool((betas[dead - 1:] == 0).all())
    _close(alphas[:dead], ra[:dead], _tol(dtype, loose=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,M,iters,route", [
    (torch.float32, 1024, 8, "cluster"), (torch.float32, 999, 24, "cluster"),
    (torch.float32, 37, 8, "cluster"), (torch.float32, 5, 3, "cluster"),
    (torch.float32, 1100, 8, "l2"), (torch.float64, 1024, 8, "l2")])
def test_lanczos_kernel_routes(cuda, dtype, M, iters, route):
    """B9 on each route (on the cluster's 16 CTAs: M = 1024 with 10 of a
    CTA's 64 rows streamed from L2, a ragged M, a CTA owning no row at M =
    5), against the plain version, and deterministic: two launches give
    the same bits."""
    K, v0 = _on(cuda, dtype, *_spread_K(np.random.default_rng(M), M))
    assert lanczos_route(dtype, M) == route
    with launches(lanczos_fused) as added:
        got = lanczos_fused(K, v0, iters=iters)
        again = lanczos_fused(K, v0, iters=iters)
    torch.cuda.synchronize()
    assert added == {route: 2}
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    for g, r in zip(got, lanczos_plain(K, v0, iters=iters)):
        _close(g, r, _tol(dtype, loose=True))
    assert float(got[2][-1]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", [300, 999])
def test_bicgstab_kernel(cuda, dtype, M):
    """B10 on a diagonally dominant non-symmetric K (ragged M)."""
    rng = np.random.default_rng(M)
    K, rhs = _on(cuda, dtype, rng.standard_normal((M, M)) / np.sqrt(M)
                 + 2.0 * np.eye(M), rng.standard_normal(M))
    with launches(bicgstab_solve_fused) as added:
        got = bicgstab_solve_fused(K, rhs, iters=16)
    torch.cuda.synchronize()
    assert added == {bicgstab_route(dtype, M): 1}
    _close(got, bicgstab_solve_plain(K, rhs, iters=16),
           _tol(dtype, loose=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,M,route", [
    (torch.float32, 5, "cluster"), (torch.float32, 37, "cluster"),
    (torch.float32, 512, "cluster"), (torch.float32, 668, "cluster"),
    (torch.float32, 669, "l2"), (torch.float64, 512, "l2")])
def test_bicgstab_kernel_routes(cuda, dtype, M, route):
    """B10 on each route, at its edges (a CTA of the cluster owning no
    row at M = 5, the largest cluster M and one past it), held against
    the plain version, and deterministic: two launches give the same
    bits."""
    rng = np.random.default_rng(M + 1)
    K, rhs = _on(cuda, dtype, rng.standard_normal((M, M)) / np.sqrt(M)
                 + 2.0 * np.eye(M), rng.standard_normal(M))
    iters = 3 if M < 8 else 32
    assert bicgstab_route(dtype, M) == route
    with launches(bicgstab_solve_fused) as added:
        got = bicgstab_solve_fused(K, rhs, iters=iters)
        again = bicgstab_solve_fused(K, rhs, iters=iters)
    torch.cuda.synchronize()
    assert added == {route: 2}
    assert torch.equal(got, again)
    _close(got, bicgstab_solve_plain(K, rhs, iters=iters),
           _tol(dtype, loose=True))


MM_TYPES = [torch.float32, torch.bfloat16]


def _mm_tol(dtype, roundings):
    return 1e-4 if dtype == torch.float32 else roundings * 2.0 ** -8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", MM_TYPES)
@pytest.mark.parametrize("B,m,k,n", [(5, 40, 24, 56), (3, 128, 64, 128),
                                     (3, 20, 12, 28), (7, 33, 17, 30)])
def test_two_site_merge_kernel(cuda, dtype, B, m, k, n):
    rng = np.random.default_rng(m)
    a, b = _on(cuda, dtype, rng.standard_normal((B, m, k)),
               rng.standard_normal((B, k, n)))
    with launches(two_site_merge) as added:
        got = two_site_merge(a, b)
    torch.cuda.synchronize()
    assert added == {merge_route(dtype, m, k, n): 1}
    assert got.dtype == torch.float32
    _close(got, two_site_merge_plain(a, b), 1e-5)


@pytest.mark.cuda
def test_two_site_merge_kernel_wmma_route(cuda):
    """bf16 operands too large for the mma route's shared memory."""
    rng = np.random.default_rng(3)
    a, b = _on(cuda, torch.bfloat16, rng.standard_normal((2, 256, 192)),
               rng.standard_normal((2, 192, 256)))
    with launches(two_site_merge) as added:
        got = two_site_merge(a, b)
    torch.cuda.synchronize()
    assert added == {"wmma": 1}
    _close(got, two_site_merge_plain(a, b), 1e-5)


def _orthonormal(rng, B, rows, cols):
    return np.linalg.qr(rng.standard_normal((B, rows, cols)))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", MM_TYPES)
@pytest.mark.parametrize("B,m,k", [(5, 40, 24), (3, 128, 128)])
def test_matmul_chain_kernel(cuda, dtype, B, m, k):
    rng = np.random.default_rng(k)
    x, w = _on(cuda, dtype, 0.1 * rng.standard_normal((B, m, k)),
               _orthonormal(rng, B, k, k))
    with launches(matmul_chain) as added:
        got = matmul_chain(x, w, iters=8)
    torch.cuda.synchronize()
    assert added == {matmul_chain_route(dtype, m, k): 1}
    assert got.dtype == dtype
    _close(got.float(), matmul_chain_plain(x, w, iters=8).float(),
           _mm_tol(dtype, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,k,route", [
    (2, 65, 64, "wgmma"), (3, 70, 100, "wgmma"), (2, 128, 17, "wgmma"),
    (2, 40, 160, "wmma")])
def test_matmul_chain_kernel_bf16_routes(cuda, B, m, k, route):
    """bf16 B12 on both routes: wgmma at k <= 128 (padded to 64 or 128,
    rows to strips of 64), ragged, and wmma past it."""
    assert matmul_chain_route(torch.bfloat16, m, k) == route
    with launches(matmul_chain) as added:
        test_matmul_chain_kernel(cuda, torch.bfloat16, B, m, k)
    assert added == {route: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("B,m,k", [(16, 128, 128), (8, 100, 64)])
def test_matmul_chain_kernel_norm_keeping(cuda, B, m, k):
    """The bench's 1024 iterations on an input whose iterate keeps its
    norm (w w^T = I exactly in bf16): every iteration counts."""
    p = norm_keeping_matmul_problem(cuda, batch=B, m=m, k=k, seed=k)
    with launches(matmul_chain) as added:
        got = matmul_chain(p["x"], p["w"], iters=1024)
    torch.cuda.synchronize()
    assert added == {"wgmma": 1}
    ref = matmul_chain_plain(p["x"], p["w"], iters=1024)
    got, ref, x = got.float(), ref.float(), p["x"].float()
    assert float((got - ref).norm() / ref.norm()) <= 1e-3
    assert abs(float(got.norm() / x.norm()) - 1.0) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", MM_TYPES)
@pytest.mark.parametrize("B,r,n", [(5, 20, 3), (3, 64, 2), (4, 48, 2)])
def test_merge_resplit_chain_kernel(cuda, dtype, B, r, n):
    rng = np.random.default_rng(r)
    a, b, w = _on(cuda, dtype, 0.1 * rng.standard_normal((B, r * n, r)),
                  np.swapaxes(_orthonormal(rng, B, n * r, r), 1, 2),
                  _orthonormal(rng, B, n * r, r))
    with launches(merge_resplit_chain) as added:
        got = merge_resplit_chain(a, b, w, iters=8)
    torch.cuda.synchronize()
    assert added == {chain_route(dtype, r, n * r): 1}
    _close(got.float(), merge_resplit_chain_plain(a, b, w, iters=8).float(),
           _mm_tol(dtype, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("B,r,n", [(2, 64, 8), (2, 80, 2)])
def test_merge_resplit_chain_kernel_bf16_edges(cuda, B, r, n):
    """bf16 shapes at the edges of the wgmma route (n r = 512) and past it
    (r = 80, the wmma route); too large for the f32 kernel."""
    test_merge_resplit_chain_kernel(cuda, torch.bfloat16, B, r, n)


@pytest.mark.cuda
@pytest.mark.parametrize("B,r,n", [(64, 64, 2), (16, 16, 3)])
def test_merge_resplit_chain_kernel_norm_keeping(cuda, B, r, n):
    """The bench's 2048 iterations on an input whose iterate keeps its
    norm (b w = I exactly in bf16): every iteration counts."""
    p = norm_keeping_contraction_problem(cuda, batch=B, r=r, n=n, seed=r)
    with launches(merge_resplit_chain) as added:
        got = merge_resplit_chain(p["a"], p["b"], p["w"], iters=2048)
    torch.cuda.synchronize()
    assert added == {"wgmma": 1}
    ref = merge_resplit_chain_plain(p["a"], p["b"], p["w"], iters=2048)
    got, ref, a = got.float(), ref.float(), p["a"].float()
    assert float((got - ref).norm() / ref.norm()) <= 1e-3
    assert abs(float(got.norm() / a.norm()) - 1.0) <= 1e-2


def _env_A_routes(monkeypatch):
    """Every B8 call of the ALS eigensweeps appends the route its launch
    took."""
    routes = []

    def call(*args, **kwargs):
        with launches(env_chain_A_fused) as added:
            out = env_chain_A_fused(*args, **kwargs)
        routes.extend(added)
        return out

    monkeypatch.setattr(als_scan, "env_chain_A_fused", call)
    return routes


@pytest.mark.cuda
def test_als_eigsolve_on_route_cluster(cuda, monkeypatch):
    """The XXX chain (RA = 5) in f32 at d = 12, R = 32: two B8 launches a
    sweep, both on route cluster, and the ground energy within 1e-5."""
    p = als_eig_problem(cuda, d=12, rmax=32, dtype=torch.float32)
    routes = _env_A_routes(monkeypatch)
    with launches(env_chain_A_fused) as added:
        E, x = als_scan.als_eigsolve_scan(p["A"], p["x0"], n_sweeps=1)
    assert added == {"cluster": 2}
    assert routes == ["cluster", "cluster"]
    E0 = dense_xxx_groundstate(12)
    assert np.isfinite(E).all() and abs(E[-1] - E0) <= 1e-5 * abs(E0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,op", [(torch.float32, "laplacian"),
                                      (torch.float64, "xxx")])
def test_als_eigsolve_on_route_staged(cuda, monkeypatch, dtype, op):
    """The Laplacian (RA = 3) in f32 and the XXX chain in f64 take route
    staged; the energies match the same solve on the CPU in f64."""
    d, R = 8, 16
    p = als_eig_problem(torch.device("cpu"), d=d, rmax=R,
                        dtype=torch.float64)
    A = laplacian(d, device=torch.device("cpu")) if op == "laplacian" \
        else p["A"]
    E_cpu, _ = als_scan.als_eigsolve_scan(A, p["x0"], n_sweeps=2)
    routes = _env_A_routes(monkeypatch)
    E, _ = als_scan.als_eigsolve_scan(A.astype(dtype).to(cuda),
                                      p["x0"].astype(dtype).to(cuda),
                                      n_sweeps=2)
    assert routes == ["staged"] * 4
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    assert np.max(np.abs(E - E_cpu)) <= tol * np.max(np.abs(E_cpu))


@pytest.mark.cuda
def test_mals_sweep_on_the_card_matches_the_cpu(cuda):
    """One MALS sweep in f64 (d = 8, rmax = 16): the realized ranks and the
    represented state of the CPU run."""
    cpu = torch.device("cpu")
    out = []
    for dev in (cpu, cuda):
        p = mals_problem(dev, d=8, rmax=16)
        out.append(mals_linsolve_scan(p["A"], p["b"], p["x0"],
                                      rmax=p["rmax"]))
    assert out[0].ranks == out[1].ranks
    ref = ttv_to_tensor(out[0]).reshape(-1)
    got = ttv_to_tensor(out[1]).reshape(-1).cpu()
    err = min(float((got - ref).norm()), float((got + ref).norm()))
    assert err <= 1e-10 * float(ref.norm())


# ---------------------------------------------------------------------------
# The eager tier on the card: no kernel, cuSOLVER and cuBLAS
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_thin_svd_is_orthonormal_in_float32(cuda):
    """``core.linalg.thin_svd`` (cuSOLVER's ``gesvd`` on the card) keeps a
    seeded 1024 x 64 f32 matrix's singular vectors orthonormal to 5e-6
    (the Jacobi default reached only 1.3e-5 on the two-site splits)."""
    from ttnx_torch.core.linalg import thin_svd

    rng = np.random.default_rng(14)
    m = torch.as_tensor(rng.standard_normal((1024, 64)), dtype=torch.float32,
                        device=cuda)
    u, s, vh = thin_svd(m)
    eye = torch.eye(64, dtype=torch.float32, device=cuda)
    assert float((u.T @ u - eye).abs().max()) <= 5e-6
    assert float((vh @ vh.T - eye).abs().max()) <= 5e-6


def _heat_problem(dev, d=8, rmax=8):
    from ttnx_torch.entry import sine_mode_problem

    hg = 1.0 / (2 ** d + 1)
    return sine_mode_problem(dev, d=d, scale=1.0 / hg ** 2,
                             modes=((1, 1.0), (3, 0.5), (9, 0.25)),
                             rmax=rmax)


@pytest.mark.cuda
def test_eager_als_solve_on_the_card_matches_the_cpu(cuda):
    """One eager ALS solve of the CN system (I - h/2 A) x = u0, f64, d = 8,
    guess rank 8: the card's represented vector is the CPU's (1e-10) and
    every core stays on the card."""
    from ttnx_torch.core.algebra import add_op, scale_op
    from ttnx_torch.core.tt import id_tto
    from ttnx_torch.solvers.als import als_linsolve

    out = []
    for dev in (torch.device("cpu"), cuda):
        p = _heat_problem(dev)
        lhs = add_op(id_tto(8, device=dev), scale_op(-5e-6, p["A"]))
        out.append(als_linsolve(lhs, p["u0"], p["guess"], sweep_count=4))
    assert all(c.is_cuda for c in out[1].cores)
    ref = ttv_to_tensor(out[0]).reshape(-1)
    got = ttv_to_tensor(out[1]).reshape(-1).cpu()
    assert float((got - ref).norm() / ref.norm()) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("t", [0.3, -0.2j])
def test_expm_multiply_on_the_card_matches_the_cpu(cuda, t):
    """``expm_multiply`` of a seeded symmetric 200 x 200 f64 matrix: the
    card's result is the CPU's (1e-10), on the card."""
    from ttnx_torch.solvers.krylov import expm_multiply

    rng = np.random.default_rng(3)
    G = rng.standard_normal((200, 200)) / np.sqrt(200)
    M, v = 0.5 * (G + G.T), rng.standard_normal(200)
    out = []
    for dev in (torch.device("cpu"), cuda):
        Mt = torch.as_tensor(M, device=dev)
        out.append(expm_multiply(lambda x: Mt.to(x.dtype) @ x, t,
                                 torch.as_tensor(v, device=dev)))
    assert out[1].is_cuda
    err = (out[1].cpu() - out[0]).abs().max() / out[0].abs().max()
    assert float(err) <= 1e-10


@pytest.mark.cuda
def test_lobpcg_on_a_shifted_matrix_in_float32(cuda):
    """``core.linalg.lobpcg_standard`` on the card, f32, M = 4096: the top
    eigenpair of a seeded ``Q diag(w) Q^T`` (spectrum in [0, 1], top
    eigenvalue 1.5) as DMRG's shifted local matrix gives it, to 1e-5 (at
    ``tol = 1e-9``; JAX's rule at the default f32 eps stops at a residual
    of ~1e-2 here)."""
    from ttnx_torch.core.linalg import lobpcg_standard

    rng = np.random.default_rng(7)
    M = 4096
    q, _ = np.linalg.qr(rng.standard_normal((M, M)))
    w = np.linspace(0.0, 1.0, M)
    w[-1] = 1.5
    K = torch.as_tensor((q * w) @ q.T, dtype=torch.float32, device=cuda)
    X = torch.as_tensor(rng.standard_normal((M, 1)), dtype=torch.float32,
                        device=cuda)
    theta, U, it = lobpcg_standard(K, X, m=100, tol=1e-9)
    assert U.is_cuda and it < 100
    assert abs(float(theta[0]) - 1.5) <= 1.5e-5
    overlap = abs(float(U[:, 0].double().cpu() @ torch.as_tensor(q[:, -1])))
    assert overlap >= 1 - 1e-5


# ---------------------------------------------------------------------------
# The cross and the checkpoints on the card: no kernel
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_maxvol_on_the_card_gives_the_cpu_rows(cuda, dtype):
    """``maxvol_fixed`` on a seeded stack of 16 tall matrices at the
    Wishart cross's shape (64 x 8) and a ragged one (45 x 7): the card's
    rows (its rectangular batched LU, its pseudo-inverse through
    ``thin_svd`` and its on-card swaps) are the CPU's, in f64 and f32."""
    from ttnx_torch.cross.device import maxvol_fixed

    rng = np.random.default_rng(15)
    for n, r in ((64, 8), (45, 7)):
        a = torch.as_tensor(rng.standard_normal((16, n, r)), dtype=dtype)
        ref = maxvol_fixed(a, 1.05, maxiter=100)
        got = maxvol_fixed(a.to(cuda), 1.05, maxiter=100)
        assert got.is_cuda and torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_save_and_load_on_the_card(cuda, tmp_path):
    """A QTT vector on the card saved and loaded onto the card: the same
    subclass, metadata and bits."""
    from ttnx_torch.ops.qtt import QTTVector, function_to_qttv
    from ttnx_torch.utils.checkpoint import load_tt, save_tt

    q = function_to_qttv(lambda c: np.sin(c[..., 0]) * c[..., 1], 2, 5,
                         ordering="serial", device=cuda)
    p = str(tmp_path / "q.npz")
    save_tt(p, q)
    back = load_tt(p, device=cuda)
    assert isinstance(back, QTTVector) and back.ordering == "serial"
    assert (back.n_dims, back.bits_per_dim) == (2, 5)
    assert all(c.is_cuda for c in back.cores)
    assert all(torch.equal(a, b) for a, b in zip(q.cores, back.cores))


# ---------------------------------------------------------------------------
# The distributed layer's collectives on CUDA tensors: no kernel
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_collectives_on_cuda_tensors_over_gloo(cuda):
    """Two gloo ranks on the card: ``psum``, ``psum_scatter`` and
    ``all_gather`` of CUDA tensors take the ``gloo-cuda`` route (all
    through ``all_reduce``) and give the numpy sums and concatenations
    exactly (small integers in float64)."""
    from ttnx_torch.parallel.launch import RankPool

    rng = np.random.default_rng(16)
    xs = [rng.integers(-50, 50, size=(3, 4, 2)).astype(np.float64)
          for _ in range(2)]
    with RankPool(2, device=cuda, meshes=((1, 2),), timeout=120) as pool:
        outs = pool.run("test_torch_comm:comm_body", (1, 2), "tp", xs)
    total = xs[0] + xs[1]
    for rank, (idx, size, route, s, sc, g) in enumerate(outs):
        assert (idx, size, route) == (rank, 2, "gloo-cuda")
        np.testing.assert_array_equal(s, total)
        np.testing.assert_array_equal(sc, np.split(total, 2, axis=1)[rank])
        np.testing.assert_array_equal(g, np.concatenate(xs, axis=2))
