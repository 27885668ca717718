"""Kernels B11-B13 of ttnx_torch (the batched core contractions): plain
versions against the ttnx kernels in interpret mode, and the bench's
inputs, on the CPU.

Both sides get the same bf16 values (rounded once from float32 by torch).
Tolerances, relative to the largest entry: float32 1e-5 (f32 sums in
another order); two_site_merge from bf16 inputs 1e-5 (exact products,
f32 sums); the bf16 chains one bf16 ulp (2^-8 of a value) for each of
their roundings — matmul_chain rounds once a round, merge_resplit_chain
twice — because an f32 sum taken in another order can cross a bf16
rounding boundary, and the orthonormal factors do not amplify the
difference. On the norm-keeping input (``b w = I`` exactly in bf16, with
+-1/sqrt(r) entries) every f32 sum is exact, so the chains agree bit for
bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttnx.kernels.contraction import matmul_chain as j_matmul_chain
from ttnx.kernels.contraction import merge_resplit_chain as j_chain
from ttnx.kernels.contraction import two_site_merge as j_merge

from ttnx_torch.entry import (contraction_problem, matmul_ceiling_problem,
                              norm_keeping_contraction_problem,
                              norm_keeping_matmul_problem)
from ttnx_torch.kernels import dispatch
from ttnx_torch.kernels.contraction import (chain_route, matmul_chain,
                                            matmul_chain_plain,
                                            matmul_chain_route, merge_route,
                                            merge_resplit_chain,
                                            merge_resplit_chain_plain,
                                            two_site_merge,
                                            two_site_merge_plain)
from ttnx_torch.utils.flops import contraction_chain_flops, matmul_chain_flops

BF16_ULP = 2.0 ** -8
TYPES = {"f32": (torch.float32, jnp.float32),
         "bf16": (torch.bfloat16, jnp.bfloat16)}


def _pair(x, name):
    """The same values as a torch tensor and a jax array of type ``name``."""
    tdt, jdt = TYPES[name]
    t = torch.as_tensor(np.asarray(x, np.float32)).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _close(got, ref, tol):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape
    err = float(np.max(np.abs(got - ref)))
    assert err <= tol * float(np.max(np.abs(ref))), err


def _orthonormal(rng, B, rows, cols):
    return np.linalg.qr(rng.standard_normal((B, rows, cols)))[0]


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("B,m,k,n", [(8, 16, 8, 16), (4, 16, 8, 16),
                                     (3, 20, 12, 28)])
def test_two_site_merge_plain_vs_ttnx_kernel(name, B, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a, ja = _pair(rng.standard_normal((B, m, k)), name)
    b, jb = _pair(rng.standard_normal((B, k, n)), name)
    ref = j_merge(ja, jb, block_b=1, interpret=True)
    got = two_site_merge(a, b)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("name,tol", [("f32", 1e-5), ("bf16", 4 * BF16_ULP)])
def test_matmul_chain_plain_vs_ttnx_kernel(name, tol):
    rng = np.random.default_rng(5)
    B, m, k, iters = 4, 16, 8, 4
    x, jx = _pair(0.1 * rng.standard_normal((B, m, k)), name)
    w, jw = _pair(_orthonormal(rng, B, k, k), name)
    ref = j_matmul_chain(jx, jw, iters=iters, block_b=2, interpret=True,
                         unroll=2)
    got = matmul_chain(x, w, iters=iters)
    assert got.dtype == x.dtype
    _close(got, ref, tol)


@pytest.mark.parametrize("name,tol", [("f32", 1e-5),
                                      ("bf16", 2 * 3 * BF16_ULP)])
def test_merge_resplit_chain_plain_vs_ttnx_kernel(name, tol):
    rng = np.random.default_rng(7)
    B, r, n, iters = 4, 8, 2, 3
    a, ja = _pair(0.1 * rng.standard_normal((B, r * n, r)), name)
    b, jb = _pair(np.swapaxes(_orthonormal(rng, B, n * r, r), 1, 2), name)
    w, jw = _pair(_orthonormal(rng, B, n * r, r), name)
    ref = j_chain(ja, jb, jw, iters=iters, block_b=4, interpret=True)
    got = merge_resplit_chain(a, b, w, iters=iters)
    assert got.dtype == a.dtype
    _close(got, ref, tol)


@pytest.mark.parametrize("r,n", [(16, 2), (16, 3), (64, 2)])
def test_norm_keeping_problem_b_w_is_the_identity(r, n):
    """``b w = I`` exactly in bf16; ``b`` holds +-H/sqrt(r) in r of its n r
    columns, distinct per problem; ``w = b^T``."""
    p = norm_keeping_contraction_problem(torch.device("cpu"), batch=3, r=r,
                                         n=n, seed=5)
    a, b, w = p["a"], p["b"], p["w"]
    assert a.shape == (3, r * n, r) and b.shape == (3, r, n * r)
    assert all(t.dtype == torch.bfloat16 for t in (a, b, w))
    assert torch.equal(w, b.transpose(1, 2))
    eye = torch.eye(r).expand(3, r, r)
    assert torch.equal(torch.bmm(b.float(), w.float()), eye)
    used = (b != 0).any(dim=1)
    assert (used.sum(dim=1) == r).all()
    assert not torch.equal(b[0], b[1])
    assert torch.equal(b.float().abs().sum(dim=1)[used],
                       torch.full((3 * r,), float(np.sqrt(r))))


@pytest.mark.parametrize("B,r,n,iters", [(4, 16, 2, 16), (2, 16, 3, 16)])
def test_norm_keeping_chain_plain_vs_ttnx_kernel(B, r, n, iters):
    """On the norm-keeping input the plain chain equals the ttnx kernel in
    interpret mode bit for bit, and the iterate keeps its norm (1 %)."""
    p = norm_keeping_contraction_problem(torch.device("cpu"), batch=B, r=r,
                                         n=n, seed=B + n)
    ja, jb, jw = (jnp.asarray(p[k].float().numpy()).astype(jnp.bfloat16)
                  for k in "abw")
    ref = j_chain(ja, jb, jw, iters=iters, block_b=B, interpret=True)
    got = merge_resplit_chain(p["a"], p["b"], p["w"], iters=iters)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          np.asarray(ref.astype(jnp.float32)))
    ratio = float(got.float().norm() / p["a"].float().norm())
    assert abs(ratio - 1.0) <= 1e-2, ratio
    assert not torch.equal(got, p["a"])  # the roundings moved it


def test_norm_keeping_chain_keeps_its_norm_over_the_bench_iterations():
    """At the bench's r = 64 and 2048 iterations (small batch) the norm
    stays within 1 % while the iterate drifts by its roundings only."""
    p = norm_keeping_contraction_problem(torch.device("cpu"), batch=2)
    got = merge_resplit_chain_plain(p["a"], p["b"], p["w"], iters=2048)
    a = p["a"].float()
    assert abs(float(got.float().norm() / a.norm()) - 1.0) <= 1e-2
    drift = float((got.float() - a).norm() / a.norm())
    assert 0.0 < drift < 1e-2, drift


@pytest.mark.parametrize("m,k", [(16, 64), (128, 128), (5, 192)])
def test_norm_keeping_matmul_problem_w_is_orthogonal(m, k):
    """``w w^T = I`` exactly in bf16; every entry 0 or +-1/8, 64 nonzeros
    a row and a column, distinct per problem; ``x`` is the bench's
    recipe."""
    p = norm_keeping_matmul_problem(torch.device("cpu"), batch=3, m=m, k=k,
                                    seed=4)
    x, w = p["x"], p["w"]
    assert x.shape == (3, m, k) and w.shape == (3, k, k)
    assert x.dtype == w.dtype == torch.bfloat16
    wf = w.float()
    eye = torch.eye(k).expand(3, k, k)
    assert torch.equal(torch.bmm(wf, wf.transpose(1, 2)), eye)
    assert torch.equal(torch.bmm(wf.transpose(1, 2), wf), eye)
    assert set(wf.abs().unique().tolist()) == (
        {0.125} if k == 64 else {0.0, 0.125})
    assert ((wf != 0).sum(dim=1) == 64).all()
    assert ((wf != 0).sum(dim=2) == 64).all()
    assert not torch.equal(w[0], w[1])
    rng = np.random.default_rng(4)
    want = rng.standard_normal((3, m, k)) * 0.1
    assert torch.equal(x, torch.as_tensor(want).to(torch.bfloat16))
    with pytest.raises(ValueError):
        norm_keeping_matmul_problem(torch.device("cpu"), batch=1, k=96)


@pytest.mark.parametrize("B,m,k,seed", [(2, 16, 64, 3), (2, 24, 128, 4)])
def test_norm_keeping_matmul_chain_plain_vs_ttnx_kernel(B, m, k, seed):
    """On the norm-keeping input the plain chain equals the ttnx kernel in
    interpret mode bit for bit, and the iterate keeps its norm (1 %)."""
    p = norm_keeping_matmul_problem(torch.device("cpu"), batch=B, m=m, k=k,
                                    seed=seed)
    jx, jw = (jnp.asarray(p[n].float().numpy()).astype(jnp.bfloat16)
              for n in "xw")
    ref = j_matmul_chain(jx, jw, iters=8, block_b=B, interpret=True,
                         unroll=4)
    got = matmul_chain(p["x"], p["w"], iters=8)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          np.asarray(ref.astype(jnp.float32)))
    assert abs(float(got.float().norm() / p["x"].float().norm()) - 1) <= 1e-2


def test_norm_keeping_matmul_chain_keeps_its_norm_over_the_bench_iterations():
    """At the bench's (m, k) = (128, 128) and 1024 iterations (small
    batch) the plain chain's norm stays within 1 %: only its roundings
    move it."""
    p = norm_keeping_matmul_problem(torch.device("cpu"), batch=2)
    got = matmul_chain_plain(p["x"], p["w"], iters=1024).float()
    x = p["x"].float()
    assert bool(torch.isfinite(got).all())
    assert abs(float(got.norm() / x.norm()) - 1.0) <= 1e-2
    assert abs(float(got.norm() / x.norm()) - 1.0) > 0.0  # the roundings


def test_chain_plain_versions_round_where_the_kernels_do():
    """A bf16 chain of one round equals the f32 products of the same
    values rounded once (matmul_chain) and twice (merge_resplit_chain)."""
    rng = np.random.default_rng(9)
    a = torch.as_tensor(rng.standard_normal((2, 8, 4))).to(torch.bfloat16)
    b = torch.as_tensor(rng.standard_normal((2, 4, 8))).to(torch.bfloat16)
    w = torch.as_tensor(rng.standard_normal((2, 8, 4))).to(torch.bfloat16)
    c = torch.bmm(a.double(), b.double()).float().to(torch.bfloat16)
    want = torch.bmm(c.double(), w.double()).float().to(torch.bfloat16)
    assert torch.equal(merge_resplit_chain_plain(a, b, w, iters=1), want)
    sq = w[:, :4, :]
    want = torch.bmm(a.double(), sq.double()).float().to(torch.bfloat16)
    assert torch.equal(matmul_chain_plain(a, sq, iters=1), want)
    assert torch.equal(matmul_chain_plain(a, sq, iters=0), a)


def test_contraction_problem_is_the_bench_input():
    """``bench_pallas_chain``'s numpy recipe (seed 0), bit for bit before
    the cast, at a small batch."""
    batch, r, n = 3, 64, 2
    rng = np.random.default_rng(0)
    a = rng.standard_normal((batch, r * n, r)) * 0.1
    b = np.swapaxes(np.linalg.qr(rng.standard_normal((batch, n * r, r)))[0],
                    1, 2)
    w = np.linalg.qr(rng.standard_normal((batch, n * r, r)))[0]
    got = contraction_problem(torch.device("cpu"), batch=batch,
                              dtype=torch.float64)
    for key, want in (("a", a), ("b", b), ("w", w)):
        assert np.array_equal(got[key].numpy(), want)
    bf = contraction_problem(torch.device("cpu"), batch=batch)
    assert bf["a"].dtype == torch.bfloat16
    assert torch.equal(bf["w"], got["w"].to(torch.bfloat16))


def test_matmul_ceiling_problem_is_the_bench_input():
    """``bench_pallas_matmul_ceiling``'s chain inputs (seed 2), bit for
    bit before the cast, at a small batch."""
    batch, m, k = 2, 128, 128
    rng = np.random.default_rng(2)
    x = rng.standard_normal((batch, m, k)) * 0.1
    w = np.linalg.qr(rng.standard_normal((batch, k, k)))[0]
    got = matmul_ceiling_problem(torch.device("cpu"), batch=batch,
                                 dtype=torch.float64)
    assert np.array_equal(got["x"].numpy(), x)
    assert np.array_equal(got["w"].numpy(), w)


def test_flop_counts_are_the_bench_formulas():
    batch, r, n, iters = 4096, 64, 2, 2048
    bench = 2 * (2.0 * batch * (r * n) * r * (n * r)) * iters
    assert contraction_chain_flops(batch, r, n, iters) == bench
    assert abs(bench - 3.52e13) / 3.52e13 < 1e-3
    assert matmul_chain_flops(4096, 128, 128, 1024) == (
        2.0 * 4096 * 128 * 128 * 128 * 1024)


def test_contraction_wrappers_check_types_and_shapes():
    x = torch.zeros((2, 4, 4))
    with pytest.raises(TypeError):
        two_site_merge(x.double(), x.double())
    with pytest.raises(TypeError):
        matmul_chain(x, x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        matmul_chain(x, torch.zeros((2, 4, 3)))
    with pytest.raises(ValueError):
        merge_resplit_chain(x, torch.zeros((2, 4, 8)), torch.zeros((2, 4, 4)))
    with pytest.raises(ValueError):
        two_site_merge(x, torch.zeros((2, 3, 4)))


def test_kernel_routes_follow_dtype_and_shape():
    """B11 and B13 choose their CUDA kernel by dtype and shape alone: the
    bench shapes take the tensor-core designs, larger shapes the wmma
    kernels, float32 the CUDA-core kernels."""
    bf, f32 = torch.bfloat16, torch.float32
    assert chain_route(bf, 64, 128) == "wgmma"
    assert chain_route(bf, 20, 60) == "wgmma"
    assert chain_route(bf, 64, 512) == "wgmma"
    assert chain_route(bf, 80, 160) == "wmma"
    assert chain_route(bf, 64, 576) == "wmma"
    assert chain_route(f32, 64, 128) == "f32"
    assert merge_route(bf, 128, 64, 128) == "mma"
    assert merge_route(bf, 20, 12, 28) == "mma"
    assert merge_route(bf, 256, 192, 256) == "wmma"
    assert merge_route(f32, 128, 64, 128) == "f32"


@pytest.mark.parametrize("dtype,m,k,route", [
    (torch.bfloat16, 128, 128, "wgmma"), (torch.bfloat16, 5, 17, "wgmma"),
    (torch.bfloat16, 300, 64, "wgmma"), (torch.bfloat16, 128, 129, "wmma"),
    (torch.bfloat16, 40, 160, "wmma"), (torch.float32, 128, 128, "f32"),
    (torch.float32, 40, 160, "f32")])
def test_matmul_chain_route_follows_dtype_and_k(dtype, m, k, route):
    """B12 chooses its CUDA kernel by dtype and k alone: bf16 up to k =
    128 (64 accumulators and 32 operand registers a thread) the wgmma
    kernel, larger bf16 the wmma kernel, float32 the CUDA-core kernel."""
    assert matmul_chain_route(dtype, m, k) == route


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(11)
    a = torch.as_tensor(rng.standard_normal((2, 8, 4)), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal((2, 4, 8)), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((2, 8, 4)), dtype=torch.float32)
    dispatch.reset_launch_counts()
    assert torch.equal(two_site_merge(a, b), two_site_merge_plain(a, b))
    assert torch.equal(merge_resplit_chain(a, b, w, iters=2),
                       merge_resplit_chain_plain(a, b, w, iters=2))
    assert torch.equal(matmul_chain(a, w[:, :4], iters=2),
                       matmul_chain_plain(a, w[:, :4], iters=2))
    assert all(v == 0 for v in dispatch.launch_counts().values())
