"""The flagship step, the d=12 Crank–Nicolson QTT heat step, and the
batched implicit-heat problem.

``entry(device)`` returns ``(fn, (u_stack,))``: one CN step of
``du/dt = A u`` with ``A`` the scaled Dirichlet Laplacian, rank 16, f32,
through the production configuration (matrix-free/dense fused CG,
Gram-chain rounding, no TF32, 16 warm-started CG iterations).

``batched_als_problem(device)`` builds the throughput workload: B
independent rank-64 d=12 implicit heat solves ``(I - h/2 A) x = u0`` sharing
one operator, for ``als_sweeps_b`` and ``als_fwd_bwd_fused_batched``.
``flat_spectrum_stack`` makes distinct, well-conditioned states for holding
the batched kernels against their plain versions.

``dmrg_problem(device)`` is the DMRG eigensweep workload (the open XXX
chain from a random orthonormal rank-4 start), ``dense_xxx_groundstate``
its independent numpy oracle, and ``tdvp_problem(device)`` the
imaginary-time TDVP workload (the heat generator on a site-0-canonical
sine), each as ``bench.py`` sets them up.

``convection_cn_step(device)`` is the CN step of a non-symmetric
convection–diffusion generator through the dense-K BiCGStab (kernel B10),
with ``dense_cn_reference`` its sparse-LU oracle;
``contraction_problem(device)`` and ``matmul_ceiling_problem(device)``
build the inputs of the rank-64 core contraction chain (kernels B11, B13)
and its matmul ceiling (B12) as ``bench.py`` does;
``norm_keeping_contraction_problem(device)`` and
``norm_keeping_matmul_problem(device)`` are chain inputs whose iterate
keeps its norm, so B11 and B12 can be held to their plain versions at the
bench's 2048 and 1024 iterations.

``als_eig_problem(device)`` is the ALS eigensolve workload (the open XXX
chain from a seeded orthonormal start at the buffer rank, for
``als_eigsolve_scan`` and ``mals_eigsolve_scan``) and
``mals_problem(device)`` the MALS linear solve (the Dirichlet Laplacian
with the right-hand side of a sampled sine, which is the exact solution).

``sine_mode_problem(device)`` is the time-stepper workload of the eager
tier: a scaled Dirichlet Laplacian and a sum of its eigenmodes, whose
evolution under any stepper is a per-mode factor; ``mode_sum`` is its
numpy oracle.
"""

from __future__ import annotations

import torch

import numpy as np

from ttnx_torch.core.algebra import add_op, scale_op
from ttnx_torch.core.canonical import tt_round
from ttnx_torch.core.tt import (TTVector, id_tto, increase_ranks,
                                r_and_d_to_rks, rand_tt)
from ttnx_torch.ops.operators import (heisenberg_xyz_tto, laplacian,
                                      toeplitz_to_qtto)
from ttnx_torch.ops.qtt import function_to_qtt, qtt_sin
from ttnx_torch.solvers.als_scan import pack_op, pack_tt, rank_masks
from ttnx_torch.solvers.round_scan import make_cn_step

__all__ = ["entry", "flagship_cn_step", "three_mode_state",
           "batched_als_problem", "flat_spectrum_stack", "dmrg_problem",
           "dense_xxx_groundstate", "tdvp_problem", "convection_operator",
           "convection_cn_step",
           "convection_cn_operators", "dense_cn_reference",
           "contraction_problem", "norm_keeping_contraction_problem",
           "matmul_ceiling_problem", "norm_keeping_matmul_problem",
           "als_eig_problem", "mals_problem", "sine_mode_problem",
           "mode_sum"]


def flagship_cn_step(device, rmax: int = 16, d: int = 12, h: float = 1e-9,
                     dtype=torch.float32, cg_iters: int = 16):
    """``make_cn_step`` at the production settings on ``device``."""
    hg = 1.0 / (2 ** d + 1)
    A = (-1.0 / hg ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, d,
                                            device=device)
    return make_cn_step(
        A, h, rmax=rmax, dims=(2,) * d,
        u_rks=(1,) + (rmax,) * (d - 1) + (1,), dtype=dtype, sweep_count=2,
        solver="cg_fused", round_method="gram_chain", precision="highest",
        cg_iters=cg_iters)


def entry(device):
    """``(fn, (u_stack,))``: the flagship step and a packed ``qtt_sin``
    state on ``device``."""
    d = 12
    hg = 1.0 / (2 ** d + 1)
    step_fn, pack, _ = flagship_cn_step(device, d=d)
    u_stack = pack(qtt_sin(d, a=hg, b=1 - hg, device=device))
    return step_fn, (u_stack,)


def three_mode_state(d: int, hg: float, device):
    """Sum of three Dirichlet eigenmodes of the grid Laplacian (rank 6) on
    the interior grid, float64."""

    def mode(lam):
        return qtt_sin(d, a=hg, b=1 - hg, lam=lam, device=device)

    return mode(1.0) + 0.5 * mode(3.0) + 0.25 * mode(9.0)


def batched_als_problem(device, *, batch: int = 512, rmax: int = 64,
                        d: int = 12, h: float = 1e-6, dtype=torch.float32):
    """The batched implicit heat solve on ``device``: ``lhs_stack`` of
    ``I - h/2 A``, the rank-``rmax`` three-mode state packed as ``b_batch``
    and ``x_batch`` (broadcast over ``batch``), ``masks``, ``u_rks`` and the
    unpacked float64 state ``u0``. Returns a dict of those six."""
    hg = 1.0 / (2 ** d + 1)
    A = ((-1.0 / hg ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, d,
                                             device=device)).astype(dtype)
    lhs = add_op(id_tto(d, dtype=dtype, device=device),
                 scale_op(-h / 2, A))
    lhs_stack = pack_op(lhs, max(lhs.ranks))
    u_rks = r_and_d_to_rks((1,) + (rmax,) * (d - 1) + (1,), (2,) * d,
                           rmax=rmax)
    masks = rank_masks(u_rks, rmax, dtype=dtype, device=device)
    u0 = three_mode_state(d, hg, device)
    us = pack_tt(tt_round(u0, max_bond=rmax).astype(dtype), rmax)
    b_batch = us.expand((batch,) + us.shape)
    return dict(lhs_stack=lhs_stack, b_batch=b_batch, x_batch=b_batch,
                masks=masks, u_rks=u_rks, u0=u0)


def flat_spectrum_stack(rng, rks, R: int, n: int = 2):
    """Padded ``(d, R, n, R)`` numpy stack of a TT with ranks ``rks`` whose
    cores are left- and right-orthonormal up to scale (random orthogonal
    blocks from ``rng``), so every bond has a flat singular spectrum. Such
    states keep the Newton–Schulz gauge of the fused sweep well
    conditioned; states whose bond spectra fall to rounding level do not
    (ROADMAP C)."""
    d = len(rks) - 1
    out = np.zeros((d, R, n, R))
    for k in range(d):
        rl, rr = rks[k], rks[k + 1]
        if rl == rr:
            for i in range(n):
                q, _ = np.linalg.qr(rng.standard_normal((rl, rl)))
                out[k, :rl, i, :rr] = q / np.sqrt(n)
        elif max(rl, rr) == n * min(rl, rr):  # rising or falling ranks
            q, _ = np.linalg.qr(rng.standard_normal((max(rl, rr),) * 2))
            out[k, :rl, :, :rr] = q.reshape(rl, n, rr)
        else:
            raise ValueError(f"flat_spectrum_stack: bond ranks {rl} -> {rr}"
                             f" are neither equal nor a factor {n} apart")
    return out


def dmrg_problem(device, *, d: int = 10, rmax: int = 16,
                 dtype=torch.float32, seed: int = 3):
    """The DMRG eigensweep workload on ``device``: the open XXX chain
    (Pauli convention, MPO rank 5) packed as ``A_stack``, a random
    normalized left-orthonormal rank-4 start (``torch.Generator`` seeded
    ``seed``) packed at ``rmax`` as ``x_stack``, its ``masks``, and ``tol =
    degen_tol = 1e-8``. Returns a dict of those five."""
    H = heisenberg_xyz_tto(d, jx=1.0, jy=1.0, jz=1.0, device=device)
    H = H.astype(dtype)
    x0 = rand_tt(torch.Generator().manual_seed(seed), (2,) * d, rmax=4,
                 normalise=True, orthogonal=True).astype(dtype).to(device)
    return dict(A_stack=pack_op(H, max(H.ranks)), x_stack=pack_tt(x0, rmax),
                masks=rank_masks(x0.ranks, rmax, dtype=dtype, device=device),
                tol=1e-8, degen_tol=1e-8)


def _seeded_start(seed: int, d: int, rank: int, **kw) -> TTVector:
    """A normalized random TT of rank ``rank`` from a CPU
    ``torch.Generator`` seeded ``seed`` (float64, on the CPU)."""
    return rand_tt(torch.Generator().manual_seed(seed), (2,) * d,
                   rmax=rank, normalise=True, **kw)


def als_eig_problem(device, *, d: int = 12, rmax: int = 32,
                    dtype=torch.float32, seed: int = 3):
    """The ALS eigensolve workload on ``device``: the open XXX chain
    (Pauli convention, MPO rank 5) as ``A`` and a random left-orthonormal
    start of rank ``rmax`` (feasibility-clamped, seeded ``seed``) as
    ``x0``, both in ``dtype``. ``entry.dense_xxx_groundstate(d)`` is its
    oracle. Returns a dict of ``A``, ``x0`` and ``rmax``."""
    H = heisenberg_xyz_tto(d, device=device).astype(dtype)
    x0 = _seeded_start(seed, d, rmax, orthogonal=True)
    return dict(A=H, x0=x0.astype(dtype).to(device), rmax=rmax)


def mals_problem(device, *, d: int = 12, rmax: int = 64,
                 dtype=torch.float64, seed: int = 3):
    """The MALS linear-solve workload on ``device``: ``A`` the Dirichlet
    Laplacian ``toeplitz(2, -1, -1)``, ``u`` the sampled ``sin(pi x)`` on
    the uniform grid of [0, 1] (rank 2), ``b = A u`` (built in float64),
    and a random rank-4 start ``x0`` seeded ``seed``, all in ``dtype``;
    ``u`` is the exact solution. Returns a dict of those four and
    ``rmax``, the buffer rank (64, the default, at d = 12)."""
    A = laplacian(d, device=device)
    u = function_to_qtt(lambda x: np.sin(np.pi * x), d, device=device)
    x0 = _seeded_start(seed, d, 4)
    return dict(A=A.astype(dtype), u=u.astype(dtype),
                b=(A @ u).astype(dtype), x0=x0.astype(dtype).to(device),
                rmax=rmax)


def sine_mode_problem(device, *, d: int = 12, scale: float = 1.0,
                      modes=((1, 1.0), (16, 0.5), (256, 0.25)),
                      rmax: int | None = None, dtype=torch.float64):
    """A time-stepper workload with a closed form on ``device``: ``A =
    scale * tridiag(1, -2, 1)`` (``toeplitz_to_qtto(-2, 1, 1)``, MPO rank
    3), ``u0 = sum_k c_k sin(k pi x)`` on the interior grid ``x_j = j hg``,
    ``hg = 1 / (2^d + 1)`` (rank 2 a mode), and ``guess``, ``u0`` rounded
    without truncation and zero-padded to ranks ``rmax`` (``u0`` itself
    when ``rmax`` is None),
    all in ``dtype``. Each mode is an eigenvector of ``A`` with eigenvalue
    ``lam_k = scale (2 cos(k pi hg) - 2)``. ``modes`` are the pairs ``(k,
    c_k)``; the default is ``examples/time_steppers.py``'s state,
    ``((1, 1.0), (3, 0.5), (9, 0.25))`` with ``scale = 1 / hg^2`` the
    flagship's heat problem on :func:`three_mode_state`. Returns a dict of
    ``A``, ``u0``, ``guess``, ``hg``, ``modes`` and ``lam``."""
    hg = 1.0 / (2 ** d + 1)
    A = scale * toeplitz_to_qtto(-2.0, 1.0, 1.0, d, device=device)
    u0 = None
    for k, c in modes:
        mode = c * qtt_sin(d, a=hg, b=1 - hg, lam=float(k), device=device)
        u0 = mode if u0 is None else u0 + mode
    # the sum's edge bonds exceed the feasible ranks: round (exactly) first
    guess = u0 if rmax is None else increase_ranks(tt_round(u0), rmax)
    lam = tuple(scale * (2 * np.cos(k * np.pi * hg) - 2) for k, _ in modes)
    return dict(A=A.astype(dtype), u0=u0.astype(dtype),
                guess=guess.astype(dtype), hg=hg, modes=tuple(modes),
                lam=lam)


def mode_sum(d: int, hg: float, modes, factors) -> np.ndarray:
    """``sum_k c_k f_k sin(k pi j hg)`` for ``j = 1 .. 2^d`` (numpy,
    float64): :func:`sine_mode_problem`'s state with each mode ``(k,
    c_k)`` scaled by its factor ``f_k``."""
    j = np.arange(1, 2 ** d + 1)
    out = np.zeros(2 ** d)
    for (k, c), f in zip(modes, factors):
        out += c * f * np.sin(k * np.pi * j * hg)
    return out


def dense_xxx_groundstate(d: int) -> float:
    """Ground energy of the open XXX chain, ``sum_i sx sx + sy sy + sz sz``
    over the bonds (Pauli convention), from Kronecker products with numpy
    and scipy alone: a dense ``eigvalsh`` up to 2^10 states, sparse
    ``eigsh`` above."""
    from scipy import sparse
    from scipy.sparse.linalg import eigsh

    sx = np.array([[0.0, 1.0], [1.0, 0.0]])
    sy_i = np.array([[0.0, -1.0], [1.0, 0.0]])  # sy = i * sy_i
    sz = np.diag([1.0, -1.0])
    N = 2 ** d
    H = sparse.csr_matrix((N, N))
    for i in range(d - 1):
        for P, sgn in ((sx, 1.0), (sy_i, -1.0), (sz, 1.0)):
            op = sparse.kron(sparse.identity(2 ** i), sparse.kron(P, P))
            op = sparse.kron(op, sparse.identity(2 ** (d - i - 2)))
            H = H + sgn * op  # (i sy_i) x (i sy_i) = -(sy_i x sy_i)
    if N <= 1024:
        return float(np.linalg.eigvalsh(H.toarray())[0])
    return float(eigsh(H.tocsr(), k=1, which="SA", tol=0.0)[0][0])


def _host_orth0(u, dtype, device) -> TTVector:
    """Right-canonicalize ``u`` to centre site 0 in float64 numpy on the
    host, then cast: an on-device float32 orthogonalization costs the
    TDVP gate several times its budget."""
    cores = [c.detach().cpu().double().numpy() for c in u.cores]
    for k in range(len(cores) - 1, 0, -1):
        rl, nn, rr = cores[k].shape
        q, r = np.linalg.qr(cores[k].reshape(rl, nn * rr).T)
        cores[k] = np.ascontiguousarray(q.T.reshape(q.shape[1], nn, rr))
        cores[k - 1] = np.einsum("anb,cb->anc", cores[k - 1], r)
    return TTVector([torch.as_tensor(c, dtype=dtype, device=device)
                     for c in cores])


def tdvp_problem(device, d: int = 10, rmax: int = 8, *,
                 dtype=torch.float32):
    """The imaginary-time TDVP workload on ``device``: the heat generator
    ``(0.1 / hg^2) tridiag(1, -2, 1)`` (MPO rank 3) as ``A_stack``, the
    interior-grid sine ``u0`` (float64, rank 2) packed at ``rmax`` in
    site-0 canonical form as ``x_stack``, its ``masks`` and ``u_rks``, and
    the decay rate ``lam1`` of its mode: ``exp(-lam1 t) u0`` is the exact
    evolution."""
    hg = 1.0 / (2 ** d + 1)
    A = ((0.1 / hg ** 2) * toeplitz_to_qtto(-2.0, 1.0, 1.0, d,
                                            device=device)).astype(dtype)
    u0 = qtt_sin(d, a=hg, b=1 - hg, device=device)
    u_rks = r_and_d_to_rks(u0.ranks, (2,) * d, rmax=rmax)
    return dict(A=A, A_stack=pack_op(A, max(A.ranks)),
                x_stack=pack_tt(_host_orth0(u0, dtype, device), rmax),
                masks=rank_masks(u_rks, rmax, dtype=dtype, device=device),
                u_rks=u_rks, u0=u0,
                lam1=0.1 * (2 - 2 * np.cos(np.pi * hg)) / hg ** 2)


def convection_operator(d: int, c: float, device):
    """``A = -(1/hg^2) toeplitz_to_qtto(2, -1, -1) + (c/(2 hg))
    toeplitz_to_qtto(0, 1, -1)`` on the interior grid ``hg = 1/(2^d + 1)``:
    diffusion and central convection (non-symmetric, MPO rank 6)."""
    hg = 1.0 / (2 ** d + 1)
    return add_op(
        (-1.0 / hg ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, d,
                                            device=device),
        (c / (2 * hg)) * toeplitz_to_qtto(0.0, 1.0, -1.0, d, device=device))


def convection_cn_step(device, rmax: int = 16, d: int = 12, h: float = 1e-6,
                       c: float = 1e3, dtype=torch.float32,
                       bicg_iters: int = 32):
    """``make_cn_step`` of ``du/dt = A u`` for :func:`convection_operator`,
    at the flagship's settings with ``solver='bicgstab_fused'``
    (``bicg_iters`` cold BiCGStab steps a local solve)."""
    A = convection_operator(d, c, device)
    return make_cn_step(
        A, h, rmax=rmax, dims=(2,) * d,
        u_rks=(1,) + (rmax,) * (d - 1) + (1,), dtype=dtype, sweep_count=2,
        solver="bicgstab_fused", round_method="gram_chain",
        precision="highest", cg_iters=bicg_iters)


def convection_cn_operators(d: int, hg: float, h: float, c: float):
    """``(I - h/2 A, I + h/2 A)`` as scipy sparse matrices for the exact
    tridiagonal :func:`convection_operator`, float64."""
    from scipy import sparse

    N = 2 ** d
    # toeplitz_to_qtto(0, 1, -1)'s +1 sits at (i, i+1) of the dense matrix
    lower = 1.0 / hg ** 2 - c / (2 * hg)   # A[i, i-1]
    upper = 1.0 / hg ** 2 + c / (2 * hg)   # A[i, i+1]
    A = sparse.diags([np.full(N - 1, lower), np.full(N, -2.0 / hg ** 2),
                      np.full(N - 1, upper)], [-1, 0, 1], format="csc")
    eye = sparse.identity(N, format="csc")
    return eye - (h / 2) * A, eye + (h / 2) * A


def dense_cn_reference(d: int, hg: float, h: float, c: float, u0, steps: int):
    """``steps`` exact CN steps of :func:`convection_cn_step`'s generator
    from the dense vector ``u0`` (length ``2^d``): sparse LU of ``I - h/2
    A`` with numpy and scipy alone, float64."""
    from scipy.sparse.linalg import splu

    lhs, rhs = convection_cn_operators(d, hg, h, c)
    lu = splu(lhs.tocsc())
    u = np.asarray(u0, dtype=np.float64).reshape(-1)
    for _ in range(steps):
        u = lu.solve(rhs @ u)
    return u


def contraction_problem(device, batch: int = 4096, r: int = 64, n: int = 2,
                        dtype=torch.bfloat16, seed: int = 0):
    """The inputs of ``bench_pallas_chain`` on ``device``: ``a (batch, r n,
    r)`` (0.1 N(0, 1)), ``b (batch, r, n r)`` and ``w (batch, n r, r)``
    orthonormal factors from numpy's ``default_rng(seed)`` and QR, cast to
    ``dtype``. Returns a dict of the three."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, r * n, r)) * 0.1
    b = np.swapaxes(np.linalg.qr(rng.standard_normal((batch, n * r, r)))[0],
                    1, 2)
    w = np.linalg.qr(rng.standard_normal((batch, n * r, r)))[0]
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device, dtype)
            for k, v in (("a", a), ("b", b), ("w", w))}


def _sylvester_hadamard(r: int) -> np.ndarray:
    """The ``r x r`` Sylvester Hadamard matrix (``r`` a power of two)."""
    if r < 1 or r & (r - 1):
        raise ValueError(f"r={r} is not a power of two")
    h = np.ones((1, 1))
    while h.shape[0] < r:
        h = np.block([[h, h], [h, -h]])
    return h


def norm_keeping_contraction_problem(device, batch: int = 4096, r: int = 64,
                                     n: int = 2, dtype=torch.bfloat16,
                                     seed: int = 0):
    """Inputs of the contraction chain whose iterate keeps its norm: ``a
    (batch, r n, r)`` (0.1 N(0, 1)) as in :func:`contraction_problem`, ``b
    (batch, r, n r)`` holding ``H / sqrt(r)`` (``H`` the Sylvester Hadamard
    matrix) in ``r`` of its ``n r`` columns, chosen and signed per problem
    from numpy's ``default_rng(seed)``, zero elsewhere, and ``w = b^T``.
    ``b w = I``, exactly in bf16 where ``1/sqrt(r)`` is a power of two (r =
    16, 64): the chain then moves the iterate only by its roundings, so a
    kernel can be held to its plain version over thousands of iterations
    (the bench input decays to zero). Returns a dict of the three."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, r * n, r)) * 0.1
    cols = np.argsort(rng.random((batch, n * r)), axis=1)[:, :r]
    signs = rng.choice((-1.0, 1.0), size=(batch, 1, r))
    b = np.zeros((batch, r, n * r))
    vals = np.broadcast_to(_sylvester_hadamard(r) / np.sqrt(r),
                           (batch, r, r))
    np.put_along_axis(b, np.broadcast_to(cols[:, None, :], (batch, r, r)),
                      vals * signs, axis=2)
    w = np.swapaxes(b, 1, 2)
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device, dtype)
            for k, v in (("a", a), ("b", b), ("w", w))}


def matmul_ceiling_problem(device, batch: int = 4096, m: int = 128,
                           k: int = 128, seed: int = 2,
                           dtype=torch.bfloat16):
    """The inputs of ``bench_pallas_matmul_ceiling``'s chain on ``device``:
    ``x (batch, m, k)`` (0.1 N(0, 1)) and orthonormal ``w (batch, k, k)``
    from numpy's ``default_rng(seed)`` and QR, cast to ``dtype``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, m, k)) * 0.1
    w = np.linalg.qr(rng.standard_normal((batch, k, k)))[0]
    return {k_: torch.as_tensor(v).to(device, dtype)
            for k_, v in (("x", x), ("w", w))}


def norm_keeping_matmul_problem(device, batch: int = 4096, m: int = 128,
                                k: int = 128, seed: int = 2,
                                dtype=torch.bfloat16):
    """Inputs of the matmul chain whose iterate keeps its norm: ``x (batch,
    m, k)`` (0.1 N(0, 1)) as in :func:`matmul_ceiling_problem`, and ``w =
    P blockdiag(H / 8, ...) S`` per problem, ``H`` the 64 x 64 Sylvester
    Hadamard matrix, ``P`` a row permutation and ``S`` diagonal signs from
    numpy's ``default_rng(seed)``. Every entry of ``w`` is 0 or +-1/8 and
    ``w w^T = I`` exactly in bf16, so the chain moves the iterate only by
    its roundings (the bench input decays to zero). ``k`` must be a
    multiple of 64. Returns a dict of the two."""
    if k % 64:
        raise ValueError(f"k={k} is not a multiple of 64")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, m, k)) * 0.1
    blocks = np.kron(np.eye(k // 64), _sylvester_hadamard(64) / 8.0)
    perm = np.argsort(rng.random((batch, k)), axis=1)
    signs = rng.choice((-1.0, 1.0), size=(batch, 1, k))
    w = blocks[perm] * signs
    return {k_: torch.as_tensor(np.ascontiguousarray(v)).to(device, dtype)
            for k_, v in (("x", x), ("w", w))}
