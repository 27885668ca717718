"""TT algebra: add/scale/dot/norm, MPO·MPS, MPO·MPO, Hadamard, Kronecker.

Every per-site contraction is one two-operand ``torch.einsum`` (a single
batched matmul). Rank bookkeeping is static (shapes).
"""

from __future__ import annotations

import torch

from ttnx_torch.core.tt import TTOperator, TTVector, zeros_tt, zeros_tto

__all__ = [
    "add",
    "sub",
    "add_op",
    "sub_op",
    "scale",
    "scale_op",
    "matvec",
    "matmul",
    "inner_core_product",
    "outer_product",
    "dot",
    "norm",
    "hadamard",
    "hadamard_ttm",
    "kron_tt",
    "kron_tto",
    "ttv_to_diag_tto",
    "linear_combination",
    "euclidean_distance",
    "euclidean_distance_normalized",
]


def _result_dtype(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return dt


def _scalar_dtype(x, a):
    """Result dtype of ``a * core`` with a Python scalar kept weak (a float
    scalar does not promote float32 cores)."""
    return torch.result_type(x.cores[0], a)


# ---------------------------------------------------------------------------
# Addition (block-diagonal core concatenation)
# ---------------------------------------------------------------------------


def _block_add(x, y, cls, extra_axes: int):
    d = x.N
    dt = _result_dtype(x, y)
    if d == 1:
        return cls([x.cores[0].to(dt) + y.cores[0].to(dt)])
    xr, yr = x.ranks, y.ranks
    last = 1 + extra_axes  # index of the right bond axis
    cores = []
    for k in range(d):
        a, b = x.cores[k].to(dt), y.cores[k].to(dt)
        if k == 0:
            c = torch.cat([a, b], dim=last)
        elif k == d - 1:
            c = torch.cat([a, b], dim=0)
        else:
            shape = ((xr[k] + yr[k],) + tuple(a.shape[1:last])
                     + (xr[k + 1] + yr[k + 1],))
            c = torch.zeros(shape, dtype=dt, device=a.device)
            c[: xr[k], ..., : xr[k + 1]] = a
            c[xr[k]:, ..., xr[k + 1]:] = b
        cores.append(c)
    return cls(cores)


def add(x: TTVector, y: TTVector) -> TTVector:
    """``x + y`` by block-diagonal core concatenation; ranks add."""
    if x.dims != y.dims:
        raise ValueError("Incompatible dimensions")
    return _block_add(x, y, TTVector, 1)


def add_op(x: TTOperator, y: TTOperator) -> TTOperator:
    """MPO addition."""
    if x.dims != y.dims or x.in_dims != y.in_dims:
        raise ValueError("Incompatible dimensions")
    return _block_add(x, y, TTOperator, 2)


def scale(a, x: TTVector) -> TTVector:
    """Scalar times TT vector: scale the orthogonality-center core."""
    dt = _scalar_dtype(x, a)
    if isinstance(a, (int, float, complex)) and a == 0:
        return zeros_tt(x.dims, x.ranks, dtype=dt, device=x.device)
    i = x.ot.index(0) if 0 in x.ot else 0
    cores = [c.to(dt) for c in x.cores]
    cores[i] = cores[i] * a
    return TTVector(cores, x.ot)


def scale_op(a, x: TTOperator) -> TTOperator:
    dt = _scalar_dtype(x, a)
    if isinstance(a, (int, float, complex)) and a == 0:
        return zeros_tto(x.dims, x.ranks, dtype=dt, device=x.device)
    i = x.ot.index(0) if 0 in x.ot else 0
    cores = [c.to(dt) for c in x.cores]
    cores[i] = cores[i] * a
    return TTOperator(cores, x.ot)


def sub(x: TTVector, y: TTVector) -> TTVector:
    return add(x, scale(-1.0, y))


def sub_op(x: TTOperator, y: TTOperator) -> TTOperator:
    return add_op(x, scale_op(-1.0, y))


def linear_combination(tts, coeffs) -> TTVector:
    """``sum_i coeffs[i] * tts[i]``."""
    out = scale(coeffs[0], tts[0])
    for c, t in zip(coeffs[1:], tts[1:]):
        out = add(out, scale(c, t))
    return out


# ---------------------------------------------------------------------------
# Contractions
# ---------------------------------------------------------------------------


def matvec(A: TTOperator, v: TTVector) -> TTVector:
    """MPO·MPS with multiplicative ranks and no compression. Rectangular
    operators with one extra singleton-input site (prolongations) are
    dispatched automatically."""
    if A.N == v.N + 1:
        return _matvec_rectangular(A, v)
    if A.in_dims != v.dims:
        raise ValueError("Incompatible dimensions")
    dt = _result_dtype(A, v)
    cores = []
    for k in range(v.N):
        w = A.cores[k].to(dt)
        x = v.cores[k].to(dt)
        ra, n, _, rb = w.shape
        rc, _, rd = x.shape
        y = torch.einsum("aijb,cjd->acibd", w, x)
        cores.append(y.reshape(ra * rc, n, rb * rd))
    return TTVector(cores)


def _matvec_rectangular(A: TTOperator, v: TTVector) -> TTVector:
    singleton = [k for k in range(A.N) if A.in_dims[k] == 1]
    if len(singleton) != 1:
        raise ValueError(
            "Rectangular TToperator must have exactly one singleton input site")
    s = singleton[0]
    exp_in = tuple(A.in_dims[k] for k in range(A.N) if k != s)
    if exp_in != v.dims:
        raise ValueError("Incompatible input dimensions")
    if v.ranks[-1] != 1:
        raise ValueError("Input TTvector must have a closed right boundary rank")
    dt = _result_dtype(A, v)
    cores = []
    for k in range(A.N):
        w = A.cores[k].to(dt)
        if k == s:
            nu = v.ranks[k]
            eye = torch.eye(nu, dtype=dt, device=w.device)
            y = torch.einsum("aib,vw->avibw", w[:, :, 0, :], eye)
            ra, rb = w.shape[0], w.shape[3]
            cores.append(y.reshape(ra * nu, w.shape[1], rb * nu))
        else:
            x = v.cores[k if k < s else k - 1].to(dt)
            ra, n, _, rb = w.shape
            rc, _, rd = x.shape
            y = torch.einsum("aijb,cjd->acibd", w, x)
            cores.append(y.reshape(ra * rc, n, rb * rd))
    return TTVector(cores)


def matmul(A: TTOperator, B: TTOperator) -> TTOperator:
    """MPO·MPO, ranks multiply."""
    if A.in_dims != B.out_dims:
        raise ValueError("Incompatible dimensions")
    dt = _result_dtype(A, B)
    cores = []
    for k in range(A.N):
        a = A.cores[k].to(dt)
        b = B.cores[k].to(dt)
        ra, no, _, rb = a.shape
        rc, _, ni, rd = b.shape
        y = torch.einsum("aizb,czjd->acijbd", a, b)
        cores.append(y.reshape(ra * rc, no, ni, rb * rd))
    return TTOperator(cores)


def inner_core_product(A: TTOperator, B: TTOperator) -> TTOperator:
    """Sitewise Kronecker of physical and bond axes (the QTT product),
    A-major index ordering on every merged axis."""
    if A.N != B.N:
        raise ValueError("Inner core product requires equal site counts")
    dt = _result_dtype(A, B)
    cores = []
    for k in range(A.N):
        a = A.cores[k].to(dt)
        b = B.cores[k].to(dt)
        ra, nAo, nAi, rb = a.shape
        rc, nBo, nBi, rd = b.shape
        y = torch.einsum("aijb,ckld->acikjlbd", a, b)
        cores.append(y.reshape(ra * rc, nAo * nBo, nAi * nBi, rb * rd))
    return TTOperator(cores)


def outer_product(x: TTVector, y: TTVector) -> TTOperator:
    """``|x><y|`` as an MPO, ranks multiply."""
    dt = _result_dtype(x, y)
    cores = []
    for k in range(x.N):
        a = x.cores[k].to(dt)
        b = y.cores[k].to(dt).conj()
        ra, n, rb = a.shape
        rc, m, rd = b.shape
        z = torch.einsum("aib,cjd->acijbd", a, b)
        cores.append(z.reshape(ra * rc, n, m, rb * rd))
    return TTOperator(cores)


def ttv_to_diag_tto(x: TTVector) -> TTOperator:
    """Lift a TT vector to the diagonal MPO ``diag(x)``."""
    cores = []
    for c in x.cores:
        eye = torch.eye(c.shape[1], dtype=c.dtype, device=c.device)
        cores.append(torch.einsum("aib,ij->aijb", c, eye))
    return TTOperator(cores)


# ---------------------------------------------------------------------------
# Inner products and norms
# ---------------------------------------------------------------------------


def dot(a: TTVector, b: TTVector):
    """``<a, b>`` via left-to-right transfer matrices, conjugating ``a``.
    Returns a 0-d tensor on the cores' device."""
    if a.dims != b.dims:
        raise ValueError("TT dimensions are not compatible")
    dt = _result_dtype(a, b)
    env = torch.ones((1, 1), dtype=dt, device=a.device)
    for k in range(a.N):
        ac = a.cores[k].to(dt).conj()
        bc = b.cores[k].to(dt)
        tmp = torch.einsum("ac,cid->aid", env, bc)
        env = torch.einsum("aib,aid->bd", ac, tmp)
    return env[0, 0]


def norm(a: TTVector):
    """``||a||``, read off the triangular factors of a left-to-right QR sweep
    (the norm of the last core of a left-orthogonalized copy). Backward
    stable: its error is eps times the size of ``a``'s cores. ``sqrt(Re
    <a, a>)``, the JAX package's formula, loses everything below sqrt(eps)
    of those sizes to cancellation when ``a`` is a difference (a residual
    ``A x - b``), and which side of zero the rounding falls then decides
    whether a tight residual check passes (ROADMAP C.23)."""
    r = torch.ones((1, 1), dtype=a.dtype, device=a.device)
    for c in a.cores:
        m = torch.einsum("ab,bic->aic", r, c)
        r = torch.linalg.qr(m.reshape(-1, m.shape[2]))[1]
    return torch.linalg.vector_norm(r)


def euclidean_distance(a: TTVector, b: TTVector):
    v = dot(a, a).real - 2.0 * dot(b, a).real + dot(b, b).real
    return torch.sqrt(torch.clamp(v, min=0.0))


def euclidean_distance_normalized(a: TTVector, b: TTVector):
    bb = dot(b, b)
    v = 1.0 + (dot(a, a) / bb).real - 2.0 * (dot(b, a) / bb).real
    return torch.sqrt(torch.clamp(v, min=0.0))


# ---------------------------------------------------------------------------
# Hadamard and Kronecker products
# ---------------------------------------------------------------------------


def hadamard(x: TTVector, y: TTVector) -> TTVector:
    """Elementwise product; ranks multiply."""
    if x.dims != y.dims:
        raise ValueError("Incompatible TT dimensions")
    dt = _result_dtype(x, y)
    cores = []
    for k in range(x.N):
        a = x.cores[k].to(dt)
        b = y.cores[k].to(dt)
        ra, n, rb = a.shape
        rc, _, rd = b.shape
        y_k = torch.einsum("aib,cid->acibd", a, b)
        cores.append(y_k.reshape(ra * rc, n, rb * rd))
    return TTVector(cores)


def _ttm_swap(cores, j, tol, rmax):
    """Swap-SVD at bond j for the TTM zip-up."""
    from ttnx_torch.core.canonical import svdtrunc

    a, b = cores[j], cores[j + 1]
    rl, da, _ = a.shape
    _, db, rr = b.shape
    m = torch.einsum("lam,mbr->lbar", a, b).reshape(rl * db, da * rr)
    u, s, vt = svdtrunc(m, max_bond=rmax, truncerr=tol)
    r = s.shape[0]
    cores[j] = u.reshape(rl, db, r)
    cores[j + 1] = (s[:, None].to(vt.dtype) * vt).reshape(r, da, rr)


def _ttm_contract(cores, p):
    """Elementwise contraction of two same-physical-dim cores."""
    cores[p] = torch.einsum("lsm,msr->lsr", cores[p], cores[p + 1])
    del cores[p + 1]


def hadamard_ttm(x: TTVector, y: TTVector, tol: float = 1e-14,
                 rmax: int | None = None) -> TTVector:
    """Rank-controlled Hadamard product via the TTM zip-up: append the
    reversed ``y`` chain, then repeatedly swap-SVD and contract."""
    if x.dims != y.dims:
        raise ValueError("Incompatible TT dimensions")
    d = x.N
    dt = _result_dtype(x, y)
    cores = [c.to(dt) for c in x.cores]
    for k in range(d):
        cores.append(y.cores[d - 1 - k].to(dt).transpose(0, 2))
    for it in range(1, d + 1):
        for j in range(d - 1, d - it, -1):
            _ttm_swap(cores, j, tol, rmax)
        _ttm_contract(cores, d - it)
    return TTVector(cores)


def kron_tt(a: TTVector, b: TTVector) -> TTVector:
    """Kronecker product over disjoint sites = chain concatenation."""
    dt = _result_dtype(a, b)
    return TTVector([c.to(dt) for c in a.cores + b.cores], a.ot + b.ot)


def kron_tto(A: TTOperator, B: TTOperator) -> TTOperator:
    dt = _result_dtype(A, B)
    return TTOperator([c.to(dt) for c in A.cores + B.cores], A.ot + B.ot)
