"""Dense <-> TT conversions (TT-SVD and reconstruction).

Reconstruction is one chain of matmuls with a running ``(prefix, rank)``
matrix. Decomposition runs on host numpy data (it exists for setup and
oracle testing); rank selection by tolerance is data dependent.
"""

from __future__ import annotations

import numpy as np
import torch

from ttnx_torch.core.tt import TTOperator, TTVector

__all__ = [
    "ttv_decomp",
    "tto_decomp",
    "ttv_to_tensor",
    "tto_to_tensor",
    "tto_to_ttv",
    "ttv_to_tto",
    "matricize",
]


def ttv_decomp(tensor, index: int = 0, tol: float = 1e-12, *,
               device) -> TTVector:
    """Hierarchical TT-SVD of a dense tensor (numpy or CPU tensor), root
    core at ``index``: cores left of the root are left-orthogonal
    (ot=+1), right of it right-orthogonal (ot=-1). Singular values
    ``< tol`` are discarded. Cores land on ``device``."""
    a = tensor.numpy() if isinstance(tensor, torch.Tensor) else np.asarray(tensor)
    dims = a.shape
    d = len(dims)
    assert 0 <= index < d
    dtype = a.dtype

    cores: list[np.ndarray] = [None] * d  # type: ignore[list-item]
    rks = [1] * (d + 1)
    cur = a
    for i in range(index):
        cur = cur.reshape(rks[i] * dims[i], -1)
        u, s, vt = np.linalg.svd(cur, full_matrices=False)
        r = max(1, int(np.sum(s >= tol)))
        rks[i + 1] = r
        cores[i] = u[:, :r].reshape(rks[i], dims[i], r)
        cur = s[:r, None] * vt[:r, :]
    for i in range(d - 1, index, -1):
        cur = cur.reshape(-1, dims[i] * rks[i + 1])
        u, s, vt = np.linalg.svd(cur, full_matrices=False)
        r = max(1, int(np.sum(s >= tol)))
        rks[i] = r
        cores[i] = vt[:r, :].reshape(r, dims[i], rks[i + 1])
        cur = u[:, :r] * s[:r][None, :]
    cores[index] = cur.reshape(rks[index], dims[index],
                               rks[index + 1]).astype(dtype)
    ot = [1] * index + [0] + [-1] * (d - index - 1)
    return TTVector([torch.as_tensor(np.ascontiguousarray(c), device=device)
                     for c in cores], ot)


def ttv_to_tensor(x: TTVector) -> torch.Tensor:
    """Contract a TT chain back to the dense tensor (progressive matmuls)."""
    P = x.cores[0].reshape(x.dims[0], x.ranks[1])
    for k in range(1, x.N):
        r, n, rn = x.cores[k].shape
        P = (P @ x.cores[k].reshape(r, n * rn)).reshape(-1, rn)
    return P.reshape(x.dims)


def _op_as_vec(A: TTOperator) -> TTVector:
    return TTVector([c.reshape(c.shape[0], c.shape[1] * c.shape[2],
                               c.shape[3]) for c in A.cores], A.ot)


def tto_to_ttv(A: TTOperator) -> TTVector:
    """Reshape MPO cores to MPS cores over the merged (out, in) index."""
    return _op_as_vec(A)


def ttv_to_tto(x: TTVector) -> TTOperator:
    """Inverse of :func:`tto_to_ttv`; physical dims must be squares."""
    cores = []
    for c in x.cores:
        r, n2, rn = c.shape
        n = int(round(n2 ** 0.5))
        if n * n != n2:
            raise ValueError("physical dimensions must be perfect squares")
        cores.append(c.reshape(r, n, n, rn))
    return TTOperator(cores, x.ot)


def tto_to_tensor(A: TTOperator) -> torch.Tensor:
    """Dense tensor ``T[x1..xd, y1..yd]`` of an MPO."""
    d = A.N
    t = ttv_to_tensor(_op_as_vec(A))
    shape = []
    for no, ni in zip(A.out_dims, A.in_dims):
        shape.extend([no, ni])
    t = t.reshape(shape)
    perm = list(range(0, 2 * d, 2)) + list(range(1, 2 * d, 2))
    return t.permute(perm)


def tto_decomp(tensor, index: int = 0, tol: float = 1e-12, *,
               device) -> TTOperator:
    """TT-SVD of a dense operator given as ``T[x1..xd, y1..yd]``."""
    a = tensor.numpy() if isinstance(tensor, torch.Tensor) else np.asarray(tensor)
    assert a.ndim % 2 == 0
    d = a.ndim // 2
    dims = a.shape[:d]
    assert a.shape[d:] == dims
    perm = []
    for k in range(d):
        perm.extend([k, d + k])
    merged = np.transpose(a, perm).reshape(tuple(n * n for n in dims))
    return ttv_to_tto(ttv_decomp(merged, index=index, tol=tol, device=device))


def matricize(qtt: TTVector, core: int | None = None) -> torch.Tensor:
    """Flatten a QTT state to its grid vector of length
    ``prod(dims[:core])``; trailing sites are read at physical index 0."""
    if core is None:
        core = qtt.N
    if not 1 <= core <= qtt.N:
        raise ValueError(f"core must be in [1, {qtt.N}], got {core}")
    right = torch.ones((1,), dtype=qtt.dtype, device=qtt.device)
    for k in range(qtt.N - 1, core - 1, -1):
        right = qtt.cores[k][:, 0, :] @ right
    P = qtt.cores[0].reshape(qtt.dims[0], qtt.ranks[1])
    for k in range(1, core):
        r, n, rn = qtt.cores[k].shape
        P = (P @ qtt.cores[k].reshape(r, n * rn)).reshape(-1, rn)
    return (P @ right).reshape(-1)
