"""Dense linear algebra shared by the solvers: the one thin SVD of the
package, LOBPCG and conjugate gradients.

Every thin SVD in ``ttnx_torch`` goes through :func:`thin_svd`, so one
place decides the driver. On CUDA tensors that is cuSOLVER's ``gesvd``:
its default there, the Jacobi ``gesvdj``, left float32 singular vectors
orthonormal to only 1.3e-5 (``gesvd`` 1.1e-6, on an H100), and the MALS
eigensweep of the d = 10 XXX chain then fell 2.4e-4 below the ground
energy (rel 5.6e-7 above it with ``gesvd``). CPU tensors take LAPACK's
default.

:func:`lobpcg_standard` and :func:`cg` are ports of the JAX routines the
reference's eager solvers call (``jax.experimental.sparse.linalg.
lobpcg_standard`` and ``jax.scipy.sparse.linalg.cg``), with their stopping
rules, so both packages stop their iterations at the same residuals. Each
reads one scalar to the host an iteration for its stopping test.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["thin_svd", "lobpcg_standard", "cg"]


def thin_svd(m: torch.Tensor):
    """``(u, s, vh)`` of ``m`` with ``full_matrices=False``."""
    return torch.linalg.svd(m, full_matrices=False,
                            driver="gesvd" if m.is_cuda else None)


# ---------------------------------------------------------------------------
# LOBPCG (largest eigenpairs of a real symmetric matrix)
# ---------------------------------------------------------------------------


def _col_norms(X):
    return torch.linalg.vector_norm(X, dim=0, keepdim=True)


def _svqb(X):
    """Orthonormal basis of ``X``'s span through the eigenbasis of ``X^T
    X``; columns of a rank-deficient ``X`` come out zero."""
    norms = _col_norms(X)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.T @ X
    w, V = torch.linalg.eigh(inner)
    w, V = w.flip(0), V.flip(1)  # descending
    tau = torch.finfo(X.dtype).eps * w[0]
    sqrted = torch.where(tau > 0, torch.maximum(w, tau), 1.0) ** -0.5
    ortho = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep
    norms = _col_norms(ortho)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, 1.0)


def _orthonormalize(basis):
    for _ in range(2):  # twice is enough
        basis = _svqb(basis)
    return basis


def _project_out(basis, U):
    """The component of ``U`` orthogonal to the orthonormal ``basis``
    (zero columns allowed); suspicious columns are zeroed so that
    ``[basis, U]`` stays zero-or-orthonormal."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    return U * (_col_norms(U) >= 0.99)


def _extend_basis(X, m):
    """``m`` orthonormal columns orthogonal to the orthonormal ``X``, by a
    block Householder reflector (deterministic)."""
    n, k = X.shape
    upper, lower = X[:k], X[k:]
    u, s, vt = thin_svd(upper)
    y = torch.cat([upper + u @ vt, lower], 0)
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       torch.zeros((n - k - m, m), dtype=X.dtype,
                                   device=X.device)], 0)
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * (w @ (w[k:, :].T @ other))
    h[k:] += other
    return h


def lobpcg_standard(A, X: torch.Tensor, m: int = 100,
                    tol: float | None = None):
    """The ``k = X.shape[1]`` largest eigenpairs of the real symmetric
    ``A`` (a matrix or a function on ``(n, k)`` blocks) by LOBPCG from
    ``X``, at most ``m`` iterations. Returns ``(theta, X, iterations)``.
    Converged when every residual norm is below ``tol * 10 n (|A x| +
    theta)`` (``tol`` defaults to the dtype's eps), as in JAX."""
    op: Callable = A if callable(A) else (lambda v: A @ v)
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(f"expected search dim * 5 < matrix dim (got "
                         f"{k * 5}, {n})")
    if tol is None:
        tol = torch.finfo(X.dtype).eps
    X = _orthonormalize(X)
    P = _extend_basis(X, k)
    AX = op(X)
    theta = (X * AX).sum(0, keepdim=True)
    R = AX - theta * X
    it, converged = 0, 0
    while it < m and converged < k:
        R = _project_out(torch.cat((X, P), 1), R)
        XPR = torch.cat((X, P, R), 1)
        w, Q = torch.linalg.eigh(XPR.T @ op(XPR))  # Rayleigh-Ritz
        w, Q = w.flip(0), Q.flip(1)
        B = Q[:, :k]
        B = B / _col_norms(B)
        X = XPR @ B
        X = X / _col_norms(X)
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        normP = _col_norms(P)
        P = P / torch.where(normP == 0, 1.0, normP)
        AX = op(X)
        R = AX - w[None, :k] * X
        resid = torch.linalg.vector_norm(R, dim=0)
        reltol = (torch.linalg.vector_norm(AX, dim=0) + w[:k]) * n * 10
        converged = int((resid < tol * reltol).sum())
        theta = w[None, :k]
        it += 1
    return theta[0, :], X, it


# ---------------------------------------------------------------------------
# Conjugate gradients
# ---------------------------------------------------------------------------


def _vdot_real(x, y):
    return torch.sum(x.conj() * y).real


def cg(A: Callable, b: torch.Tensor, x0: torch.Tensor | None = None, *,
       tol: float = 1e-5, atol: float = 0.0, maxiter: int | None = None):
    """Solve ``A x = b`` for a Hermitian positive-definite ``A`` (a
    function on tensors of ``b``'s shape) by conjugate gradients. Stops when
    ``||r|| <= max(tol ||b||, atol)`` on the recurrence residual or after
    ``maxiter`` steps (default ``10 b.numel()``). Returns ``(x, None)`` as
    JAX does."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    if maxiter is None:
        maxiter = 10 * b.numel()
    bs = float(_vdot_real(b, b))
    atol2 = max(tol ** 2 * bs, atol ** 2)
    x = x0
    r = b - A(x0)
    p = r
    gamma = _vdot_real(r, r).to(b.dtype)
    k = 0
    while float(gamma.real) > atol2 and k < maxiter:
        Ap = A(p)
        alpha = gamma / _vdot_real(p, Ap).to(b.dtype)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_new = _vdot_real(r, r).to(b.dtype)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x, None
