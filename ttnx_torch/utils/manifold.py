"""TT-manifold optimization utilities: the flat-space manifold with the
projection retraction ``orthogonalize(p + t X)``, the Rayleigh quotient and
a Riemannian gradient-descent driver.

Twin of ``ttnx.utils.manifold``. The Euclidean gradient comes from torch's
autograd on leaf copies of the cores (``torch.autograd.grad``), and
``torch.optim`` optimizers apply to a list of leaf cores directly: build
the cost as ``TTVector(cores)``, which keeps the leaves. For complex cores
torch's gradient is the conjugate of ``jax.grad``'s (``dL/dRe + i
dL/dIm``), which is the steepest-ascent direction, so the per-core step
``c - a * g`` descends for complex cores too.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ttnx_torch.core import algebra
from ttnx_torch.core.canonical import orthogonalize, tt_round
from ttnx_torch.core.tt import TTVector, zeros_tt

__all__ = [
    "inner",
    "manifold_norm",
    "distance",
    "zero_vector",
    "retract",
    "TTVectorSpace",
    "ttvector_manifold",
    "manifold_gradient_descent",
    "rayleigh_quotient",
]


def inner(p: TTVector, X: TTVector, Y: TTVector):
    """Flat-space inner product ``<X, Y>`` at base point ``p``."""
    del p
    return algebra.dot(X, Y)


def manifold_norm(p: TTVector, X: TTVector):
    return algebra.norm(X)


def distance(p: TTVector, q: TTVector):
    return algebra.euclidean_distance(p, q)


def zero_vector(p: TTVector) -> TTVector:
    return zeros_tt(p.dims, p.ranks, dtype=p.dtype, device=p.device)


def retract(p: TTVector, X: TTVector, t: float = 1.0,
            max_bond: int | None = None) -> TTVector:
    """Projection retraction: orthogonalize (optionally round) ``p + t X``."""
    moved = algebra.add(p, algebra.scale(t, X))
    if max_bond is not None:
        return tt_round(moved, max_bond=max_bond)
    return orthogonalize(moved, 0)


class TTVectorSpace:
    """Minimal manifold object bundling the operations above."""

    def __init__(self, template: TTVector):
        self.dims = template.dims
        self.ranks = template.ranks

    inner = staticmethod(inner)
    norm = staticmethod(manifold_norm)
    distance = staticmethod(distance)
    zero_vector = staticmethod(zero_vector)
    retract = staticmethod(retract)


def ttvector_manifold(x: TTVector) -> TTVectorSpace:
    return TTVectorSpace(x)


def rayleigh_quotient(A) -> Callable[[TTVector], torch.Tensor]:
    """``x -> Re<x, A x> / Re<x, x>`` as a 0-d tensor: the energy functional
    whose gradient descent approaches the ground state."""

    def cost(x: TTVector):
        num = torch.real(algebra.dot(x, algebra.matvec(A, x)))
        den = torch.real(algebra.dot(x, x))
        return num / den

    return cost


def _detached(x: TTVector) -> TTVector:
    return TTVector([c.detach() for c in x.cores], x.ot)


def core_grad(cost: Callable, x: TTVector) -> list[torch.Tensor]:
    """The gradient of ``cost`` with respect to the cores of ``x``, taken on
    leaf copies of the cores; a core the cost does not reach gets zeros, as
    ``jax.grad`` gives."""
    leaves = [c.detach().requires_grad_() for c in x.cores]
    with torch.enable_grad():
        value = cost(TTVector(leaves, x.ot))
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return [torch.zeros_like(c) if g is None else g
            for c, g in zip(leaves, grads)]


def manifold_gradient_descent(cost: Callable, x0: TTVector, steps: int = 100,
                              lr: float = 0.05, max_bond: int | None = None,
                              tol: float = 0.0):
    """Riemannian gradient descent with projection retraction and
    backtracking line search (monotone descent; the step halves on ascent
    down to 1e-12 and grows by 1.5 after each step).

    ``cost`` maps a TTVector to a real 0-d tensor and must be
    differentiable by autograd (everything in ``ttnx_torch.core.algebra``
    is). Returns ``(x, history)`` with ``history`` a numpy array.
    """
    x = orthogonalize(_detached(x0), 0)
    history = []
    alpha = lr

    def value(x):
        with torch.no_grad():
            return float(cost(x))

    def step_cores(x, g, a):
        # the gradient lives in CORE space (the TT map is multilinear), so the
        # descent step is per-core — NOT TT-vector addition of the gradient
        with torch.no_grad():
            return TTVector([c - a * gc for c, gc in zip(x.cores, g)], x.ot)

    prev = value(x)
    for _ in range(steps):
        g = core_grad(cost, x)
        x_try = step_cores(x, g, alpha)
        val = value(x_try)
        while val > prev and alpha > 1e-12:
            alpha /= 2
            x_try = step_cores(x, g, alpha)
            val = value(x_try)
        x = x_try
        if max_bond is not None:
            x = tt_round(x, max_bond=max_bond)
        history.append(val)
        if tol > 0 and abs(prev - val) < tol:
            break
        prev = val
        alpha *= 1.5
    return x, np.asarray(history)
