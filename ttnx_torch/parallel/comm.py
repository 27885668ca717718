"""The collectives of a ``shard_map`` body, on one axis of a device mesh.

The JAX package is single-controller: one process holds a global array and
``shard_map`` bodies call ``jax.lax.psum``, ``psum_scatter``, ``all_gather``
and ``axis_index`` over a named mesh axis. The port is SPMD: every rank of
an initialized ``torch.distributed`` process group runs the same call on its
own block, and these four functions are the twins of those primitives on
the process group of one axis of a ``DeviceMesh`` (``mesh.get_group(axis)``).

Each collective takes its route from the axis group's backend and the
tensor's device, before the call (:func:`route`):

- ``"nccl"``: NCCL on CUDA tensors: ``all_reduce``,
  ``reduce_scatter_tensor`` and ``all_gather_into_tensor``.
- ``"gloo"``: gloo on CPU tensors: the same three.
- ``"gloo-cuda"``: gloo on CUDA tensors, the route of several ranks on one
  card (NCCL refuses two ranks on one device). It uses ``all_reduce``
  alone: the reduce-scatter is an ``all_reduce`` and this rank's slice, the
  all-gather an ``all_reduce`` of a zero buffer that holds this rank's
  block in its slot, which is exact (each entry has one nonzero term).

:func:`local_block` cuts this rank's block of a whole tensor, the twin of
placing it with a ``NamedSharding``. Any other pair of backend and device
than the three above raises ``ValueError``. The tiled forms
concatenate blocks in axis order, as ``tiled=True`` does in JAX; a
collective over another dimension than the leading one moves that
dimension to the front, runs, and moves it back.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["axis_index", "axis_size", "route", "psum", "psum_scatter",
           "all_gather", "local_block"]

# renamed ``all_gather_single`` / ``reduce_scatter_single`` in torch 2.13
_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` (``mesh.shape[axis]`` in JAX)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``), not
    its global rank."""
    return mesh.get_local_rank(axis)


def local_block(x: torch.Tensor, mesh, axis: str,
                dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``mesh[axis]``: the
    twin of ``jax.device_put`` with ``axis`` in the ``PartitionSpec`` at
    ``dim``. The dimension must split evenly."""
    p, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    n = x.shape[dim]
    if n % p:
        raise ValueError(f"dimension {dim} of size {n} does not split over "
                         f"{axis}={p}")
    return x.narrow(dim, idx * (n // p), n // p)


def route(mesh, axis: str, x: torch.Tensor) -> str:
    """The route a collective on ``x`` over ``axis`` takes (see the module
    docstring)."""
    backend = str(dist.get_backend(mesh.get_group(axis)))
    dev = x.device.type
    if backend == "nccl" and dev == "cuda":
        return "nccl"
    if backend == "gloo" and dev == "cpu":
        return "gloo"
    if backend == "gloo" and dev == "cuda":
        return "gloo-cuda"
    raise ValueError(f"no collective route for backend {backend!r} on "
                     f"{dev} tensors")


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``, on every rank."""
    route(mesh, axis, x)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.get_group(axis))
    return out


def psum_scatter(x: torch.Tensor, mesh, axis: str,
                 dim: int = 0) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``, scattered along ``dim``:
    rank ``i`` of the axis keeps block ``i`` of ``size(dim) / p`` entries
    (``jax.lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``)."""
    r = route(mesh, axis, x)
    p, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    n = x.shape[dim]
    if n % p:
        raise ValueError(f"dimension {dim} of size {n} does not split over "
                         f"{axis}={p}")
    if r == "gloo-cuda":
        return psum(x, mesh, axis).narrow(dim, idx * (n // p), n // p)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n // p,) + tuple(xt.shape[1:]))
    _SCATTER(out, xt, group=mesh.get_group(axis))
    return out.movedim(0, dim)


def all_gather(x: torch.Tensor, mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """The blocks ``x`` of every rank of ``axis``, concatenated along
    ``dim`` in axis order, on every rank (``jax.lax.all_gather(...,
    axis=dim, tiled=True)``)."""
    r = route(mesh, axis, x)
    p, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    xt = x.movedim(dim, 0).contiguous()
    n = xt.shape[0]
    if r == "gloo-cuda":
        out = xt.new_zeros((p * n,) + tuple(xt.shape[1:]))
        out[idx * n:(idx + 1) * n] = xt
        dist.all_reduce(out, group=mesh.get_group(axis))
    else:
        out = xt.new_empty((p * n,) + tuple(xt.shape[1:]))
        _GATHER(out, xt, group=mesh.get_group(axis))
    return out.movedim(0, dim)
