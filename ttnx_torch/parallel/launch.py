"""Local ranks for the distributed layer: the port's stand-in for the
virtual devices XLA gives the JAX package on one host.

:class:`RankPool` starts ``world`` processes with ``torch.multiprocessing``
under the ``spawn`` start method (the parent may already hold a CUDA
context, which a forked child cannot use). The ranks form one gloo process
group on a ``FileStore`` in a fresh temporary directory, so pools started at
once never meet, and each runs ``torch.set_num_threads(1)``. On a CUDA
``device`` every rank selects that card, and gloo moves CUDA tensors
(:mod:`ttnx_torch.parallel.comm`'s ``"gloo-cuda"`` route).

A pool runs named rank bodies: ``pool.run("module:function", *args)`` calls
``function(ctx, *args)`` on every rank and returns the ranks' results, in
rank order, with every tensor turned into a numpy array. ``ctx`` is the
rank's :class:`RankContext`: its rank, the world size, its device and the
meshes the pool built on every rank when it started (``meshes=((dp, tp),
...)``, each by :func:`ttnx_torch.parallel.batch.make_mesh`). Arguments and
results are pickled: pass numpy arrays and plain values.

Every wait has a timeout (``timeout`` seconds; the process group's own
collectives time out likewise). A body that raises, a rank that exits, or
a wait that runs out kills every rank and raises ``RuntimeError`` with the
rank's traceback; the next :meth:`RankPool.run` starts a fresh group.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field

import torch

__all__ = ["RankPool", "RankContext"]


@dataclass
class RankContext:
    """What a rank body receives first: ``meshes[(dp, tp)]`` is the
    ``(dp, tp)`` mesh the pool built."""

    rank: int
    world: int
    device: torch.device
    meshes: dict = field(default_factory=dict)


def _host(x):
    """Every tensor in ``x`` (nested in tuples, lists and dicts) as a numpy
    array; everything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def _resolve(name: str):
    module, _, fn = name.partition(":")
    return getattr(importlib.import_module(module), fn)


def _rank_main(rank, world, store_path, device, meshes, timeout, tasks,
               results):
    """A rank's process: join the group, build the meshes, then run bodies
    from ``tasks`` until ``None`` arrives."""
    import torch.distributed as dist

    from ttnx_torch.parallel.batch import make_mesh

    torch.set_num_threads(1)
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        ctx = RankContext(rank, world, device, {
            shape: make_mesh(*shape, device=device) for shape in meshes})
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        return
    results.put((rank, "ready", None))
    parent = multiprocessing.parent_process()
    while True:
        try:
            task = tasks.get(timeout=1.0)
        except queue.Empty:
            if parent.is_alive():
                continue
            break  # the pool's process is gone: leave with it
        if task is None:
            break
        name, args = task
        try:
            out = _host(_resolve(name)(ctx, *args))
        except BaseException:
            results.put((rank, "error", traceback.format_exc()))
            continue
        results.put((rank, "ok", out))
    dist.destroy_process_group()


class RankPool:
    """``world`` local ranks in one gloo process group (see the module
    docstring). Use it as a context manager, or call :meth:`close`."""

    def __init__(self, world: int, *, device, meshes=(),
                 timeout: float = 120.0):
        self.world = world
        self.device = torch.device(device)
        self.meshes = tuple(tuple(m) for m in meshes)
        self.timeout = timeout
        self._procs = []
        self._start()

    def _start(self):
        ctx = torch.multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="ttnx_ranks_")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        store = os.path.join(self._dir, "store")
        for rank in range(self.world):
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                rank, self.world, store, self.device, self.meshes,
                self.timeout, self._tasks[rank], self._results))
            p.start()
            self._procs.append(p)
        self._collect("ready", self.timeout)

    def _collect(self, want: str, timeout: float):
        """One message from every rank, in rank order; kills the pool and
        raises on an error, a dead rank or the timeout."""
        out = [None] * self.world
        seen = 0
        deadline = time.monotonic() + timeout
        while seen < self.world:
            left = deadline - time.monotonic()
            if left <= 0:
                self.kill()
                raise RuntimeError(f"ranks timed out after {timeout} s "
                                   f"({seen} of {self.world} answered)")
            try:
                rank, kind, value = self._results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [(i, p.exitcode) for i, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead:
                    self.kill()
                    raise RuntimeError(f"rank(s) exited: {dead} "
                                       f"(rank, exit code)") from None
                continue
            if kind == "error":
                self.kill()
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            if kind != want:
                self.kill()
                raise RuntimeError(f"rank {rank} sent {kind!r}, expected "
                                   f"{want!r}")
            out[rank] = value
            seen += 1
        return out

    def run(self, body: str, *args, timeout: float | None = None):
        """``body(ctx, *args)`` on every rank (``body`` is
        ``"module:function"``); returns the results in rank order."""
        if not self._procs:
            self._start()
        for q in self._tasks:
            q.put((body, args))
        return self._collect("ok", timeout or self.timeout)

    def kill(self):
        """End every rank at once and remove the store."""
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)
        self._release()

    def close(self):
        """Let every rank leave the group, then end it."""
        if not self._procs:
            return
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
        self.kill()

    def _release(self):
        self._procs = []
        for q in (self._results, *self._tasks):
            q.close()
            q.cancel_join_thread()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
