"""The launches of one kernel wrapper of the port, read around a call."""

from contextlib import contextmanager

from ttnx_torch.kernels import dispatch


@contextmanager
def launches(wrapper):
    """Yield a dict that holds, once the block is left, the launches that
    kernel wrapper ``wrapper`` made inside the block, by route (the growth
    of its ``dispatch.route_counts()`` entry; empty on the plain path)."""
    was = dispatch.route_counts()[wrapper.__name__]
    added = {}
    yield added
    for route, n in dispatch.route_counts()[wrapper.__name__].items():
        if n != was.get(route, 0):
            added[route] = n - was.get(route, 0)
