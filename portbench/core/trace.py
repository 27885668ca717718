"""The traced window: a profiler pass over a fixed number of units, read
back from the profiler's Chrome trace.

Only what the per-layer metrics and the breakdown need is recorded: device
operations (kernels, copies, sets), CUDA runtime and driver calls, and the
host's operators, with no stacks, shapes or memory. The window is the
host range ``portbench.window``, which starts on an idle device and ends
with a synchronize, so every device operation of its units lies inside it.
Inside it, the range ``portbench.units`` holds the units alone: host waits
are counted there, so the window's closing synchronize is not one.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass

import torch

__all__ = ["WINDOW", "UNITS", "Trace", "parse", "traced_window", "union",
           "SYNC_CALLS"]

WINDOW = "portbench.window"
UNITS = "portbench.units"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_CATS = ("cuda_runtime", "cuda_driver")
# runtime and driver calls that block the host until the device has caught
# up: the synchronizes and the synchronous copies (a tensor read by the
# host is a cudaMemcpyAsync followed by a cudaStreamSynchronize)
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cuCtxSynchronize", "cuStreamSynchronize", "cuEventSynchronize",
              "cuMemcpyDtoH", "cuMemcpyDtoH_v2")
NAME_CHARS = 120


@dataclass
class Trace:
    """One traced window of ``units`` units; times in seconds."""
    units: int
    window_s: float
    wall_s: float            # host clock around the window, for the overhead
    kernels: list            # (name, start, end)
    device_ops: list         # kernels, copies and sets
    calls: list              # CUDA runtime and driver calls: (name, start, end)
    host_ops: list           # operators of the window's thread
    start: float
    units_span: tuple        # (start, end) of the units' host range

    @property
    def busy_s(self) -> float:
        return union(self.device_ops)

    @property
    def kernel_s(self) -> float:
        return union(self.kernels)

    @property
    def host_syncs(self) -> int:
        """Waits that start inside the units' host range."""
        a, b = self.units_span
        return sum(1 for name, t, _ in self.calls
                   if name in SYNC_CALLS and a <= t < b)

    def breakdown(self) -> dict:
        """The ten device operations that took the most time, and the idle
        time summed by the host operator that was running in each gap."""
        by_op = defaultdict(float)
        for name, t0, t1 in self.device_ops:
            by_op[name[:NAME_CHARS]] += t1 - t0
        gaps = defaultdict(float)
        for (a, b), label in zip(self.gaps(), self.gap_labels()):
            gaps[label[:NAME_CHARS]] += b - a
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in idle]}

    def gaps(self) -> list:
        """The intervals of the window in which no device operation ran."""
        out, t = [], self.start
        for a, b in merged(self.device_ops):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        end = self.start + self.window_s
        if end > t:
            out.append((t, end))
        return out

    def gap_labels(self) -> list:
        """For each gap, the innermost host operator or runtime call open at
        its middle, or ``python`` where none was."""
        events = sorted(self.host_ops, key=lambda e: (e[1], -e[2]))
        labels, stack, j = [], [], 0
        for a, b in self.gaps():
            mid = 0.5 * (a + b)
            while j < len(events) and events[j][1] <= mid:
                while stack and stack[-1][2] < events[j][1]:
                    stack.pop()
                stack.append(events[j])
                j += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            labels.append(stack[-1][0] if stack else "python")
        return labels


def merged(intervals) -> list:
    out = []
    for _, a, b in sorted(intervals, key=lambda e: e[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union(intervals) -> float:
    """Seconds covered by the union of ``(name, start, end)`` intervals."""
    return sum(b - a for a, b in merged(intervals))


def parse(path, units: int, wall_s: float) -> Trace:
    """Read a Chrome trace written by ``torch.profiler`` (times in us)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]

    def annotation(name):
        found = [e for e in events if e.get("cat") == "user_annotation"
                 and e["name"] == name]
        if len(found) != 1:
            raise RuntimeError(f"the trace holds {len(found)} {name} ranges, "
                               f"not 1")
        return found[0]

    w, u = annotation(WINDOW), annotation(UNITS)
    t0, t1 = w["ts"], w["ts"] + w["dur"]

    def inside(cats, tid=None):
        return [(e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
                for e in events if e.get("cat") in cats
                and t0 <= e["ts"] < t1 and (tid is None or e.get("tid") == tid)]

    device_ops = inside(DEVICE_CATS)
    return Trace(units=units, window_s=w["dur"] * 1e-6, wall_s=wall_s,
                 kernels=inside(("kernel",)),
                 device_ops=device_ops, calls=inside(CALL_CATS),
                 host_ops=inside(("cpu_op",) + CALL_CATS, tid=w.get("tid")),
                 start=t0 * 1e-6,
                 units_span=(u["ts"] * 1e-6, (u["ts"] + u["dur"]) * 1e-6))


def traced_window(session, units: int, first: int, keep, device) -> Trace:
    """Run units ``first .. first + units - 1`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=False,
                 profile_memory=False, with_stack=False) as prof:
        sync(device)
        with record_function(WINDOW):
            t = time.perf_counter()
            with record_function(UNITS):
                for i in range(first, first + units):
                    session.run(i, keep(i))
            sync(device)
            wall = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return parse(path, units, wall)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
