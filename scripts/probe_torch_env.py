"""Design probe of kernels B6 (the batched env chains) and B2 (the single
env chains) on one card.

    python3 scripts/probe_torch_env.py --step0
    python3 scripts/probe_torch_env.py [--variants] [--parent DIR]

Builds ``env_chain.cu`` and ``env_chain_site.cu`` (each ``nvcc -Xptxas
-v``, printing every kernel instantiation's registers and spill bytes)
into one library, which the wrappers of ``ttnx_torch.kernels`` then
launch from. Inputs: B6 on the two calls one ``als_sweeps_b`` makes on
``chip_smoke.py`` phase 5's problem (B = 512, rmax 64, f32; right and
left, ``raw``), B2 on the right and left chains of one heat CN step at
ranks 16, 32 and 64 (phase 4's settings, f32).

* ``--step0``: route ``staged`` only (``env_chain.cu``): each
  input's time (CUDA events, median of 3), and one torch.profiler window
  of each, its kernel launches split by phase (the five kernels of a
  site) and by site.
* default: the shared-memory bytes of every site layout from the
  library against ``env_chain.site_layout``; the new routes against their
  plain versions and against themselves (two launches bit-identical) on
  every input, beside route ``staged``; then each input timed interleaved
  (new, staged, staged, new, by forcing ``env_chain.env_route``) beside
  the plain version, and one
  torch.profiler window of each route (device time and kernels a call).
  With ``--variants`` also every variant of ``VARIANTS`` (a text edit of
  ``env_chain_site.cu`` or ``env_site.cuh`` that leaves one part of a
  site out, one library each), interleaved with the sources as they are;
  with ``--parent DIR`` the ``env_chain_site.cu`` and ``env_site.cuh`` of
  DIR (e.g. ``git show HEAD:ttnx_torch/csrc/env_site.cuh``; their entry
  points must take the arguments ``_build`` passes) likewise, on every
  input.

Needs a CUDA card with nvcc (sm_90a); imports torch, numpy, ttnx_torch and
chip_smoke only.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ttnx_torch.kernels import _build, dispatch  # noqa: E402

WORK = ROOT / "build" / "probe_env"
SOURCES = ("env_chain.cu", "env_chain_site.cu")
# label -> (source file, text in it, its replacement): splits of the
# site's time (each leaves out one part, so its results are wrong)
VARIANTS = {
    "no_restage": ("env_site.cuh", "      stage_site(k);\n      __syncthreads();",
                   "      if (t == 0) stage_site(k);\n      __syncthreads();"),
    "no_write": ("env_site.cuh",
                 "      write_out(left ? k + 1 : k, cur, b0, cols);\n", ""),
    "no_push": ("env_site.cuh", "e < (C - 1) * rows * c4;", "e < 0;"),
}


def ptxas_lines(label, out, err):
    lines = (out + err).splitlines()
    for k, ln in enumerate(lines):
        if "Compiling entry" in ln:
            kern = ln.split("'")[1]
            info = " | ".join(
                x.split(":")[-1].strip() for x in lines[k + 1:k + 5]
                if "registers" in x or "spill" in x)
            print(f"ptxas {label}: {demangle(kern)} | {info}", flush=True)


def demangle(name):
    filt = subprocess.run(["c++filt", name], capture_output=True, text=True)
    return (filt.stdout.strip() or name)[:100]


def load(so):
    handle = ctypes.CDLL(str(so))
    for name, (argtypes, suffixes) in _build._SIGNATURES.items():
        for suffix in suffixes:
            fn = getattr(handle, f"ttnx_{name}_{suffix}", None)
            if fn is not None:
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
    for name, argtypes in _build._QUERIES.items():
        fn = getattr(handle, f"ttnx_{name}", None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_longlong
    return handle


def compile_sources(tag, texts):
    """``{file name: source text}`` into one library under WORK/tag, each
    source by its own ``nvcc -c`` (all at once); prints ptxas's registers
    and spills. Returns the loaded CDLL."""
    d = WORK / tag
    d.mkdir(parents=True, exist_ok=True)
    for hdr in _build.CSRC.glob("*.cuh"):
        (d / hdr.name).write_text(hdr.read_text())
    procs = []
    for name, text in texts.items():
        (d / name).write_text(text)
    for name in texts:
        if not name.endswith(".cu"):
            continue
        obj = d / (Path(name).stem + ".o")
        procs.append((name, obj, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(d), "-c", str(d / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for name, _, proc in procs:
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}/{name}:\n"
                               f"{err[-6000:]}")
        ptxas_lines(f"{tag}/{name}", out, err)
    so = d / "kernels.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), *(str(obj) for _, obj, _ in procs)],
                   check=True)
    return load(so)


def sources(step0):
    names = SOURCES[:1] if step0 else SOURCES
    return {s: (_build.CSRC / s).read_text() for s in names}


def cuda_ms(fn, reps=1) -> float:
    return chip_smoke.cuda_ms(fn, reps, 3)


def b6_inputs(dev):
    """The two B6 calls (right, left) of one als_sweeps_b on phase 5's
    problem, as chip_smoke.py records them."""
    seen = chip_smoke.bench_batch_calls(dev)
    return list(zip((" right", " left"), seen["env_chain_fused_batched"]))


def b2_inputs(dev):
    """``{rmax: [(side, name, (args, kwargs))]}``: the two B2 calls of one
    CN step at each rank."""
    out = {}
    for rmax in chip_smoke.RANKS:
        step_fn, us, _ = chip_smoke.setup(rmax, dev)
        seen = chip_smoke.record_calls(lambda: step_fn(us))
        out[rmax] = [(side, name, seen[name][0]) for side, name in
                     ((" right", "right_env_chain_fused"),
                      (" left", "left_env_chain_fused"))]
    return out


def kernel_events(run):
    """The CUDA kernels of one call of ``run`` under torch.profiler, in
    start order: ``[(name, device us)]``."""
    from torch.profiler import ProfilerActivity

    run()
    torch.cuda.synchronize()
    with chip_smoke.profiler([ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    evs = []
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "device_time", None)
            evs.append((e.time_range.start, e.name,
                        e.cuda_time if t is None else t))
    evs.sort()
    return [(n, t) for _, n, t in evs]


def short(name):
    m = re.search(r"(right_\w+|left_\w+|set_e0|mix_kernel|\w+_kernel\w*)",
                  name)
    return m.group(1) if m else name[:40]


def split_phases(label, run, d):
    """Device time of one call by phase (kernel) and by site."""
    evs = [(short(n), t) for n, t in kernel_events(run)]
    total = sum(t for _, t in evs)
    phases = {}
    for n, t in evs:
        phases.setdefault(n, []).append(t)
    body = [(n, t) for n, t in evs if n != "set_e0"]
    per_site = len(body) // d if d else 0
    sites = [sum(t for _, t in body[k * per_site:(k + 1) * per_site])
             for k in range(d)] if per_site else []
    print(f"profile {label}: {len(evs)} launches, device {total / 1e3:.4f} "
          f"ms; by phase (count, ms, us a launch): "
          + ", ".join(f"{n} {len(v)} {sum(v) / 1e3:.4f} "
                      f"{sum(v) / len(v):.2f}" for n, v in phases.items())
          + f"; by site in launch order (ms): "
          + " ".join(f"{s / 1e3:.4f}" for s in sites), flush=True)


def staged_call(name, args, kwargs):
    kernel = chip_smoke.wrappers()[name][0]
    return lambda: kernel(*args, **kwargs)


def step0(dev):
    for rmax, calls in b2_inputs(dev).items():
        for side, name, (args, kwargs) in calls:
            run = staged_call(name, args, kwargs)
            before = dispatch.route_counts()
            run()
            taken = chip_smoke.routes_of(name, before)
            print(f"time B2 staged r{rmax}{side}: {cuda_ms(run, 10):.4f} ms "
                  f"(routes {taken}, {sum(taken.values())} wrapper launch)",
                  flush=True)
            split_phases(f"B2 staged r{rmax}{side}", run, args[0].shape[0])
    for side, (args, kwargs) in b6_inputs(dev):
        run = staged_call("env_chain_fused_batched", args, kwargs)
        print(f"time B6 staged B={args[0].shape[0]}{side} raw "
              f"{kwargs.get('raw')}: {cuda_ms(run):.4f} ms", flush=True)
        split_phases(f"B6 staged B={args[0].shape[0]}{side}", run,
                     args[0].shape[1])


def layouts():
    from ttnx_torch.kernels.env_chain import site_layout

    for R, S in ((64, 8), (64, 4), (32, 16), (32, 4), (16, 4)):
        got = _build._LIB.ttnx_env_site_smem(R, S, 4, 1)
        want = site_layout(R, S)["bytes"]
        print(f"layout R={R} S={S}: {got} B (Python twin {want})",
              flush=True)
        if got != want:
            raise RuntimeError("site_layout disagrees with the source")


@contextlib.contextmanager
def forced(route):
    """Inside the block every B2/B6 call takes ``route`` (None: as
    chosen)."""
    from ttnx_torch.kernels import env_chain

    chosen = env_chain.env_route
    if route is not None:
        env_chain.env_route = lambda *shape: route
    try:
        yield
    finally:
        env_chain.env_route = chosen


def held(name, args, kwargs, route):
    """(output, route taken, max rel err against plain, bit-identical)."""
    kernel, plain = chip_smoke.wrappers()[name]
    with forced(route):
        before = dispatch.route_counts()
        got = kernel(*args, **kwargs)
        taken = "/".join(chip_smoke.routes_of(name, before))
        again = kernel(*args, **kwargs)
    ref = plain(*args, **kwargs)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    return taken, chip_smoke.max_err(got, ref)[1], same


def cases(b2, b6):
    """(label, wrapper name, args, kwargs, new route) of every input."""
    out = []
    for rmax, calls in b2.items():
        for side, name, (args, kwargs) in calls:
            out.append((f"B2 r{rmax}{side}", name, args, kwargs, "cluster"))
    for side, (args, kwargs) in b6:
        out.append((f"B6 B={args[0].shape[0]}{side}",
                    "env_chain_fused_batched", args, kwargs, "resident"))
    return out


def check(b2, b6):
    for label, name, args, kwargs, route in cases(b2, b6):
        for r in (None, "staged"):
            taken, err, same = held(name, args, kwargs, r)
            print(f"check {label} route {taken}: max rel err against plain "
                  f"{err:.3e} (<= 1e-4), two launches bit-identical {same}",
                  flush=True)
            if r is None and (taken != route or not err <= 1e-4
                              or not same):
                raise RuntimeError(f"{label}: route {taken} is wrong")


def timings(b2, b6):
    from ttnx_torch.kernels import env_chain

    for label, name, args, kwargs, route in cases(b2, b6):
        kernel, plain = chip_smoke.wrappers()[name]
        reps = 1 if label.startswith("B6") else 10
        got = {}
        for r in (route, "staged", "staged", route):
            with forced(r):
                ms = cuda_ms(lambda: kernel(*args, **kwargs), reps)
            got.setdefault(r, []).append(ms)
            print(f"time {label} {r}: {ms:.4f} ms", flush=True)
        print(f"time {label} plain: "
              f"{cuda_ms(lambda: plain(*args, **kwargs), reps):.4f} ms",
              flush=True)
        for r in (route, "staged"):
            with forced(r):
                evs = kernel_events(lambda: kernel(*args, **kwargs))
            print(f"profile {label} {r}: {len(evs)} kernels, device "
                  f"{sum(t for _, t in evs) / 1e3:.4f} ms", flush=True)


def variant_texts():
    """``{tag: {file name: text}}`` of every VARIANTS edit."""
    out = {}
    for tag, (name, old, new) in VARIANTS.items():
        texts = {s: (_build.CSRC / s).read_text()
                 for s in ("env_chain_site.cu", name)}
        if texts[name].count(old) != 1:
            raise RuntimeError(f"variant {tag}: text not found once")
        texts[name] = texts[name].replace(old, new)
        out[tag] = texts
    return out


def variants(b2, b6, sources, everywhere=False):
    """Each library of ``sources`` ({tag: {file name: text}}) against the
    sources as they are, interleaved (now, variant, variant, now), on the
    r64 B2 chains and the B6 calls (every input with ``everywhere``)."""
    base = _build._LIB
    picked = [c for c in cases(b2, b6)
              if everywhere or c[0].startswith(("B2 r64", "B6"))]
    for tag, texts in sources.items():
        lib = compile_sources(tag, texts)
        for label, name, args, kwargs, _ in picked:
            kernel = chip_smoke.wrappers()[name][0]
            reps = 1 if label.startswith("B6") else 10
            for which, handle in (("now", base), (tag, lib), (tag, lib),
                                  ("now", base)):
                _build._LIB = handle
                ms = cuda_ms(lambda: kernel(*args, **kwargs), reps)
                print(f"variant {label} {which}: {ms:.4f} ms", flush=True)
        _build._LIB = base
        for label, name, args, kwargs, _ in picked:
            kernel = chip_smoke.wrappers()[name][0]
            now = kernel(*args, **kwargs)
            _build._LIB = lib
            _, err, same = held(name, args, kwargs, None)
            other = kernel(*args, **kwargs)
            _build._LIB = base
            torch.cuda.synchronize()
            as_now = all(torch.equal(a, b) for a, b in zip(now, other))
            print(f"variant {tag} check {label}: max rel err {err:.3e}, "
                  f"bit-identical {same}, the same bits as now {as_now}",
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--step0", action="store_true",
                    help="route staged only: times and profiles")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--parent", type=Path,
                    help="a directory with an earlier env_chain_site.cu "
                         "and env_site.cuh to time against")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    dev = torch.device("cuda", 0)
    _build._LIB = compile_sources("now", sources(opt.step0))
    if opt.step0:
        step0(dev)
        return 0
    layouts()
    b2, b6 = b2_inputs(dev), b6_inputs(dev)
    check(b2, b6)
    timings(b2, b6)
    if opt.parent:
        variants(b2, b6, {"parent": {
            s: (opt.parent / s).read_text()
            for s in ("env_chain_site.cu", "env_site.cuh")}}, True)
    if opt.variants:
        variants(b2, b6, variant_texts())
    return 0


if __name__ == "__main__":
    sys.exit(main())
