"""Design probe of kernels B4/B5 (the matrix-free local CG) on one card.

    python3 scripts/probe_torch_matfree.py [--step0]
    python3 scripts/probe_torch_matfree.py --paths
    python3 scripts/probe_torch_matfree.py --b7-parent FILE [--repeats N]
    python3 scripts/probe_torch_matfree.py --floor [--seed N]
    python3 scripts/probe_torch_matfree.py --ptx-parent DIR

Builds ``ttnx_torch/csrc/local_cg_mf.cu`` (PR 1's kernel, route
``streamed``), ``ttnx_torch/csrc/local_cg_site.cu`` (route ``resident``),
``ttnx_torch/csrc/local_cg_cluster.cu`` (B4's route ``cluster``, one
problem), the variants of ``VARIANTS`` (text edits of a source, one library each)
and B7's ``als_sweep_site.cu``, each alone with ``nvcc -Xptxas -v``, and
prints every kernel instantiation's registers, spill bytes and shared
memory.

``--ptx-parent DIR`` only compares B5's kernel (``local_cg_site.cu``) and
B7's site kernel (``als_sweep_site.cu``) with those of DIR (an earlier
checkout's ``ttnx_torch/csrc``): their sources with every header byte for
byte, and the digests of three PTX compiles of each side (nvcc numbers
B7's virtual registers differently from compile to compile of one
source): a change elsewhere must leave them identical.

``--b7-parent FILE`` only compares B7's code with an earlier
``als_sweep_site.cu``: whether the two sources give the same PTX (the
front end's output, before ptxas assigns registers), then, building each
N times (``--repeats``, 3) under the production file name, the digest of
each build's SASS instructions, function by function. ptxas does not
assign registers the same way in every compile of one source, so SASS
digests differ between builds of either source.

Inputs, as ``chip_smoke.py`` records them (the MIDDLE_SITE-th local solve,
f32, 16 warm CG iterations): B4's of the d = 12 CN step at r64 and r32
(B = 1), B5's of one ``als_sweeps_b`` call at R = 64 on 8 distinct
problems (phase 3b) and on phase 5's B = 512 problem. On each:

* every kernel against the plain version (max rel err, held to 1e-4 but
  for the measurement-only variant, which is only printed);
* step 0, the split of each kernel by its own ``iters`` in {0, 16, 32},
  warm: (t32 - t0) / 32 is the time of a CG iteration (an apply and the
  vector updates), the rest of t16 the fixed cost (staging, the warm
  start's apply, the final mask);
* (without ``--step0``) PR 1's kernel, the resident kernel, its variants
  and the plain version timed interleaved (streamed, resident, variants,
  then the reverse) in this one process: CUDA events, median of 3 samples
  of 5 calls each (1 at B = 512).

Then (and alone with ``--paths``) the paths the kernels serve, with
B4/B5's route as chosen and forced to the route before it (B4
``resident``, B5 ``streamed``), interleaved in this one process: the CN
step at r32 and r64 (ms/step) and the explicit batched route at B = 512
(ms/call), host-timed as ``chip_smoke.py`` times them.

``--floor`` only bounds what a faster B4 can give the benchmark's two CN
cells (``heat_cn_d12_r64.stream``, ``heat2d_cn_d20_r64.stream2d``), each
set up by its own driver from ``--seed``'s draws: ms/step (host clock,
``FLOOR_STEPS`` steps ended by a synchronize) with B4 as chosen and with
B4 replaced by a stub that returns its warm start (a B4 that costs
nothing: the floor of the step), interleaved: as chosen, stub, stub, as
chosen. Then the host's issue time of one ALS site, untraced: one
``als_sweeps`` call of the step (B4 as chosen) issued behind a
``torch.cuda._sleep`` that holds the card, so that no launch waits for
the device; the host's time from one local solve's start to the next is
the time it takes to issue a site. An interval as long as the sleep
means that the host waited for the card there (a synchronize, or a full
launch queue).

``--step0`` times only PR 1's kernel (the split); the other kernels are
built and checked. Needs a CUDA card with nvcc (sm_90a); imports torch,
ttnx_torch and chip_smoke only.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ttnx_torch.kernels import _build, dispatch  # noqa: E402
from ttnx_torch.kernels.local_cg_mf import cg_matfree_batched_plain  # noqa

WORK = ROOT / "build" / "probe_matfree"
P, I = ctypes.c_void_p, ctypes.c_int
ARGS = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
ITERS = 16

# the epilogue's loads issued after the L product (the first version)
LATE_LOADS = ('''        // issued before the product, whose time hides their L2 latency
        const int o = own + sl * CS;
        const float4 mk = ld4(mask + o), vv = ld4(v + o);
        float acc[8][4] = {};''',
              '''        float acc[8][4] = {};''')
LATE_LOADS_2 = ('''        reduce_scatter<8, 8>(acc, g);
        const float4 out''', '''        reduce_scatter<8, 8>(acc, g);
        const int o = own + sl * CS;
        const float4 mk = ld4(mask + o), vv = ld4(v + o);
        const float4 out''')
# measurement only: the epilogue without the mask (wrong on a general
# mask; on the solvers' inputs the apply's output lies inside the mask)
NO_EPILOGUE_MASK = ("const float4 mk = ld4(mask + o), vv = ld4(v + o);",
                    "const float4 mk = make_float4(1.f, 1.f, 1.f, 1.f), "
                    "vv = ld4(v + o);")
# variant name -> (source, entry, [(old text, new text), ...]); the edits
# must match the source exactly or the probe stops
VARIANTS = {
    "streamed (PR 1)": ("local_cg_mf.cu", "cg_matfree_batched", []),
    "resident": ("local_cg_site.cu", "cg_matfree_site", []),
    "cluster": ("local_cg_cluster.cu", "cg_matfree_cluster", []),
    "resident, epilogue loads after the L product": (
        "local_cg_site.cu", "cg_matfree_site", [LATE_LOADS, LATE_LOADS_2]),
    "resident, no mask in the epilogue (measurement only)": (
        "local_cg_site.cu", "cg_matfree_site", [NO_EPILOGUE_MASK]),
    "B7 site kernel": ("als_sweep_site.cu", None, []),
}
MEASUREMENT_ONLY = ("measurement only",)
CN_CELLS = ("heat_cn_d12_r64.stream", "heat2d_cn_d20_r64.stream2d")
FLOOR_STEPS = 32
SLEEP_CYCLES = 2 * 10 ** 9  # about one second of a 1.98 GHz card


def _source(name):
    src, _, edits = VARIANTS[name]
    text = (_build.CSRC / src).read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{src} changed: {old[:50]!r}")
        text = text.replace(old, new)
    return text


def build(sources):
    """Compile {name: source text} each into its own library; returns {name:
    (CDLL, path)} and prints the ptxas lines of every instantiation."""
    WORK.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = WORK / f"v{i}.cu"
        cu.write_text(text)
        so = WORK / f"v{i}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(_build.CSRC), "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed for {name}:\n{err[-6000:]}", flush=True)
            continue
        lines = (out + err).splitlines()
        for k, ln in enumerate(lines):
            if "Compiling entry" in ln:
                kern = ln.split("'")[1]
                info = " | ".join(
                    x.split(":")[-1].strip() for x in lines[k + 1:k + 5]
                    if "registers" in x or "spill" in x)
                print(f"ptxas {name}: {kern[:60]} | {info}", flush=True)
        libs[name] = (ctypes.CDLL(str(so)), so)
    return libs


def sass_functions(so):
    """{function name: its SASS instruction lines} of a library."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for ln in sass.splitlines():
        ln = ln.strip()
        if ln.startswith("Function : "):
            name = ln.split(":", 1)[1].strip()
            funcs[name] = []
        elif name and ln.startswith("/*") and "*/" in ln:
            funcs[name].append(ln)
    return funcs


def ptx_lines(text, where):
    """The PTX of a source (comment lines dropped), compiled as
    ``where/als_sweep_site.cu``."""
    where.mkdir(parents=True, exist_ok=True)
    (where / "als_sweep_site.cu").write_text(text)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-ptx", "-o", str(where / "k.ptx"),
                    str(where / "als_sweep_site.cu")], check=True)
    return [ln for ln in (where / "k.ptx").read_text().splitlines()
            if not ln.lstrip().startswith("//")]


def ptx_builds(src_dir, name, where, repeats):
    """Started compiles of ``src_dir/name`` to PTX, each in its own
    directory ``where<i>`` beside copies of ``src_dir``'s headers."""
    procs = []
    for i in range(repeats):
        d = Path(f"{where}{i}")
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in [*src_dir.glob("*.cuh"), src_dir / name]:
            shutil.copy(f, d / f.name)
        procs.append((d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-ptx", "-o",
             str(d / "k.ptx"), str(d / name)])))
    return procs


def ptx_digests(procs):
    """The digest of each finished compile's PTX, comment lines dropped."""
    out = []
    for d, proc in procs:
        if proc.wait():
            raise RuntimeError(f"nvcc -ptx failed in {d}")
        text = "\n".join(ln for ln in (d / "k.ptx").read_text().splitlines()
                         if not ln.lstrip().startswith("//"))
        out.append(hashlib.sha256(text.encode()).hexdigest()[:12])
    return out


def ptx_check(parent, repeats=3):
    """B5's and B7's sources (with every header) and PTX here against
    those in ``parent``: ``repeats`` compiles of each side, all at once,
    in directories of one path length. nvcc's PTX of B7's site kernel is
    not the same in every compile of one source (its virtual registers
    are numbered differently), so a side's digests are a set."""
    same = True
    for label, name in (("B5 cg_site_kernel", "local_cg_site.cu"),
                        ("B7 site kernel", "als_sweep_site.cu")):
        files = sorted(f.name for f in [*_build.CSRC.glob("*.cuh"),
                                        _build.CSRC / name])
        src_same = all((_build.CSRC / f).read_bytes()
                       == (parent / f).read_bytes() for f in files)
        runs = {who: ptx_builds(d, name, WORK / f"ptx_{who}_", repeats)
                for who, d in (("c", _build.CSRC), ("p", parent))}
        got = {who: ptx_digests(procs) for who, procs in runs.items()}
        overlap = bool(set(got["c"]) & set(got["p"]))
        same &= src_same and overlap
        print(f"PTX {label} ({name}): source and headers byte-identical "
              f"{src_same}; PTX digests current {got['c']}, parent "
              f"{got['p']}: {'a shared PTX' if overlap else 'DIFFERENT'}",
              flush=True)
    return same


def sass_check(parent, repeats):
    """Compare B7's current source with ``parent``: their PTX, then the
    per-function SASS digests of ``repeats`` parallel builds of each as
    ``als_sweep_site.cu``, and whether the current ones fall among the
    parent's."""
    current = (_build.CSRC / "als_sweep_site.cu").read_text()
    pc, pp = (ptx_lines(t, WORK / f"ptx_{who}") for who, t in
              (("current", current), ("parent", parent.read_text())))
    print(f"B7 PTX: {len(pc)} / {len(pp)} lines (current / parent): "
          f"{'identical' if pc == pp else 'DIFFERENT'}", flush=True)
    procs = []
    for i in range(repeats):
        for who, text in (("current", current),
                          ("parent", parent.read_text())):
            d = WORK / f"sass_{who}_{i}"
            d.mkdir(parents=True, exist_ok=True)
            (d / "als_sweep_site.cu").write_text(text)
            procs.append((who, d / "lib.so", subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                 "-shared", "-o", str(d / "lib.so"),
                 str(d / "als_sweep_site.cu")])))
    seen = {"current": {}, "parent": {}}
    for who, so, proc in procs:
        if proc.wait():
            raise RuntimeError(f"nvcc failed for B7 {who}")
        for name, code in sass_functions(so).items():
            digest = hashlib.sha256("\n".join(code).encode()).hexdigest()
            seen[who].setdefault(name, []).append(digest[:12])
    for name in sorted(seen["parent"]):
        cur, par = seen["current"].get(name, []), seen["parent"][name]
        among = "" if set(cur) <= set(par) else "NOT "
        print(f"B7 SASS {name[:60]}: current {cur}, parent {par}: "
              f"{among}among the parent builds", flush=True)


def launcher(lib, entry, L, Ac, Renv, rhs, mask, x0):
    """A function (iters) -> x launching ``entry`` of ``lib`` on batched
    operands (x0 None: cold); the cluster entry takes one problem (B = 1)
    and no scratch."""
    fn = getattr(lib, f"ttnx_{entry}_f32")
    cluster = entry == "cg_matfree_cluster"
    fn.argtypes = [P] * 7 + [I] * 5 + [P] if cluster else ARGS
    fn.restype = ctypes.c_int
    B, R, RA, _ = L.shape
    n = rhs.shape[2]
    V = R * n * R
    per = 3 * V if entry == "cg_matfree_site" else 3 * V + 2 * RA * V
    scratch = torch.empty(B * per, device=L.device)
    out = torch.empty_like(rhs)
    x0c = rhs if x0 is None else x0
    ptrs = [L.data_ptr(), Ac.data_ptr(), Renv.data_ptr(), rhs.data_ptr(),
            mask.data_ptr(), x0c.data_ptr(), out.data_ptr()]
    sizes = [] if cluster else [scratch.data_ptr(), B]

    def run(iters=ITERS):
        err = fn(*ptrs, *sizes, R, RA, n, iters, int(x0 is not None),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{entry}: CUDA error {err}")
        return out
    run.keep = (scratch, x0c)  # alive as long as the launcher
    return run


def cuda_ms(fn, reps) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def inputs(dev):
    """{label: (L, Ac, Renv, rhs, mask, x0)} batched, contiguous."""
    out = {}
    for rmax in (64, 32):
        args, kw = chip_smoke.capture_inputs(rmax, dev, torch.float32)[
            "cg_matfree_fused"]
        assert kw["iters"] == ITERS
        L, Ac, Renv, rhs, mask = args
        out[f"B4 r{rmax} B=1"] = (L[None], Ac, Renv[None], rhs[None], mask,
                                  kw["x0"][None])
    from ttnx_torch.solvers.als_scan_batched import als_sweeps_b

    p, b, x = chip_smoke.distinct_batch(dev, torch.float32, 64)
    seen = chip_smoke.record_calls(lambda: als_sweeps_b(
        p["lhs_stack"], b, x, p["masks"], 2, cg_iters=ITERS,
        solver="cg_fused"))
    args, kw = seen["cg_matfree_fused_batched"][chip_smoke.MIDDLE_SITE]
    out[f"B5 r64 B={chip_smoke.BATCH_CHECK}"] = (*args, kw["x0"])
    args, kw = chip_smoke.bench_batch_calls(dev)[
        "cg_matfree_fused_batched"][chip_smoke.MIDDLE_SITE]
    out[f"B5 r64 B={chip_smoke.BATCH}"] = (*args, kw["x0"])
    return {k: tuple(t.contiguous() for t in v) for k, v in out.items()}


def split(name, run, label, reps):
    t = {it: cuda_ms(lambda: run(it), reps) for it in (0, 16, 32)}
    per_it = (t[32] - t[0]) / 32
    fixed = t[16] - 16 * per_it
    print(f"split {name} {label}: iters 0 / 16 / 32: {t[0]:.4f} / "
          f"{t[16]:.4f} / {t[32]:.4f} ms; {per_it:.5f} ms a CG iteration "
          f"(x 16 = {16 * per_it:.4f} ms, {16 * per_it / t[16]:.1%}), "
          f"fixed {fixed:.4f} ms ({fixed / t[16]:.1%})", flush=True)


def paths(dev):
    """The CN step at r32 and r64 (ms/step: median of 3 chains of 8 steps)
    and the explicit batched route at B = BATCH (ms/call: median of 3
    calls) through the kernels, with B4/B5's route as chosen ("cluster" for
    B4, "resident" for B5) and forced to the route before it ("resident"
    for B4, "streamed" for B5: a measurement-only patch of
    ``matfree_route``), interleaved: before, chosen, chosen, before."""
    from ttnx_torch.entry import batched_als_problem
    from ttnx_torch.kernels import local_cg_mf
    from ttnx_torch.solvers.als_scan_batched import als_sweeps_b

    chosen = local_cg_mf.matfree_route
    cases = []
    for rmax in (32, 64):
        step_fn, us, _ = chip_smoke.setup(rmax, dev)
        cases.append((f"cn_step d={chip_smoke.D} r{rmax} ms/step",
                      local_cg_mf.cg_matfree_fused, "resident", "cluster",
                      lambda f=step_fn, u=us: chip_smoke.timed_chain(f, u)[0]))
    p = batched_als_problem(dev, batch=chip_smoke.BATCH, rmax=64,
                            d=chip_smoke.D, h=chip_smoke.H_STEP)
    cases.append((f"explicit_kernel B={chip_smoke.BATCH} ms/call",
                  local_cg_mf.cg_matfree_fused_batched, "streamed",
                  "resident",
                  lambda: 1e3 * chip_smoke.timed_calls(lambda: als_sweeps_b(
                      p["lhs_stack"], p["b_batch"], p["x_batch"], p["masks"],
                      2, cg_iters=ITERS, solver="cg_fused"))[0]))
    try:
        for label, wrapper, before, route_now, fn in cases:
            for route in (before, route_now, route_now, before):
                local_cg_mf.matfree_route = chosen if route == route_now \
                    else (lambda *shape, r=before, **kw: r)
                before = dispatch.route_counts()
                ms = fn()
                assert set(chip_smoke.routes_of(wrapper.__name__,
                                                before)) == {route}
                print(f"path {label} B4/B5 route {route}: {ms:.3f}",
                      flush=True)
    finally:
        local_cg_mf.matfree_route = chosen


def cell_session(name, seed, dev):
    """Cell ``name``'s driver session on ``seed``'s draws, warmed up."""
    from portbench.core.catalog import Catalog
    from portbench.core.traffic import draw

    cat = Catalog()
    cell = cat.cell(name)
    traffic = cat.data("traffic", cell["traffic"])
    session = cat.module("drivers", cell["config"]).setup(
        cat.data("configs", cell["config"]), traffic, draw(traffic, seed),
        dev)
    session.warmup()
    torch.cuda.synchronize()
    return session


def warm_start(L, Ac, Renv, rhs, mask, *, x0=None, iters=32):
    """B4 that costs nothing (measurement only): its warm start."""
    return torch.zeros_like(rhs) if x0 is None else x0


def step_ms(session, first, steps=FLOOR_STEPS):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(first, first + steps):
        session.run(i, False)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def host_issue(session, step):
    """Host ms between consecutive local solves of one ``als_sweeps`` call
    of the CN step, issued behind a sleep that holds the card; returns the
    intervals, the host's ms for the call and the sleep's ms alone."""
    from ttnx_torch.solvers import als_scan, round_scan

    seen, stamps = [], []
    real_sweeps, real_solve = round_scan.als_sweeps, als_scan._local_solve_padded
    round_scan.als_sweeps = lambda *a, **k: (seen.append((a, k)),
                                             real_sweeps(*a, **k))[1]
    try:
        session.run(step, False)
    finally:
        round_scan.als_sweeps = real_sweeps
    args, kw = seen[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(SLEEP_CYCLES)
    torch.cuda.synchronize()
    sleep = 1e3 * (time.perf_counter() - t0)
    als_scan._local_solve_padded = lambda *a, **k: (
        stamps.append(time.perf_counter()), real_solve(*a, **k))[1]
    try:
        for held in (False, True):  # the first call warms the host path
            torch.cuda.synchronize()
            stamps.clear()
            if held:
                torch.cuda._sleep(SLEEP_CYCLES)
            t0 = time.perf_counter()
            als_scan.als_sweeps(*args, **kw)
            host = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
    finally:
        als_scan._local_solve_padded = real_solve
    gaps = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    return gaps, host, sleep


def floor(dev, seed):
    """Step 0 of a faster B4: the CN cells' step with B4 as chosen and with
    B4 stubbed to its warm start, and the host's issue time of a site."""
    from ttnx_torch.kernels.local_cg_mf import cg_matfree_fused
    from ttnx_torch.solvers import als_scan

    for name in CN_CELLS:
        t0 = time.perf_counter()
        session = cell_session(name, seed, dev)
        print(f"floor {name}: set-up {time.perf_counter() - t0:.1f} s",
              flush=True)
        first, got = 0, {"chosen": [], "stub": []}
        before = dispatch.route_counts()
        for kind in ("chosen", "stub", "stub", "chosen"):
            als_scan.cg_matfree_fused = cg_matfree_fused if kind == \
                "chosen" else warm_start
            try:
                step_ms(session, first, 4)  # a new trajectory, warm
                got[kind].append(step_ms(session, first + 4))
            finally:
                als_scan.cg_matfree_fused = cg_matfree_fused
            first += FLOOR_STEPS + 4
            print(f"floor {name} B4 {kind}: {got[kind][-1]:.3f} ms/step",
                  flush=True)
        ratio = statistics.mean(got["stub"]) / statistics.mean(got["chosen"])
        print(f"floor {name}: stub / chosen {ratio:.3f} (B4 routes "
              f"{chip_smoke.routes_of('cg_matfree_fused', before)})",
              flush=True)
        gaps, host, sleep = host_issue(session, first)
        inner = sorted(gaps)
        print(f"host issue {name}: {len(gaps) + 1} local solves issued in "
              f"{host:.2f} ms behind a {sleep:.1f} ms sleep; ms between "
              f"solves: median {statistics.median(inner):.3f}, min "
              f"{inner[0]:.3f}, max {inner[-1]:.3f}; first "
              f"{[round(g, 3) for g in gaps[:6]]}", flush=True)
        session.close()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--step0", action="store_true",
                    help="time PR 1's kernel only (the split)")
    ap.add_argument("--b7-parent", type=Path, metavar="FILE",
                    help="only compare B7's SASS with this earlier source")
    ap.add_argument("--repeats", type=int, default=3,
                    help="builds of each B7 source for --b7-parent")
    ap.add_argument("--paths", action="store_true",
                    help="only the CN and explicit paths by B4/B5 route")
    ap.add_argument("--ptx-parent", type=Path, metavar="DIR",
                    help="only compare B5's and B7's PTX with an earlier "
                         "csrc directory")
    ap.add_argument("--floor", action="store_true",
                    help="only the CN cells' step with B4 stubbed, and the "
                         "host's issue time of an ALS site")
    ap.add_argument("--seed", type=int, default=3141592653,
                    help="the cells' draws for --floor")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    if opt.ptx_parent:
        return 0 if ptx_check(opt.ptx_parent) else 1
    if opt.floor:
        floor(dev, opt.seed)
        return 0
    if opt.paths:
        paths(dev)
        return 0
    if opt.b7_parent:
        sass_check(opt.b7_parent, opt.repeats)
        return 0
    sources = {name: _source(name) for name in VARIANTS}
    libs = build(sources)
    names = [n for n, (_, entry, _) in VARIANTS.items()
             if entry and n in libs]
    wrong = []
    for label, args in inputs(dev).items():
        B = args[0].shape[0]
        reps = 1 if B > 64 else 5
        runs = {n: launcher(libs[n][0], VARIANTS[n][1], *args)
                for n in names
                if B == 1 or VARIANTS[n][1] != "cg_matfree_cluster"}
        ref = cg_matfree_batched_plain(*args[:5], x0=args[5], iters=ITERS)
        for n in runs:
            got = runs[n]().clone()
            again = runs[n]()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max() / ref.abs().max())
            gate = not n.endswith(MEASUREMENT_ONLY)
            print(f"check {n} {label}: max rel err against plain {err:.3e}"
                  f"{' (<= 1e-4)' if gate else ''}; two launches "
                  f"bit-identical {torch.equal(got, again)}", flush=True)
            if gate and not err <= 1e-4:
                wrong.append(f"{n} on {label}")
        for n in runs:
            if not opt.step0 or n == "streamed (PR 1)":
                split(n, runs[n], label, reps)
        if opt.step0:
            continue
        order = list(runs) + list(runs)[::-1]
        for n in order:
            ms = cuda_ms(runs[n], reps)
            print(f"time {label} {n}: {ms:.4f} ms", flush=True)
        plain = cuda_ms(lambda: cg_matfree_batched_plain(
            *args[:5], x0=args[5], iters=ITERS), reps)
        print(f"time {label} plain: {plain:.4f} ms", flush=True)
    if wrong:
        raise RuntimeError(f"wrong against plain: {wrong}")
    if not opt.step0:
        paths(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
