"""Design probe of kernels B4/B5 (the matrix-free local CG) on one card.

    python3 scripts/probe_torch_matfree.py [--step0]
    python3 scripts/probe_torch_matfree.py --paths
    python3 scripts/probe_torch_matfree.py --b7-parent FILE [--repeats N]

Builds ``ttnx_torch/csrc/local_cg_mf.cu`` (PR 1's kernel, route
``streamed``), ``ttnx_torch/csrc/local_cg_site.cu`` (route ``resident``),
the variants of ``VARIANTS`` (text edits of a source, one library each)
and B7's ``als_sweep_site.cu``, each alone with ``nvcc -Xptxas -v``, and
prints every kernel instantiation's registers, spill bytes and shared
memory.

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
B4/B5's route forced to ``streamed`` and as chosen, interleaved in this
one process: the CN step at r32 and r64 (ms/step) and the explicit batched
route at B = 512 (ms/call), host-timed as ``chip_smoke.py`` times them.

``--step0`` times only PR 1's kernel (the split); the other kernels are
built and checked. Needs a CUDA card with nvcc (sm_90a); imports torch,
ttnx_torch and chip_smoke only.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ttnx_torch.kernels import _build  # noqa: E402
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
    "resident, epilogue loads after the L product": (
        "local_cg_site.cu", "cg_matfree_site", [LATE_LOADS, LATE_LOADS_2]),
    "resident, no mask in the epilogue (measurement only)": (
        "local_cg_site.cu", "cg_matfree_site", [NO_EPILOGUE_MASK]),
    "B7 site kernel": ("als_sweep_site.cu", None, []),
}
MEASUREMENT_ONLY = ("measurement only",)


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
    operands (x0 None: cold)."""
    fn = getattr(lib, f"ttnx_{entry}_f32")
    fn.argtypes, fn.restype = ARGS, ctypes.c_int
    B, R, RA, _ = L.shape
    n = rhs.shape[2]
    V = R * n * R
    per = 3 * V if entry == "cg_matfree_site" else 3 * V + 2 * RA * V
    scratch = torch.empty(B * per, device=L.device)
    out = torch.empty_like(rhs)
    x0c = rhs if x0 is None else x0

    def run(iters=ITERS):
        err = fn(L.data_ptr(), Ac.data_ptr(), Renv.data_ptr(), rhs.data_ptr(),
                 mask.data_ptr(), x0c.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), B, R, RA, n, iters, int(x0 is not None),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{entry}: CUDA error {err}")
        return out
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
    calls) through the kernels, with B4/B5's route forced to "streamed"
    (a measurement-only patch of ``matfree_route``) and as chosen
    ("resident"), interleaved: streamed, resident, resident, streamed."""
    from ttnx_torch.entry import batched_als_problem
    from ttnx_torch.kernels import local_cg_mf
    from ttnx_torch.solvers.als_scan_batched import als_sweeps_b

    chosen = local_cg_mf.matfree_route
    cases = []
    for rmax in (32, 64):
        step_fn, us, _ = chip_smoke.setup(rmax, dev)
        cases.append((f"cn_step d={chip_smoke.D} r{rmax} ms/step",
                      local_cg_mf.cg_matfree_fused,
                      lambda f=step_fn, u=us: chip_smoke.timed_chain(f, u)[0]))
    p = batched_als_problem(dev, batch=chip_smoke.BATCH, rmax=64,
                            d=chip_smoke.D, h=chip_smoke.H_STEP)
    cases.append((f"explicit_kernel B={chip_smoke.BATCH} ms/call",
                  local_cg_mf.cg_matfree_fused_batched,
                  lambda: 1e3 * chip_smoke.timed_calls(lambda: als_sweeps_b(
                      p["lhs_stack"], p["b_batch"], p["x_batch"], p["masks"],
                      2, cg_iters=ITERS, solver="cg_fused"))[0]))
    try:
        for label, wrapper, fn in cases:
            for route in ("streamed", "resident", "resident", "streamed"):
                local_cg_mf.matfree_route = chosen if route == "resident" \
                    else (lambda *shape: "streamed")
                ms = fn()
                assert wrapper.route == route
                print(f"path {label} B4/B5 route {route}: {ms:.3f}",
                      flush=True)
    finally:
        local_cg_mf.matfree_route = chosen


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
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
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
    for label, args in inputs(dev).items():
        B = args[0].shape[0]
        reps = 1 if B > 64 else 5
        runs = {n: launcher(libs[n][0], VARIANTS[n][1], *args)
                for n in names}
        ref = cg_matfree_batched_plain(*args[:5], x0=args[5], iters=ITERS)
        for n in names:
            got = runs[n]()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max() / ref.abs().max())
            gate = not n.endswith(MEASUREMENT_ONLY)
            print(f"check {n} {label}: max rel err against plain {err:.3e}"
                  f"{' (<= 1e-4)' if gate else ''}", flush=True)
            if gate and not err <= 1e-4:
                raise RuntimeError(f"{n} is wrong on {label}")
        for n in names:
            if not opt.step0 or n == "streamed (PR 1)":
                split(n, runs[n], label, reps)
        if opt.step0:
            continue
        order = names + names[::-1]
        for n in order:
            ms = cuda_ms(runs[n], reps)
            print(f"time {label} {n}: {ms:.4f} ms", flush=True)
        plain = cuda_ms(lambda: cg_matfree_batched_plain(
            *args[:5], x0=args[5], iters=ITERS), reps)
        print(f"time {label} plain: {plain:.4f} ms", flush=True)
    if not opt.step0:
        paths(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
