"""Design probe of kernel B7 (the fused batched ALS sweep pair) on one card.

    python3 scripts/probe_torch_sweep.py [--step0] [--quick]
    python3 scripts/probe_torch_sweep.py --spills [VARIANT ...]

Builds ``ttnx_torch/csrc/als_sweep_fused.cu`` (PR 2's kernel) and
``ttnx_torch/csrc/als_sweep_site.cu`` (the site-resident kernel) alone,
each into its own shared library with ``nvcc -Xptxas -v``, plus the
variants of ``VARIANTS`` (text edits of a source, one library each), and
prints every kernel instantiation's registers, spill bytes and shared
memory. Then, on the bench's batched heat problem (d = 12, rmax = 64, RA =
4, f32; ``entry.batched_als_problem``) at B = 8 and B = 512:

* the split of PR 2's kernel by its own arguments: ``cg_iters`` in {0,
  24, 48} at ``ns_iters = (24, 8)``, and ``ns_iters = (48, 16)`` at 24 CG
  iterations. The differences give ms per CG apply (over the 22 site
  solves) and ms per Newton-Schulz iteration (over the 22 gauges);
  the remainder is env updates, rhs builds, warm starts and folds;
* (without ``--step0``) the same split of the site kernel, then each
  kernel against the plain version on distinct flat-spectrum problems at
  B = 8, R = 64 and 32 (max rel err), and PR 2's kernel, the site kernel, its variants
  and the plain version timed interleaved (parent, new, new, parent) in
  this one process: CUDA events, one call a sample, median of 3.

``--quick`` keeps B = 8 and skips the split; ``--spills`` only compiles
the named variants with ``-lineinfo`` and prints the source line of every
local-memory load and store (LDL/STL) in their SASS. The site kernel's
variants are the design alternatives measured for it: k loops unrolled by
2, and the (R, R) products in 4 x 4 tiles with k split over 2 lanes (both
faster by 1-4 %, neither free of spills at 128 registers).

Needs a CUDA card with nvcc (sm_90a); imports torch and ttnx_torch only.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ttnx_torch.entry import (batched_als_problem,  # noqa: E402
                              flat_spectrum_stack)
from ttnx_torch.kernels import _build  # noqa: E402
from ttnx_torch.kernels.als_sweep_fused import als_fwd_bwd_plain  # noqa: E402

WORK = Path(__file__).resolve().parents[1] / "build" / "probe_sweep"
P, I = ctypes.c_void_p, ctypes.c_int
ARGS = [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P]
NS_ITERS = (24, 8)

# variant name -> (source, [(old text, new text), ...]); the edits must
# match the source exactly or the probe stops
UNROLL_GEMM = ("#pragma unroll 1\n  for (int k = 4 * g; k < K;",
               "#pragma unroll 2\n  for (int k = 4 * g; k < K;")
UNROLL_STEP1 = ("#pragma unroll 1\n    for (int k = 4 * kh; k < R;",
                "#pragma unroll 2\n    for (int k = 4 * kh; k < R;")
NS_TILES = ("gemm<R, R, R, 8, 4, false, false>",
            "gemm<R, R, R, 4, 2, false, false>")
NS_ONLY = ("      gemm<R, R, R, 8, 4, false, false>(",
           "      gemm<R, R, R, 4, 2, false, false>(")
VARIANTS = {
    "PR 2 kernel": ("als_sweep_fused.cu", []),
    "site kernel": ("als_sweep_site.cu", []),
    "site kernel, k loops unrolled 2": ("als_sweep_site.cu",
                                        [UNROLL_GEMM, UNROLL_STEP1]),
    "site kernel, first product k loop unrolled 2": ("als_sweep_site.cu",
                                                     [UNROLL_STEP1]),
    "site kernel, (R, R) products in 4 x 4 tiles, k split 2": (
        "als_sweep_site.cu", [NS_TILES]),
    "site kernel, Newton-Schulz products in 4 x 4 tiles, k split 2": (
        "als_sweep_site.cu", [NS_ONLY]),
}


def build(names):
    """Compile each named variant into its own library; returns {name:
    CDLL} and prints the ptxas lines of every kernel instantiation."""
    WORK.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(names):
        src, edits = VARIANTS[name]
        text = (_build.CSRC / src).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{src} changed: {old[:50]!r}")
            text = text.replace(old, new)
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
        libs[name] = ctypes.CDLL(str(so))
    return libs


def where_spills(name):
    """Print the source lines of the local-memory loads and stores
    (LDL/STL) in the SASS of one variant (built with -lineinfo)."""
    src, edits = VARIANTS[name]
    text = (_build.CSRC / src).read_text()
    for old, new in edits:
        text = text.replace(old, new)
    cu, cubin = WORK / "spills.cu", WORK / "spills.cubin"
    WORK.mkdir(parents=True, exist_ok=True)
    cu.write_text(text)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-lineinfo", "-I",
                    str(_build.CSRC), "-cubin", "-o", str(cubin), str(cu)],
                   check=True)
    nvdisasm = Path(_build._nvcc()).with_name("nvdisasm")
    sass = subprocess.run([str(nvdisasm), "--print-line-info", str(cubin)],
                          capture_output=True, text=True,
                          check=True).stdout.splitlines()
    src_lines = text.splitlines()
    where, kernel, seen = "", "", {}
    for ln in sass:
        if ".text._Z" in ln and ln.rstrip().endswith(":"):
            kernel = ln.strip()[:60]
        if "line" in ln and "//##" in ln:
            where = ln.split(", line ")[1].split()[0].strip(",")
        elif " STL" in ln or " LDL" in ln:
            op = "STL" if " STL" in ln else "LDL"
            key = (kernel, where, op)
            seen[key] = seen.get(key, 0) + 1
    for (kernel, where, op), count in sorted(seen.items()):
        line = src_lines[int(where) - 1].strip() if where.isdigit() else "?"
        print(f"spills {kernel} line {where}: {count} {op} | {line[:70]}",
              flush=True)


def launcher(lib, entry, scratch_query, A, b, x, masks):
    """A function (cg_iters, ns_iters, cg_refine, cg_polish) -> out that
    launches ``entry`` of ``lib`` on the given problem."""
    fn = getattr(lib, f"ttnx_{entry}_f32")
    fn.argtypes, fn.restype = ARGS, ctypes.c_int
    q = getattr(lib, f"ttnx_{scratch_query}")
    q.argtypes, q.restype = [I, I, I, I], ctypes.c_longlong
    B, d, R, n, _ = x.shape
    RA = A.shape[1]
    scratch = torch.empty(B * int(q(d, R, RA, n)), device=x.device)
    out = torch.empty_like(x)

    def run(cg_iters=24, ns=NS_ITERS, refine=0, polish=0):
        err = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), masks.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), B, d, R, RA, n, cg_iters,
                 refine, polish, ns[0], ns[1],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{entry}: CUDA error {err}")
        return out
    return run


def cuda_ms(fn, repeats=3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def split(name, run, B, d):
    """Step 0: ms per CG apply and per NS iteration from the kernel's own
    arguments."""
    t = {(cg, ns): cuda_ms(lambda: run(cg, ns))
         for cg, ns in ((0, NS_ITERS), (24, NS_ITERS), (48, NS_ITERS),
                        (24, (48, 16)))}
    solves = 2 * (d - 1)
    per_apply = (t[48, NS_ITERS] - t[0, NS_ITERS]) / 48 / solves
    per_ns = (t[24, (48, 16)] - t[24, NS_ITERS]) / 32 / solves
    base = t[24, NS_ITERS]
    cg_part = 25 * solves * per_apply
    ns_part = 32 * solves * per_ns
    for (cg, ns), ms in t.items():
        print(f"split {name} B={B}: cg_iters {cg:2d} ns_iters {ns}: "
              f"{ms:.3f} ms", flush=True)
    print(f"split {name} B={B}: {per_apply:.4f} ms a CG apply (x {25 * solves}"
          f" = {cg_part:.2f} ms, {cg_part / base:.1%}), {per_ns:.4f} ms a NS "
          f"iteration (x {32 * solves} = {ns_part:.2f} ms, "
          f"{ns_part / base:.1%}), rest {base - cg_part - ns_part:.2f} ms "
          f"({(base - cg_part - ns_part) / base:.1%}) of {base:.3f} ms",
          flush=True)


def flat_problem(dev, B, R=64, d=12):
    p = batched_als_problem(dev, batch=1, rmax=R, d=d)
    p = {k: v.contiguous() if torch.is_tensor(v) else v for k, v in p.items()}
    rng = np.random.default_rng(100 + R)
    b = np.stack([flat_spectrum_stack(rng, p["u_rks"], R) for _ in range(B)])
    x = b + 0.3 * np.stack([flat_spectrum_stack(rng, p["u_rks"], R)
                            for _ in range(B)])
    return (p["lhs_stack"], *(torch.as_tensor(a, dtype=torch.float32,
                                              device=dev) for a in (b, x)),
            p["masks"])


ROUTES = {"PR 2 kernel": ("als_sweep_pair", "als_sweep_pair_scratch"),
          "site kernel": ("als_sweep_site", "als_sweep_site_scratch")}


def entry_of(name):
    return ROUTES["PR 2 kernel" if VARIANTS[name][0] == "als_sweep_fused.cu"
                  else "site kernel"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--step0", action="store_true",
                    help="PR 2's kernel only: ptxas and the split")
    ap.add_argument("--quick", action="store_true",
                    help="B = 8 only, no split")
    ap.add_argument("--spills", nargs="*", metavar="VARIANT",
                    help="print where these variants spill, then stop")
    opt = ap.parse_args()
    if opt.spills is not None:
        for name in opt.spills or ["site kernel"]:
            where_spills(name)
        return 0
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(["PR 2 kernel"] if opt.step0 else list(VARIANTS))
    names = list(libs)
    dev = torch.device("cuda", 0)
    batches = (8,) if opt.quick else (8, 512)
    for B in batches:
        p = batched_als_problem(dev, batch=B, rmax=64, d=12)
        args = tuple(p[k].contiguous() for k in ("lhs_stack", "b_batch",
                                                 "x_batch", "masks"))
        runs = {name: launcher(libs[name], *entry_of(name), *args)
                for name in names}
        if not opt.quick and "PR 2 kernel" in runs:
            split("PR 2 kernel", runs["PR 2 kernel"], B, 12)
        if opt.step0:
            continue
        # every variant against the plain version on distinct problems
        if B == 8:
            for R in (64, 32):
                fargs = flat_problem(dev, B, R)
                ref = als_fwd_bwd_plain(*fargs)
                for name in names:
                    got = launcher(libs[name], *entry_of(name), *fargs)()
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max() / ref.abs().max())
                    print(f"check {name} B={B} R={R}: max rel err against "
                          f"plain {err:.3e} (<= 1e-4)", flush=True)
                    if not err <= 1e-4:
                        raise RuntimeError(f"{name} is wrong")
        if not opt.quick and "site kernel" in runs:
            split("site kernel", runs["site kernel"], B, 12)
        order = ["PR 2 kernel", *[n for n in names if n != "PR 2 kernel"]]
        order = order + order[::-1]
        for name in order:
            ms = cuda_ms(runs[name])
            print(f"time B={B} {name}: {ms:.3f} ms ({B / ms * 1e3:.1f} "
                  f"solves/s)", flush=True)
        plain = cuda_ms(lambda: als_fwd_bwd_plain(*args))
        print(f"time B={B} plain: {plain:.3f} ms ({B / plain * 1e3:.1f} "
              f"solves/s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
