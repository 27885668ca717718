#!/usr/bin/env python3
"""Smoke run of the ttnx_torch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. Build: compile the Hopper kernels from ttnx_torch/csrc (nvcc, sm_90a).
3. Kernels: each of B1-B4 against its plain PyTorch version on the card,
   on the inputs the CN step really gives it at ranks 16, 32 and 64, in
   float32 and float64; max relative error (<= 1e-4 f32, <= 1e-10 f64)
   and median time of kernel and plain version. B3 also on a seeded SPD
   K at M = 509 (neither a multiple of 4 nor of 8), f32 and f64, and twice
   on the same inputs at r16 in f32 (bit-identical), as B1 and B2 are at
   every rank in f32 and B4 at ranks 32 and 64. Each B1, B2, B3 and B4 line names the kernel route
   the wrapper chose (cg_route: "cluster" for f32 at M <= 672, else "l2";
   env_route: B2 "cluster" for f32 at ranks 16, 32 and 64, else "staged";
   gram_route: B1 "grid" for f32 at RB = 64, 128 and 256, else
   "staged"; matfree_route: B4 "cluster" for f32 at ranks 32 and 64, else
   "streamed"). Then B4 by route at ranks 32 and 64 in f32 on the same
   inputs: route "cluster" against route "resident" (B5's kernel on a
   batch of one), timed (CUDA events) interleaved: cluster, resident,
   resident, cluster, beside B4's bound, with the two routes' max relative
   difference (<= 1e-4).
3b. Batched kernels: B5-B7 against their plain versions at R = 64 and
   32, float32 and float64, on B = 8 distinct problems: B5 and B6 on the
   inputs one als_sweeps_b call gives them (b[i] = (1 + 0.2 i) u_s, x[i] =
   u_s plus a seeded perturbation inside the masks), B7 whole on distinct
   flat-spectrum problems (ROADMAP C: on u_s, whose bond spectrum falls to
   rounding level, its Newton-Schulz gauge is set by rounding noise), plus
   two B7 cases at R = 32: cg_refine=2, cg_polish=2 and cg_polish=2; and
   B5 and B6 (right and left) at B = 512 on the inputs one als_sweeps_b
   call on phase 5's problem gives them, with their shares of their
   bounds; every f32 B6 call also twice on the same inputs (bit-identical).
   Each B6 line names its route (env_route: "resident" for f32 at R = 64
   and 32, else "staged") and its share of its bound. Each B7 line names
   the kernel
   route the wrapper chose (sweep_route: "site" for f32 at R = 64 and 32
   without a refine stage, else "folded"), each B5 line likewise
   (matfree_route: "resident" for a batch in f32 at R = 64 and 32, else
   "streamed"). Then the batched gauge QR (qr_batched, no TPU twin)
   against torch.linalg.qr, its plain version and the library's time, at
   B = 512, R = 64 and 32 (R n x R), both layouts, f32 (<= 1e-4) and f64
   (<= 1e-10), on seeded matrices of condition about 10, every other one
   with three dead rows and columns, with the f32 lines' shares of the
   bound; and the 22 QR calls of one als_sweeps_b call on phase 5's
   problem, timed together against torch.linalg.qr's, each with |QR - V|
   / |V| and |Q^T Q - I| <= 1e-5.
4. Main path: the d=12 Crank-Nicolson step at ranks 16, 32 and 64 (f32,
   16 warm CG iterations) on a three-mode eigenstate: the 8-step trajectory
   against the closed form (rel <= 1e-3), the implicit residual (<= 1e-2),
   ms/step and GFLOP/s through the kernels and through the plain versions,
   agreement of the two 8-step states (rel <= 1e-4), and the kernel launch
   counts per step (B1 = 1, B2 = 1 right + 1 left, B3/B4 = 22/0 at rank 16,
   0/22 at ranks 32 and 64), every B2, B3 and B4 launch on route
   "cluster" and B1 on route "grid".
5. Batched path: 512 rank-64 d=12 implicit heat solves (f32, no TF32)
   through both routes of the bench ladder, explicit_kernel (als_sweeps_b,
   cg_fused, 16 warm CG iterations: B6 2 launches on route "resident",
   B5 22 on route "resident", the batched gauge QR 22) and
   sweep_pair_fused (B7, one launch): solves/s and GFLOP/s (median of 3
   calls after a warm-up) through the kernels and through the plain
   versions, element 0's residual against the exact tridiagonal operator
   (<= 1e-2) and the kernel-against-plain agreement of its represented
   vector (<= 1e-4); the sweep_pair_fused line names B7's route and its
   share of its bound at B = 512.
3e. B2 and B6 by route: B2 on the CN step's chains at ranks 16, 32 and
   64 and B6 on phase 5's two calls at B = 512, timed (CUDA events)
   interleaved: new route, "staged", "staged", new route; then the device
   kernel time a call (torch.profiler) of the CN r64 step with the B2
   route forced either way.
3f. B1 and B8 by route: B1 on the CN step's stacks at RB = 64, 128 and
   256 and B8 on the third dmrg_eig_sweep's chains at (d, R) = (10, 16)
   and (12, 64), right and left, timed (CUDA events) interleaved: new route
   (B1 "grid", B8 "cluster"), "staged", "staged", new route; then the
   device kernel time a call (torch.profiler) of a CN r64 step and of a
   DMRG d = 12 sweep with the route forced either way.
3c. DMRG kernels: B8 (operator-only env chain, right and left) on the
   inputs the third of three dmrg_eig_sweeps gives it at R = 16 (d = 10)
   and R = 64 (d = 12), where every CTA's slab of env columns is nonzero
   (a gate), and B9 (fused Lanczos, M = 1024, iters 8 and 24) on a seeded
   well-conditioned symmetric K (Q, alphas and betas) and on the K the
   first d = 10 sweep assembles (gauge-free: the smallest Ritz value and its
   vector up to sign); float32 (<= 1e-4) and float64 (<= 1e-10). Each B9
   line names the kernel route (lanczos_route: "cluster" for f32 at M <=
   1024, else "l2"); on the sweep's K at iters 8 in f32 two launches must
   give the same bits, as they must for every f32 B8 input. Each B8 line
   names its route (env_A_route: "cluster" for f32 at R = 64, 32 and 16
   with RA = 5, else "staged").
6. DMRG path: the open XXX chain, f32, TF32 off, split='gram', tol =
   degen_tol = 1e-8, 8 chained dmrg_eig_sweeps after a warm-up sweep
   (median of 3 chains): d = 10, rmax = 16 through eig_solver='lanczos'
   (B8 2 launches a sweep) and 'lanczos_fused' (B8 2, B9 18, every one on
   route "cluster"), and d = 12,
   rmax = 64 through 'lanczos' (B8 at R = 64). Gates: the last energy
   within rel 1e-5 of the dense ground energy, every energy finite, the
   launch counts, and kernels against plain versions (energy rel <= 1e-5,
   state overlap >= 1 - 1e-4); ms/sweep, GFLOP/s, plain ms/sweep.
7. TDVP path and batched DMRG (plain torch, no kernel of their own; the
   batched sweeps run B8): tdvp1_step (16 steps) and tdvp2_step (8 steps)
   of the d = 10 heat generator on the sine, f32, against the analytic
   decay (rel <= 1e-3), ms/step; batched_dmrg_eig_sweeps over 4 XXZ
   chains with per-problem fields equal to the 4 single runs exactly,
   every B8 launch of the batch on route "cluster".
3d. Kernels B10-B13 against their plain versions: B10 (BiCGStab, 32
   iterations) on the K the convection step assembles at a middle site
   (M = 512; see CONV_SITE) and on a seeded diagonally dominant K at M =
   999, f32 (<= 1e-4; at CONV_SITE also two launches bit-identical) and
   f64 (<= 1e-10); B11 and B12 at the bench shapes, compared
   at 8 iterations (at the bench's 2048 the iterate has decayed to zero),
   bf16 (one bf16 ulp, 2^-8, for each rounding of the chain: 16 for B11,
   8 for B12) and f32 (<= 1e-4); B11 again at the bench's 2048 iterations
   on the norm-keeping input (entry.norm_keeping_contraction_problem, b w
   = I exactly in bf16), bf16: rel Frobenius <= 1e-3 and the output norm
   within 1 % of the input's; B12 likewise at the bench's 1024 iterations
   on its norm-keeping input (entry.norm_keeping_matmul_problem, w w^T = I
   exactly in bf16); B13 at (4096, 128, 64) @ (4096, 64, 128) in bf16 and
   f32 (<= 1e-5), with torch.bmm's time beside it. Each B10-B13 line names
   the kernel route the wrapper chose by dtype and shape (B10 "cluster"
   for f32 at M <= 668, else "l2"; B12 "wgmma" for bf16 at k <= 128).
8. Convection-diffusion CN path: d=12, rmax=16, f32, h=1e-6, c=1e3,
   solver='bicgstab_fused' (32 cold BiCGStab iterations a local solve),
   8 chained steps from the three-mode state (median of 3 chains after a
   warm-up), through the kernels and the plain versions: the 8-step state
   against the sparse-LU oracle (rel <= 1e-3), the last step's residual
   with the exact operators (<= 1e-2), kernels against plain (rel <=
   1e-4), launches per step (B10 22 on route "cluster", B1 1 on route
   "grid" at RB = 64, the operator packed at its exact rank 3 padded to
   RA = 4; B2 1 right + 1 left on route "cluster"; B3/B4 0).
9. Contraction path at the bench's shapes, bf16: the two-site merge of
   the chain's cores (B13), merge_resplit_chain at 2048 iterations (B11)
   and matmul_chain at 1024 (B12), each once for its launch count, then
   timed (CUDA events, median of 3 after a warm-up) through the kernel
   and the plain loop; finite outputs, GFLOP/s and the share of the bf16
   bound, B11 and B12 on route "wgmma"; beside the bench chain's decay,
   the norm ratios of B11 after 2048 and of B12 after 1024 iterations on
   their norm-keeping inputs.
10. QTT constructors, ALS eigensolve and MALS (phase wall time logged,
   10a on its own line): (a) at d = 12 in f64 on the card, against the
   closed forms of their reference tests: qtto_to_matrix of laplacian,
   laplacian_DN/ND/NN/P, shift and gradient against the numpy
   tridiagonal matrices, inv_laplacian_DN @ laplacian_DN against the
   identity (np.allclose's rtol 1e-5, atol 1e-8), fourier_qtto on a
   bit-reversed seeded QTT against torch.fft.fft (rel <= 1e-10),
   function_to_qtt, qtt_cos, qtt_exp and qtt_polynom against the sampled
   functions (atol 1e-12), and qtt_laplacian(2, 10) applied to
   function_to_qttv(sin sin) against the DN stencil on the 1024 x 1024
   grid (allclose); (b) als_eigsolve_scan of the XXX chain, d = 12, R =
   32, f32, 2 sweeps after a warm-up sweep: the last energy within rel
   1e-5 of the dense ground energy, every energy finite and >= E0 - 1e-5
   |E0|, exactly 2 B8 launches a sweep on route "cluster", kernel against
   plain (energy rel <= 1e-5, state overlap >= 1 - 1e-4), B8 held on the
   last chains (every slab nonzero, two launches bit-identical), ms/sweep
   through the kernel and plain; (c) mals_linsolve_scan of laplacian(12),
   b = A u_sin, a seeded rank-4 start, rmax = 64, tol 1e-12, one sweep:
   f64 rel error to u_sin <= 1e-9, f32 reported; ms/sweep, realized ranks,
   peak device memory; (d) mals_eigsolve_scan of the XXX chain at d = 10,
   rmax = 16, f32, 2 sweeps: the last energy within rel 1e-5.
11. The eager solver tier (no kernel; TF32 off; each line with its gate
   and ms/step or ms/sweep by the host clock, ending in a synchronize,
   beside the scan tier's number from phases 4, 6 and 7 where they time
   the same problem; sub-phase wall times logged): (a) the flagship's
   heat problem (entry.sine_mode_problem at the heat settings, the
   three-mode state, 8 steps of 1e-6): crank_nicholson_method with ALS
   from the state padded to ranks 16, 32 and 64 in f32 (the trajectory
   against the closed form rel <= 1e-3, return_error <= 1e-2, and the
   last step's dense residual <= 1e-2), then in f64 against the per-mode
   CN recurrence: ALS at r16 (rel <= 1e-10), MALS (rmax 16), DMRG
   (rmax_schedule [16]) and TT-Krylov (max_bond 16, CG) for 2 steps (rel
   <= 1e-6), and implicit_euler_method with ALS against its own per-mode
   factor (rel <= 1e-10); (b) tridiag(1, -2, 1) on modes 1, 16 and 256,
   f64, T = 10 in 50 steps: euler_method and implicit_euler_method (ALS)
   <= 5e-3, crank_nicholson_method (MALS) <= 1e-5, rk4_method (max_bond
   25) and expintegrator_tt (krylov_dim 30, max_bond 16) <= 1e-9 against
   the exact evolution; (c) the XXX chain from the seeded rank-4 start,
   f32, 3 sweeps at d = 10, rmax = 16 through dmrg_eigsolve, als_eigsolve
   (rank grown to 16), mals_eigsolve and als_gen_eigsolv of (A, 2 I), and
   dmrg_eigsolve with LOBPCG (it_solver=True) at d = 12, rmax = 64: the
   last energy within rel 1e-5 of the dense ground energy (of half of it
   for the pencil); (d) phase 7's problem through tdvp (16 steps) and
   tdvp2 (max_bond 8, 8 steps), complex128: the analytic decay rel <=
   1e-3; (e) the launch counts are the same before and after the phase,
   and every result is on the card.

12. The cross and the utilities (no kernel; TF32 off; sub-phase wall
   times logged; every line with the card's name and power limit): (a)
   the bench's batched MaxVol cross (entry.wishart_cross_problem, B = 16,
   f32) through maxvol_cross_device's fn(generator): max last val_eps <=
   1e-3, the rel-L2 of problems 0 and B - 1 on 200 fresh points against
   the float64 function <= 1e-3, crosses/s (median and best of 3 calls
   after a warm-up, host clock ending in a synchronize) and one call's
   host reads (torch's sync-debug mode) and CUDA kernels and copies
   (torch.profiler); (b) the same for the DMRG cross at B = 8; (c) the
   separable Gaussian (4 x 12 points, rank 3) by both device makers in
   f64 against the closed form (<= 1e-8) and tt_cross_device_adaptive's
   escalation (ranks 2 and 4); (d) the host cross with its cores on the
   card: the README's 4-D Gaussian by MaxVol (<= 1e-12), DMRGCross and
   Greedy on one case each of tests/test_cross.py (<= 1e-8, 1e-7), and
   tt_integrate of exp(-|x|^2) over [-1, 1]^3 within 1e-9 of (sqrt(pi)
   erf 1)^3; (e) save_tt/load_tt of a QTT vector on the card (bit-equal,
   the same subclass), resilient_linsolve with the eager als_linsolve
   after a diverging attempt (<= 1e-8 of the closed form) and
   assert_finite on a NaN core; (f) the launch counts are the same before
   and after the phase.

13. The distributed layer (phase wall time logged, and each sub-phase's;
   every line with the card's name and power limit): (a) a one-rank NCCL
   process group in this process: psum, psum_scatter and all_gather on
   its mesh keep a CUDA tensor (route "nccl"), then make_cn_step_dist on
   phase 4's problem at r64 (f32, cg_fused, gram_chain, 2 half-sweeps,
   the default 48 CG iterations) takes the replicated rounding: 8 steps
   against the closed form (rel <= 1e-3), the residual (<= 1e-2), the
   8-step state against make_cn_step at the same settings (rel <= 1e-4),
   launches a step B1 1 on route "grid", B2 1 + 1 on "cluster", B4 22 on
   "cluster"; (b) the same step with force_tp=True on 2 and then 4 gloo
   ranks spawned on cuda:0 (CUDA tensors, route "gloo-cuda"): every rank's
   8-step state against 13a's (rel <= 1e-4) and the closed form, its own
   launches a step (B2 1 + 1, B4 22, B1 0) and ms/step beside 13a's; (c)
   batched_als_linsolve on a (dp = 2, tp = 1) mesh of the 2 ranks: 8
   problems of entry.batched_als_problem's d = 12, rank-64 heat solve
   (right-hand sides (1 + 0.2 k) u), cg_fused, each solution against the
   single-device batched_als_sweeps (rel <= 1e-4), element 0's residual
   (<= 1e-2); (d) entry.dryrun_multichip on a (dp = 2, tp = 2) mesh of the
   4 ranks in float64: all 7 legs under the JAX package's thresholds. The
   ranks' launches add to this process's in the totals; any rank's
   failure fails the run.

14. Autograd, the NaN trap and the examples (phase and sub-phase wall
   times logged; every line with the card's name and power limit): (a)
   the core gradient of the Rayleigh quotient of phase 11's XXX chain (d =
   10, the seeded rank-4 start) on the card in float64 (<= 1e-10 of the
   CPU's float64 gradient) and float32, TF32 off (<= 1e-4); the
   torch.optim.Adam twin of the JAX package's optax test in float64 and
   float32 (100 steps of lr 0.05 on laplacian(4): below its start and
   within 1e-2 of the dense ground energy); one wrapper of each kernel
   file refuses a CUDA input that requires grad, each input in turn,
   with RuntimeError and no launch; (b) one NaN in the input of phase 4's
   CN step at r16: with utils.validation.debug_nans the step raises
   FloatingPointError naming the first op or kernel to return a NaN;
   without it, the NaN reaches the output or cuSOLVER's eigh of the
   rounding's Gram raises a LinAlgError; the clean step under the trap
   equals the step without it; (c) every script of examples_torch/ in
   this process (runpy), the launch counts reset before each: each runs
   its examples/ twin's asserts (quadrature_cross stops at its twin's
   failing d = 10 assert, as the twin does, ROADMAP C.24), and the
   kernel launches of each equal EXAMPLE_LAUNCHES (als_quickstart: B2
   2 + 2; ising_phase_transition: B8 52; batched_dmrg_tdvp_sweep: B8 60;
   batched_parameter_sweep: B2 16 + 16; no other script launches). These
   launches add to the totals.

The last two lines are a JSON summary of the kernels (14 rows: errors,
times, bound, library time; ``kernel_route`` the wrapper's route where it
has more than one; B6 at B = 512, right; B8 at R = 64, right; QR at B =
512, R = 64, the forward layout) and the
device line ``{"ok":
true, "device": {...}}``. Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

D = 12
RANKS = (16, 32, 64)
H_STEP = 1e-6
N_STEPS = 8
CG_ITERS = 16
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
MIDDLE_SITE = 5  # which of the 22 local solves of a step to compare

BATCH, BATCH_CHECK = 512, 8
BATCHED_RANKS = (64, 32)

# DMRG (bench_dmrg_sweep, bench.py:323-374) and its exact-rank wide twin
DMRG_CONFIGS = ((10, 16), (12, 64))  # (d, rmax)
DMRG_ITERS, DMRG_SWEEPS = 8, 8
ENV_A_SWEEPS = 3  # B8 is held on the chains of the third sweep
LANCZOS_M = 1024
# TDVP (bench_tdvp_step / bench_tdvp2_step, bench.py:376-503)
TDVP_D, TDVP_RMAX, TDVP_H = 10, 8, 1e-5
# convection-diffusion CN (bench_cn_rank's settings, a non-symmetric A).
# B10 is held on local solve CONV_SITE of the first step (the backward
# sweep at site 7, cond(K) ~35): the forward sweep's K at site 5 is
# singular to rounding (its right environment comes from the rank-6 guess;
# smallest singular value ~1e-13), and there BiCGStab's components in the
# null directions are set by rounding in any two implementations.
CONV_RMAX, CONV_C, BICG_ITERS, CONV_SITE = 16, 1e3, 32, 15
# contraction chain (bench_pallas_chain) and its ceiling (bench.py:176-234)
CHAIN_ITERS, CEIL_ITERS, SHORT_ITERS = 2048, 1024, 8
BF16_ULP = 2.0 ** -8
# the QTT constructors and the scan-tier eigen and MALS solvers (slice 13):
# (d, rmax) of the ALS eigensolve, the MALS linear solve and the MALS
# eigensolve, and the bits a dimension of the 2-D Laplacian
QTT_D, LAP2D_BITS = 12, 10
ALS_EIG, ALS_EIG_SWEEPS = (12, 32), 2
MALS_LIN, MALS_EIG = (12, 64), (10, 16)
# the eager solver tier: 11a's f32 guess ranks and f64 runs,
# 11b's explicit problem (T = 10 in 50 steps), 11c's eigenproblems (d,
# rmax; the LOBPCG run's) and sweep counts
EAGER_RANKS, EAGER_F64_RANK, EAGER_F64_STEPS = (16, 32, 64), 16, 2
HEAT_MODES = ((1, 1.0), (3, 0.5), (9, 0.25))  # entry.three_mode_state's
EXPL_MODES, EXPL_T, EXPL_STEPS = ((1, 1.0), (16, 0.5), (256, 0.25)), 10.0, 50
EIG, EIG_LOBPCG, EIG_SWEEPS = (10, 16), (12, 64), 3
LOBPCG_SWEEPS = 3  # from rank 4, ranks double each half sweep up to 64
# scan-tier ms/step and ms/sweep of phases 4, 6 and 7, printed beside the
# eager tier's in phase 11
SCAN_MS: dict[str, float] = {}
# published dense peaks of one H100 SXM (NVIDIA's data sheet): FLOP/s by
# operand type of the summarized rows (bf16 on the tensor cores, f32 on
# the CUDA cores) and device-memory bytes/s
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM = 3.35e12

# wrapper name -> (label, patched module or modules, source, TPU kernel it
# replaces)
KERNELS = {
    "gram_chain_fused": (
        "B1", "ttnx_torch.solvers.round_scan",
        "ttnx_torch/csrc/gram_chain.cu", "ttnx/kernels/gram.py:87"),
    "right_env_chain_fused": (
        "B2", "ttnx_torch.solvers.als_scan",
        "ttnx_torch/csrc/env_chain.cu", "ttnx/kernels/env_chain.py:420"),
    "left_env_chain_fused": (
        "B2", "ttnx_torch.solvers.als_scan",
        "ttnx_torch/csrc/env_chain.cu", "ttnx/kernels/env_chain.py:382"),
    "cg_solve_fused": (
        "B3", "ttnx_torch.solvers.als_scan",
        "ttnx_torch/csrc/local_cg.cu", "ttnx/kernels/local_cg.py:167"),
    "cg_matfree_fused": (
        "B4", "ttnx_torch.solvers.als_scan",
        "ttnx_torch/csrc/local_cg_mf.cu", "ttnx/kernels/local_cg_mf.py:260"),
    "cg_matfree_fused_batched": (
        "B5", "ttnx_torch.solvers.als_scan_batched",
        "ttnx_torch/csrc/local_cg_mf.cu", "ttnx/kernels/local_cg_mf.py:225"),
    "env_chain_fused_batched": (
        "B6", "ttnx_torch.solvers.als_scan_batched",
        "ttnx_torch/csrc/env_chain.cu", "ttnx/kernels/env_chain.py:346"),
    "als_fwd_bwd_fused_batched": (
        "B7", "ttnx_torch.kernels.als_sweep_fused",
        "ttnx_torch/csrc/als_sweep_fused.cu",
        "ttnx/kernels/als_sweep_fused.py:545"),
    "env_chain_A_fused": (
        "B8", ("ttnx_torch.solvers.dmrg_scan", "ttnx_torch.solvers.als_scan"),
        "ttnx_torch/csrc/env_chain.cu", "ttnx/kernels/env_chain.py:238"),
    "lanczos_fused": (
        "B9", "ttnx_torch.solvers.dmrg_scan",
        "ttnx_torch/csrc/lanczos.cu", "ttnx/kernels/lanczos.py:102"),
    "bicgstab_solve_fused": (
        "B10", "ttnx_torch.solvers.als_scan",
        "ttnx_torch/csrc/local_cg.cu", "ttnx/kernels/local_cg.py:143"),
    "merge_resplit_chain": (
        "B11", "ttnx_torch.kernels.contraction",
        "ttnx_torch/csrc/contraction.cu", "ttnx/kernels/contraction.py:162"),
    "matmul_chain": (
        "B12", "ttnx_torch.kernels.contraction",
        "ttnx_torch/csrc/contraction.cu", "ttnx/kernels/contraction.py:125"),
    "two_site_merge": (
        "B13", "ttnx_torch.kernels.contraction",
        "ttnx_torch/csrc/contraction.cu", "ttnx/kernels/contraction.py:45"),
    "qr_batched": (
        "QR", "ttnx_torch.solvers.als_scan_batched",
        "ttnx_torch/csrc/qr_batched.cu",
        "none (ttnx leaves the batched gauge QR to XLA)"),
}
CN_KERNELS = ("gram_chain_fused", "right_env_chain_fused",
              "left_env_chain_fused", "cg_solve_fused", "cg_matfree_fused")
B2 = ("right_env_chain_fused", "left_env_chain_fused")
# held twice on the CN step's inputs for bit-identity in f32
HELD_TWICE = B2 + ("cg_solve_fused", "gram_chain_fused",
                   "cg_matfree_fused")


def log(msg: str) -> None:
    print(msg, flush=True)


def wrappers():
    from ttnx_torch.kernels import (als_sweep_fused, contraction, env_chain,
                                    gram, lanczos, local_cg, local_cg_mf,
                                    qr_batched)

    return {
        "gram_chain_fused": (gram.gram_chain_fused, gram.gram_chain_plain),
        "right_env_chain_fused": (env_chain.right_env_chain_fused,
                                  env_chain.right_env_chain_plain),
        "left_env_chain_fused": (env_chain.left_env_chain_fused,
                                 env_chain.left_env_chain_plain),
        "cg_solve_fused": (local_cg.cg_solve_fused, local_cg.cg_solve_plain),
        "cg_matfree_fused": (local_cg_mf.cg_matfree_fused,
                             local_cg_mf.cg_matfree_plain),
        "cg_matfree_fused_batched": (local_cg_mf.cg_matfree_fused_batched,
                                     local_cg_mf.cg_matfree_batched_plain),
        "env_chain_fused_batched": (env_chain.env_chain_fused_batched,
                                    env_chain.env_chain_batched_plain),
        "als_fwd_bwd_fused_batched": (
            als_sweep_fused.als_fwd_bwd_fused_batched,
            als_sweep_fused.als_fwd_bwd_plain),
        "env_chain_A_fused": (env_chain.env_chain_A_fused,
                              env_chain.env_chain_A_plain),
        "lanczos_fused": (lanczos.lanczos_fused, lanczos.lanczos_plain),
        "bicgstab_solve_fused": (local_cg.bicgstab_solve_fused,
                                 local_cg.bicgstab_solve_plain),
        "merge_resplit_chain": (contraction.merge_resplit_chain,
                                contraction.merge_resplit_chain_plain),
        "matmul_chain": (contraction.matmul_chain,
                         contraction.matmul_chain_plain),
        "two_site_merge": (contraction.two_site_merge,
                           contraction.two_site_merge_plain),
        "qr_batched": (qr_batched.qr_batched, qr_batched.qr_batched_plain),
    }


@contextlib.contextmanager
def solver_calls(replace):
    """Inside the block the solver modules call ``replace(name, kernel,
    plain)`` in place of each kernel wrapper."""
    import importlib

    saved = []
    try:
        for name, (kernel, plain) in wrappers().items():
            mods = KERNELS[name][1]
            for modname in mods if isinstance(mods, tuple) else (mods,):
                mod = importlib.import_module(modname)
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, replace(name, kernel, plain))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_versions():
    return solver_calls(lambda name, kernel, plain: plain)


def routes_of(name, before=None):
    """``{route: launches}`` of wrapper ``name`` since ``before`` (an
    earlier ``dispatch.route_counts()`` reading), else since the last
    reset of the counts."""
    from ttnx_torch.kernels.dispatch import route_counts

    was = (before or {}).get(name, {})
    return {r: n - was.get(r, 0) for r, n in route_counts()[name].items()
            if n > was.get(r, 0)}


def cuda_ms(fn, reps: int = 10, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean device time of ``reps`` calls,
    by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def cn_analytic(d, hg, h_step, steps):
    j = np.arange(1, 2 ** d + 1)
    out = np.zeros(2 ** d)
    for k, amp in ((1, 1.0), (3, 0.5), (9, 0.25)):
        mu = (2 - 2 * np.cos(k * np.pi * hg)) / hg ** 2
        rho = (1 - h_step / 2 * mu) / (1 + h_step / 2 * mu)
        out += amp * rho ** steps * np.sin(k * np.pi * j * hg)
    return out


def cn_residual(u_next, u_prev, hg, h_step):
    """||L u+ - R u|| / ||R u|| with the exact tridiagonal operators."""
    c = h_step / (2 * hg ** 2)

    def T(v):
        out = 2 * v
        out[:-1] -= v[1:]
        out[1:] -= v[:-1]
        return out

    lhs = u_next + c * T(u_next.copy())
    rhs = u_prev - c * T(u_prev.copy())
    return float(np.linalg.norm(lhs - rhs) / np.linalg.norm(rhs))


def setup(rmax, device, dtype=torch.float32):
    """The CN step on the three-mode state (rank 6), whose evolution has a
    closed form."""
    from ttnx_torch.entry import flagship_cn_step, three_mode_state

    hg = 1.0 / (2 ** D + 1)
    step_fn, pack, unpack = flagship_cn_step(device, rmax=rmax, d=D,
                                             h=H_STEP, dtype=dtype,
                                             cg_iters=CG_ITERS)
    return step_fn, pack(three_mode_state(D, hg, device)), unpack


def dense(unpack, stack):
    from ttnx_torch.core.decomp import ttv_to_tensor

    return ttv_to_tensor(unpack(stack)).reshape(-1).double().cpu().numpy()


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    smi = smi_line()
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} | CUDA {torch.version.cuda} | python "
        f"{sys.version.split()[0]}")
    return smi


def phase_build():
    from ttnx_torch.kernels import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    nvcc = ("cached" if _build.BUILD_SECONDS is None
            else f"nvcc {_build.BUILD_SECONDS:.1f} s")
    log(f"build: {so.name} in {time.perf_counter() - t0:.1f} s ({nvcc})")


def record_calls(run):
    """``run()`` through the plain versions; returns ``{wrapper name: [(args,
    kwargs), ...]}`` of every kernel wrapper call it made."""
    seen = {}

    def recorder(name, kernel, plain):
        def call(*args, **kwargs):
            seen.setdefault(name, []).append((args, kwargs))
            return plain(*args, **kwargs)
        return call

    with solver_calls(recorder):
        run()
    torch.cuda.synchronize()
    return seen


def capture_inputs(rmax, device, dtype):
    """Run one CN step through the plain versions and keep the arguments
    each kernel wrapper received (the MIDDLE_SITE-th local solve)."""
    step_fn, us, _ = setup(rmax, device, dtype)
    seen = record_calls(lambda: step_fn(us))
    return {name: calls[min(MIDDLE_SITE, len(calls) - 1)]
            for name, calls in seen.items()}


def max_err(got, ref):
    if isinstance(ref, tuple):
        pairs = list(zip(got, ref))
    else:
        pairs = [(got, ref)]
    abs_err = max(float((g - r).abs().max()) for g, r in pairs)
    scale = max(float(r.abs().max()) for _, r in pairs)
    return abs_err, abs_err / scale


def nbytes(x):
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(nbytes(v) for v in x)
    return 0


def kernel_flops(name, args, kw):
    """The operations of one wrapper call, from its shapes: the
    contractions and matvecs it runs (vector updates and the gauge of B7
    excluded, so the bound below is a floor)."""
    from ttnx_torch.utils.flops import (als_sweeps_flops, einsum_flops,
                                        gram_chain_flops)

    def env_A(R, RA, n):
        return einsum_flops("aip,Wijw,bjq,pwq->aWb", (R, n, R),
                            (RA, n, n, RA), (R, n, R), (R, RA, R))

    def env_b(R, Rb, n):
        return einsum_flops("aip,uiv,pv->au", (R, n, R), (Rb, n, Rb),
                            (R, Rb))

    if name == "gram_chain_fused":
        d, R, n, _ = args[0].shape
        return gram_chain_flops(d, R, n)
    if name in ("right_env_chain_fused", "left_env_chain_fused",
                "env_chain_fused_batched"):
        x, A, b = args[:3]
        B = x.shape[0] if x.dim() == 5 else 1
        d, R, n = x.shape[-4:-1]
        return B * d * (env_A(R, A.shape[1], n) + env_b(R, b.shape[-1], n))
    if name == "env_chain_A_fused":
        d, R, n = args[0].shape[:3]
        return d * env_A(R, args[1].shape[1], n)
    if name in ("cg_solve_fused", "bicgstab_solve_fused", "lanczos_fused"):
        M = args[0].shape[0]
        if name == "cg_solve_fused":
            it = kw.get("iters", 48) + (kw.get("x0") is not None)
            return it * 2.0 * M * M
        if name == "bicgstab_solve_fused":
            return kw.get("iters", 32) * 4.0 * M * M
        it = kw.get("iters", 16)  # + two reorthogonalization passes
        return it * 2.0 * M * M + 8.0 * M * it * (it - 1) / 2
    if name in ("cg_matfree_fused", "cg_matfree_fused_batched"):
        L, Ac = args[:2]
        B = L.shape[0] if L.dim() == 4 else 1
        R, RA, n = L.shape[-3], L.shape[-2], Ac.shape[1]
        apply = einsum_flops("aWb,WiJw,cwd,bJd->aic", (R, RA, R),
                             (RA, n, n, RA), (R, RA, R), (R, n, R))
        return B * (kw.get("iters", 32) + (kw.get("x0") is not None)) * apply
    if name == "als_fwd_bwd_fused_batched":
        A, _, x, _ = args
        B, d, R, n, _ = x.shape
        return B * als_sweeps_flops(d, R, A.shape[1], R, n, 2,
                                    kw.get("cg_iters", 24) + 1)
    if name == "two_site_merge":
        (B, m, k), n = args[0].shape, args[1].shape[2]
        return 2.0 * B * m * k * n
    if name == "matmul_chain":
        B, m, k = args[0].shape
        return 2.0 * B * m * k * k * kw.get("iters", 8)
    if name == "merge_resplit_chain":
        (B, m, r), n = args[0].shape, args[1].shape[2]
        return 2 * 2.0 * B * m * r * n * kw.get("iters", 8)
    if name == "qr_batched":  # geqrf and orgqr, 2 m k^2 - 2 k^3 / 3 each
        B, m, k = args[0].shape
        if kw.get("rows", False):
            m, k = k, m
        return B * 2 * (2.0 * m * k * k - 2.0 * k ** 3 / 3)
    raise KeyError(name)


def work(name, args, kwargs, out):
    """(FLOPs, bytes, operand type) of one call: each input read once and
    each output written once."""
    tensors = [a for a in args if torch.is_tensor(a)]
    moved = nbytes(list(args) + list(kwargs.values())) + nbytes(out)
    return kernel_flops(name, args, kwargs), moved, tensors[0].dtype


def bound(row):
    """(least time in ms, what bounds it) of a row's call on the card."""
    flops, moved, dtype = row["work"]
    t_ops, t_bytes = flops / PEAK[dtype], moved / HBM
    return max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops >= t_bytes else "bytes")


def hold(name, rmax, dtype, args, kwargs, reps=10, repeats=5, tag="",
         compare=max_err, tol=None):
    """One kernel against its plain version on the same inputs: raises
    above the tolerance (``TOL[dtype]`` unless given), returns the row of
    errors, CUDA-event times and the call's work (FLOPs, bytes).
    ``compare(got, ref)`` gives (max abs err, max rel err)."""
    kernel, plain = wrappers()[name]
    tol = TOL[dtype] if tol is None else tol
    got = kernel(*args, **kwargs)
    route = getattr(kernel, "route", None)
    ref = plain(*args, **kwargs)
    torch.cuda.synchronize()
    abs_err, rel_err = compare(got, ref)
    ms = cuda_ms(lambda: kernel(*args, **kwargs), reps, repeats)
    plain_ms = cuda_ms(lambda: plain(*args, **kwargs), reps, repeats)
    big = max((a for a in args if torch.is_tensor(a)), key=torch.numel)
    shape = "x".join(str(s) for s in big.shape)
    ok = rel_err <= tol
    log(f"kernel {KERNELS[name][0]} {name:25s} r{rmax:<3d} "
        f"{str(dtype)[6:]:8s} in {shape:16s}{tag} max_rel_err "
        f"{rel_err:.3e} (<= {tol:.2e}) max_abs_err {abs_err:.3e} | kernel "
        f"{ms:.4f} ms  plain {plain_ms:.4f} ms"
        f"{f'  route {route}' if route else ''}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(
            f"{name} r{rmax} {dtype}{tag}: kernel disagrees with its plain "
            f"version, rel err {rel_err:.3e} > {tol:.2e}")
    return dict(name=name, rmax=rmax, dtype=dtype, abs_err=abs_err,
                rel_err=rel_err, ms=ms, plain_ms=plain_ms, tag=tag,
                work=work(name, args, kwargs, got), route=route)


def spd_problem(M, dtype, device):
    """A seeded SPD K = g g^T / M + I, a rhs and a warm start."""
    rng = np.random.default_rng(M)
    g = rng.standard_normal((M, M))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device) for a in
                 (g @ g.T / M + np.eye(M), rng.standard_normal(M),
                  rng.standard_normal(M)))


def b4_by_route(rmax, row, args, kwargs):
    """B4 on route cluster against route resident (B5's kernel on a batch
    of one) on the same inputs: max relative difference and CUDA-event
    times interleaved, beside the bound of ``row`` (the hold's)."""
    from ttnx_torch.kernels.dispatch import route_counts
    from ttnx_torch.kernels.local_cg_mf import (cg_matfree_fused,
                                                cg_matfree_fused_batched)

    L, Ac, Renv, rhs, mask = args
    x0 = kwargs.get("x0")
    one = dict(kwargs, x0=None if x0 is None else x0[None])
    runs = {"cluster": lambda: cg_matfree_fused(*args, **kwargs),
            "resident": lambda: cg_matfree_fused_batched(
                L[None], Ac, Renv[None], rhs[None], mask, **one)[0]}
    before = route_counts()
    got = {route: run() for route, run in runs.items()}
    torch.cuda.synchronize()
    taken = (routes_of("cg_matfree_fused", before),
             routes_of("cg_matfree_fused_batched", before))
    if taken != ({"cluster": 1}, {"resident": 1}):
        raise RuntimeError(f"B4 r{rmax}: routes {taken[0]}, {taken[1]}")
    _, rel = max_err(got["cluster"], got["resident"])
    ms = {route: [] for route in runs}
    for route in ("cluster", "resident", "resident", "cluster"):
        ms[route].append(cuda_ms(runs[route]))
    bound_ms, by = bound(row)
    log(f"kernel B4 by route r{rmax} float32: cluster "
        f"{ms['cluster'][0]:.4f}, {ms['cluster'][1]:.4f} ms | resident "
        f"{ms['resident'][0]:.4f}, {ms['resident'][1]:.4f} ms | bound "
        f"{bound_ms:.5f} ms ({by}) | cluster against resident max_rel_diff "
        f"{rel:.3e} (<= 1e-4)")
    if not rel <= 1e-4:
        raise RuntimeError(f"B4 r{rmax}: routes cluster and resident "
                           f"differ by {rel:.3e}")


def phase_kernels(device):
    rows = []
    for dtype in (torch.float32, torch.float64):
        for rmax in RANKS:
            inputs = capture_inputs(rmax, device, dtype)
            for name, (args, kwargs) in inputs.items():
                rows.append(hold(name, rmax, dtype, args, kwargs))
                if name in HELD_TWICE and dtype == torch.float32:
                    deterministic(name, args, kwargs)
                if name == "cg_matfree_fused" and dtype == torch.float32:
                    b4_by_route(rmax, rows[-1], args, kwargs)
        K, rhs, x0 = spd_problem(509, dtype, device)
        rows.append(hold("cg_solve_fused", 16, dtype, (K, rhs),
                         dict(x0=x0, iters=CG_ITERS), tag=" M=509 SPD"))
    if {r["name"] for r in rows} != set(CN_KERNELS):
        raise RuntimeError("the CN step did not call every kernel wrapper")
    return rows


def distinct_batch(device, dtype, rmax):
    """The batched heat problem with BATCH_CHECK distinct problems: b[i] =
    (1 + 0.2 i) u_s, x[i] = u_s + a seeded perturbation inside the masks."""
    from ttnx_torch.entry import batched_als_problem

    p = batched_als_problem(device, batch=1, rmax=rmax, dtype=dtype)
    us, m = p["b_batch"][0], p["masks"]
    inside = m[:-1][:, :, None, None] * m[1:][:, None, None, :]
    rng = np.random.default_rng(rmax)
    noise = torch.as_tensor(rng.standard_normal((BATCH_CHECK,) + us.shape),
                            dtype=dtype, device=device)
    b = torch.stack([(1.0 + 0.2 * i) * us for i in range(BATCH_CHECK)])
    x = us + 1e-2 * float(us.abs().max()) * noise * inside
    return p, b, x


def flat_batch(device, dtype, rmax):
    """BATCH_CHECK distinct flat-spectrum problems on the same operator."""
    from ttnx_torch.entry import batched_als_problem, flat_spectrum_stack

    p = batched_als_problem(device, batch=1, rmax=rmax, dtype=dtype)
    rng = np.random.default_rng(100 + rmax)
    b = np.stack([flat_spectrum_stack(rng, p["u_rks"], rmax)
                  for _ in range(BATCH_CHECK)])
    x = b + 0.3 * np.stack([flat_spectrum_stack(rng, p["u_rks"], rmax)
                            for _ in range(BATCH_CHECK)])
    return p, *(torch.as_tensor(a, dtype=dtype, device=device)
                for a in (b, x))


def phase_batched_kernels(device):
    from ttnx_torch.solvers.als_scan_batched import als_sweeps_b

    rows = []
    for dtype in (torch.float32, torch.float64):
        for rmax in BATCHED_RANKS:
            p, b, x = distinct_batch(device, dtype, rmax)
            seen = record_calls(lambda: als_sweeps_b(
                p["lhs_stack"], b, x, p["masks"], 2, cg_iters=CG_ITERS,
                solver="cg_fused"))
            args, kwargs = seen["cg_matfree_fused_batched"][MIDDLE_SITE]
            rows.append(hold("cg_matfree_fused_batched", rmax, dtype, args,
                             kwargs))
            for (args, kwargs), tag in zip(seen["env_chain_fused_batched"],
                                           (" right", " left")):
                rows.append(hold("env_chain_fused_batched", rmax, dtype,
                                 args, kwargs, tag=tag))
                if dtype == torch.float32:
                    log_bound("B6", f" B={BATCH_CHECK} r{rmax}{tag}",
                              rows[-1])
                    deterministic("env_chain_fused_batched", args, kwargs)
            p, b, x = flat_batch(device, dtype, rmax)
            sweep = (p["lhs_stack"], b, x, p["masks"])
            rows.append(hold("als_fwd_bwd_fused_batched", rmax, dtype, sweep,
                             {}, reps=1, repeats=3))
            if rmax == 32 and dtype == torch.float32:
                rows.append(hold("als_fwd_bwd_fused_batched", rmax, dtype,
                                 sweep, dict(cg_refine=2, cg_polish=2),
                                 reps=1, repeats=3, tag=" refine2 polish2"))
                rows.append(hold("als_fwd_bwd_fused_batched", rmax, dtype,
                                 sweep, dict(cg_polish=2), reps=1,
                                 repeats=3, tag=" polish2"))
    seen = bench_batch_calls(device)
    held = [("B5", "cg_matfree_fused_batched",
             seen["cg_matfree_fused_batched"][MIDDLE_SITE], "")]
    held += [("B6", "env_chain_fused_batched", call, side) for call, side in
             zip(seen["env_chain_fused_batched"], (" right", " left"))]
    for label, name, (args, kwargs), side in held:
        row = hold(name, 64, torch.float32, args, kwargs, reps=1, repeats=3,
                   tag=f" B={BATCH}{side}")
        log_bound(label, f" B={BATCH}{side}", row)
        if label == "B6":
            deterministic(name, args, kwargs)
        rows.append(row)
    return rows + qr_rows(device, seen["qr_batched"])


def qr_stack(device, dtype, R, rows):
    """BATCH seeded (R n, R) matrices of condition about 10 (Gaussian plus
    3 I), every other one with its last three rows and columns zero (the
    rank masks' dead bonds), in the layout ``qr_batched(rows=rows)`` reads:
    ``(BATCH, R n, R)`` or ``(BATCH, R, R n)``."""
    g = torch.Generator().manual_seed(R + rows)
    m = 2 * R
    V = (torch.randn((BATCH, m, R), generator=g, dtype=torch.float64)
         + 3.0 * torch.eye(m, R, dtype=torch.float64))
    V[1::2, m - 3:] = 0.0
    V[1::2, :, R - 3:] = 0.0
    if rows:
        V = V.transpose(1, 2)
    return V.contiguous().to(device=device, dtype=dtype)


def qr_rows(device, calls):
    """The batched gauge QR: the kernel against torch.linalg.qr (its plain
    version, also the library's time) at the batched ALS's shapes, B =
    BATCH, R = 64 and 32, both layouts, f32 and f64, with its share of its
    bound; then the 22 calls of one bench call (``calls``, recorded), timed
    together, with Q R = V and Q^T Q = I on each (a gauge-free check: on
    the bench's three-mode state the columns of Q past the bond's numerical
    rank are set by rounding)."""
    rows = []
    for dtype in (torch.float32, torch.float64):
        for R in BATCHED_RANKS:
            for layout in ("cols", "rows"):
                V = qr_stack(device, dtype, R, layout == "rows")
                row = hold("qr_batched", R, dtype, (V,),
                           dict(rows=layout == "rows"),
                           tag=f" B={BATCH} {layout}")
                row["library_ms"] = row["plain_ms"]  # torch.linalg.qr
                if dtype == torch.float32:
                    log_bound("QR", f" B={BATCH} r{R} {layout}", row)
                rows.append(row)
    kernel, plain = wrappers()["qr_batched"]
    worst = 0.0
    for args, kwargs in calls:
        q, r = kernel(*args, **kwargs)
        V = args[0].double()
        q, r = q.double(), r.double()
        if kwargs.get("rows", False):
            V, q, r = V.transpose(1, 2), q.transpose(1, 2), r.transpose(1, 2)
        eye = torch.eye(q.shape[2], dtype=q.dtype, device=q.device)
        worst = max(worst, float(torch.linalg.norm(q @ r - V)
                                 / torch.linalg.norm(V)),
                    float((q.transpose(1, 2) @ q - eye).abs().max()))
    ms = cuda_ms(lambda: [kernel(*a, **kw) for a, kw in calls], 1, 3)
    lib_ms = cuda_ms(lambda: [plain(*a, **kw) for a, kw in calls], 1, 3)
    log(f"kernel QR qr_batched on one bench call's {len(calls)} calls (B="
        f"{BATCH} r64 f32): {ms:.3f} ms a call, torch.linalg.qr "
        f"{lib_ms:.3f} ms | max(|QR - V| / |V|, |Q^T Q - I|) {worst:.3e} "
        f"(<= 1e-5)")
    if not worst <= 1e-5:
        raise RuntimeError(f"qr_batched on the bench call: {worst:.3e}")
    return rows


def log_bound(label, what, row):
    bound_ms, by = bound(row)
    route = f" route {row['route']}" if row["route"] else ""
    log(f"kernel {label}{what}{route}: {row['ms']:.4f} ms, "
        f"{bound_ms / row['ms']:.3f} of its {by} bound {bound_ms:.4f} ms")


def bench_batch_calls(device):
    """``{wrapper name: [(args, kwargs), ...]}`` of one als_sweeps_b call
    on phase 5's problem (B = BATCH, rmax 64, f32), recorded through the
    plain versions: B5's 22 launches and B6's two."""
    from ttnx_torch.entry import batched_als_problem
    from ttnx_torch.solvers.als_scan_batched import als_sweeps_b

    p = batched_als_problem(device, batch=BATCH, rmax=64, d=D, h=H_STEP)
    return record_calls(lambda: als_sweeps_b(
        p["lhs_stack"], p["b_batch"], p["x_batch"], p["masks"], 2,
        cg_iters=CG_ITERS, solver="cg_fused"))


def run_chain(step_fn, us, n):
    """n chained steps; returns (state after n-1 steps, after n steps)."""
    prev, v = us, us
    for _ in range(n):
        prev, v = v, step_fn(v)
    return prev, v


def timed_chain(step_fn, us):
    """ms/step: median over 3 chains of N_STEPS steps, after a warm-up."""
    v = step_fn(us)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prev, v = run_chain(step_fn, us, N_STEPS)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / N_STEPS * 1e3)
    return statistics.median(times), prev, v


def phase_main_path(device):
    from ttnx_torch.kernels.dispatch import (launch_counts,
                                             reset_launch_counts,
                                             route_counts)
    from ttnx_torch.utils.flops import cn_step_flops

    hg = 1.0 / (2 ** D + 1)
    exact = cn_analytic(D, hg, H_STEP, N_STEPS)
    reset_launch_counts()
    for rmax in RANKS:
        step_fn, us, unpack = setup(rmax, device)
        before, routes = launch_counts(), route_counts()
        one = step_fn(us)
        torch.cuda.synchronize()
        per_step = {k: v - before[k] for k, v in launch_counts().items()}
        dense_k = 2 * rmax * rmax <= 1024  # M = R n R: B3 below, B4 above
        want = dict.fromkeys(per_step, 0)
        want.update({"gram_chain_fused": 1, "right_env_chain_fused": 1,
                     "left_env_chain_fused": 1,
                     "cg_solve_fused": 2 * (D - 1) if dense_k else 0,
                     "cg_matfree_fused": 0 if dense_k else 2 * (D - 1)})
        if per_step != want:
            raise RuntimeError(f"r{rmax}: launches per step {per_step}, "
                               f"expected {want}")
        b4 = routes_of("cg_matfree_fused", routes)
        if b4 != ({} if dense_k else {"cluster": 2 * (D - 1)}):
            raise RuntimeError(f"r{rmax}: B4 took routes {b4}, not all "
                               f"cluster")
        b3 = routes_of("cg_solve_fused", routes)
        if set(b3) - {"cluster"}:
            raise RuntimeError(f"r{rmax}: B3 took routes {b3}, not all "
                               f"cluster")
        b2 = [routes_of(name, routes) for name in B2]
        if b2 != [{"cluster": 1}] * 2:
            raise RuntimeError(f"r{rmax}: B2 took routes {b2}, not all "
                               f"cluster")
        b1 = routes_of("gram_chain_fused", routes)
        if b1 != {"grid": 1}:
            raise RuntimeError(f"r{rmax}: B1 took routes {b1}, not grid")
        if one.shape != us.shape or not bool(torch.isfinite(one).all()):
            raise RuntimeError(f"r{rmax}: step output is not a finite "
                               f"{tuple(us.shape)} stack")
        ms, v7, v8 = timed_chain(step_fn, us)
        d7, d8 = dense(unpack, v7), dense(unpack, v8)
        rel = float(np.linalg.norm(d8 - exact) / np.linalg.norm(exact))
        res = cn_residual(d8, d7, hg, H_STEP)
        with plain_versions():
            plain_ms, _, p8 = timed_chain(step_fn, us)
        agree = float(np.linalg.norm(d8 - dense(unpack, p8))
                      / np.linalg.norm(d8))
        gflops = cn_step_flops(D, rmax, 4, 4, cg_iters=CG_ITERS + 1) / (
            ms * 1e-3) / 1e9
        SCAN_MS[f"cn r{rmax}"] = ms
        log(f"cn_step d={D} r{rmax}: {ms:.3f} ms/step ({gflops:.2f} "
            f"GFLOP/s) | plain {plain_ms:.3f} ms/step | traj rel "
            f"{rel:.3e} (<= 1e-3) residual {res:.3e} (<= 1e-2) | kernel vs "
            f"plain 8-step rel {agree:.3e} (<= 1e-4) | launches/step "
            f"{per_step} | B1 route {set(b1)} | B2 routes "
            f"{set(b2[0]) | set(b2[1])}{f' | B4 routes {set(b4)}' if b4 else ''}"
            f"{f' | B3 routes {set(b3)}' if b3 else ''}")
        if not (np.isfinite(rel) and rel <= 1e-3 and res <= 1e-2
                and agree <= 1e-4):
            raise RuntimeError(f"cn r{rmax} failed its gates: rel={rel:.3e} "
                               f"residual={res:.3e} agree={agree:.3e}")
    counts = launch_counts()
    missing = [k for k in CN_KERNELS if counts[k] == 0]
    if missing:
        raise RuntimeError(f"main path launched no {missing}")
    return counts


def timed_calls(fn, calls=3):
    """Seconds per call: median of ``calls`` host-timed calls after one
    warm-up, each ended by a synchronize; returns (seconds, last output)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def phase_batched_path(device):
    """Both routes of the batched bench at full width; returns the launch
    counts of each route's first call."""
    from ttnx_torch.core.decomp import ttv_to_tensor
    from ttnx_torch.entry import batched_als_problem
    from ttnx_torch.kernels import als_sweep_fused
    from ttnx_torch.kernels.dispatch import launch_counts, reset_launch_counts
    from ttnx_torch.solvers.als_scan import unpack_tt
    from ttnx_torch.solvers.als_scan_batched import als_sweeps_b
    from ttnx_torch.utils.flops import als_sweeps_flops

    p = batched_als_problem(device, batch=BATCH, rmax=64, d=D, h=H_STEP)
    A, bb, xb, masks = p["lhs_stack"], p["b_batch"], p["x_batch"], p["masks"]
    hg = 1.0 / (2 ** D + 1)
    c = H_STEP / (2 * hg ** 2)
    u0 = ttv_to_tensor(p["u0"]).reshape(-1).double().cpu().numpy()

    def unpack(stack):
        return unpack_tt(stack, p["u_rks"])
    routes = {
        "explicit_kernel": (
            lambda: als_sweeps_b(A, bb, xb, masks, 2, cg_iters=CG_ITERS,
                                 solver="cg_fused"),
            CG_ITERS + 1,
            {"env_chain_fused_batched": 2,
             "cg_matfree_fused_batched": 2 * (D - 1),
             "qr_batched": 2 * (D - 1)}),
        "sweep_pair_fused": (
            lambda: als_sweep_fused.als_fwd_bwd_fused_batched(A, bb, xb,
                                                              masks),
            25, {"als_fwd_bwd_fused_batched": 1}),
    }
    route_counts = {}
    for route, (run, applies, launched) in routes.items():
        reset_launch_counts()
        run()
        torch.cuda.synchronize()
        counts = launch_counts()
        b5 = routes_of("cg_matfree_fused_batched")
        b6 = routes_of("env_chain_fused_batched")
        b7 = routes_of("als_fwd_bwd_fused_batched")
        if route == "explicit_kernel" and b6 != {"resident": 2}:
            raise RuntimeError(f"{route}: B6 took routes {b6}, not both "
                               f"resident")
        want = {k: launched.get(k, 0) for k in counts}
        if counts != want:
            raise RuntimeError(f"{route}: launches per call {counts}, "
                               f"expected {want}")
        route_counts[route] = counts
        if route == "explicit_kernel" and b5 != {"resident": 2 * (D - 1)}:
            raise RuntimeError(f"{route}: B5 took routes {b5}, not all "
                               f"resident")
        sec, out = timed_calls(run)
        with plain_versions():
            plain_sec, plain_out = timed_calls(run)
        if out.shape != xb.shape or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{route}: output is not a finite "
                               f"{tuple(xb.shape)} stack")
        x0 = dense(unpack, out[0])
        lhs = x0 + c * (2 * x0 - np.pad(x0[1:], (0, 1))
                        - np.pad(x0[:-1], (1, 0)))
        res = float(np.linalg.norm(lhs - u0) / np.linalg.norm(u0))
        agree = float(np.linalg.norm(x0 - dense(unpack, plain_out[0]))
                      / np.linalg.norm(x0))
        gflops = BATCH * als_sweeps_flops(D, 64, A.shape[1], 64,
                                          cg_iters=applies) / sec / 1e9
        kernel = (f" | B5 routes {b5}, B6 routes {b6}"
                  if route == "explicit_kernel" else "")
        if route == "sweep_pair_fused":
            name = "als_fwd_bwd_fused_batched"
            bound_ms, by = bound(dict(work=work(name, (A, bb, xb, masks), {},
                                                out)))
            kernel = (f" | B7 routes {b7}: {bound_ms / (sec * 1e3):.3f} of "
                      f"its {by} bound {bound_ms:.3f} ms")
        log(f"batched {route} d={D} r64 B={BATCH} f32: {BATCH / sec:.2f} "
            f"solves/s ({gflops:.2f} GFLOP/s, {sec * 1e3:.1f} ms/call)"
            f"{kernel} | "
            f"plain {BATCH / plain_sec:.2f} solves/s ({plain_sec * 1e3:.1f} "
            f"ms/call) | residual[0] {res:.3e} (<= 1e-2) | kernel vs plain "
            f"vector[0] rel {agree:.3e} (<= 1e-4) | launches/call "
            f"{ {k: v for k, v in counts.items() if v} }")
        if not (np.isfinite(res) and res <= 1e-2 and agree <= 1e-4):
            raise RuntimeError(f"{route} failed its gates: residual={res:.3e}"
                               f" agree={agree:.3e}")
    return route_counts


# ---------------------------------------------------------------------------
# DMRG and TDVP (slice 3)
# ---------------------------------------------------------------------------


def dmrg_sweeps(p, n, solver, x=None, m=None):
    """``n`` chained dmrg_eig_sweeps of problem ``p`` (the bench's options);
    returns (x_stack, masks, energies of the last sweep)."""
    from ttnx_torch.solvers.dmrg_scan import dmrg_eig_sweep

    x = p["x_stack"] if x is None else x
    m = p["masks"] if m is None else m
    E = None
    for _ in range(n):
        x, m, E = dmrg_eig_sweep(p["A_stack"], x, m, p["tol"],
                                 p["degen_tol"], lanczos_iters=DMRG_ITERS,
                                 eig_solver=solver, split="gram")
    return x, m, E


def ritz_err(got, ref):
    """B9 on a sweep's K: the smallest Ritz value (relative) and its unit
    vector up to sign, through the sweep's own Ritz step."""
    from ttnx_torch.solvers.dmrg_scan import _ritz_from_lanczos

    M = got[0].shape[1]
    ones = torch.ones(M, dtype=got[0].dtype, device=got[0].device)
    tg, vg = _ritz_from_lanczos(*got, ones, (M,))
    tr, vr = _ritz_from_lanczos(*ref, ones, (M,))
    dv = min(float((vg - vr).norm()), float((vg + vr).norm()))
    dt = float((tg - tr).abs())
    return max(dt, dv), max(dt / float(tr.abs()), dv)


def spread_K(rng, M, dtype, device):
    """Symmetric K with eigenvalues spread over [-1, 2] and a unit start:
    a well-conditioned Lanczos run, compared row by row."""
    q, _ = np.linalg.qr(rng.standard_normal((M, M)))
    K = (q * np.linspace(-1.0, 2.0, M)) @ q.T
    v0 = rng.standard_normal(M)
    return (torch.as_tensor(0.5 * (K + K.T), dtype=dtype, device=device),
            torch.as_tensor(v0 / np.linalg.norm(v0), dtype=dtype,
                            device=device))


def env_A_inputs(seen):
    """The last B8 call of each direction (right, left) in ``seen``, the
    calls of ENV_A_SWEEPS sweeps: the last sweep's chains run on a state
    grown from the rank-4 start until its envs fill every CTA's slab of
    columns (the first sweep's right chain at d = 12, R = 64 fills one
    slab of 16, the second's nine). Raises if a slab stays zero along the
    chain."""
    last = {}
    for args, kwargs in seen["env_chain_A_fused"]:
        last[bool(kwargs.get("left"))] = (args, kwargs)
    plain = wrappers()["env_chain_A_fused"][1]
    for args, kwargs in last.values():
        envs = plain(*args, **kwargs)
        slabs = envs.abs().amax(dim=(0, 1, 2)).view(-1, 4).amax(dim=1)
        if not bool((slabs > 0).all()):
            raise RuntimeError(f"B8 input leaves {int((slabs == 0).sum())} "
                               f"of {slabs.numel()} env column slabs zero")
    return [last[False], last[True]]


def phase_dmrg_kernels(device):
    """3c: B8 and B9 against their plain versions."""
    from ttnx_torch.entry import dmrg_problem
    from ttnx_torch.kernels.lanczos import can_fuse_lanczos

    rows = []
    for dtype in (torch.float32, torch.float64):
        for d, rmax in DMRG_CONFIGS:
            p = dmrg_problem(device, d=d, rmax=rmax, dtype=dtype)
            fused = can_fuse_lanczos(dtype, 4 * rmax * rmax)
            solver = "lanczos_fused" if fused else "lanczos"
            seen = record_calls(lambda: dmrg_sweeps(p, ENV_A_SWEEPS,
                                                    solver))
            for (args, kwargs) in env_A_inputs(seen):
                tag = " left" if kwargs.get("left") else " right"
                rows.append(hold("env_chain_A_fused", rmax, dtype, args,
                                 kwargs, tag=tag))
                if dtype == torch.float32:
                    deterministic("env_chain_A_fused", args, kwargs)
            if not fused:
                continue
            calls = seen["lanczos_fused"]  # the first sweep's from 0
            if len(calls) != ENV_A_SWEEPS * 2 * (d - 1):
                raise RuntimeError(f"{ENV_A_SWEEPS} sweeps made "
                                   f"{len(calls)} B9 calls")
            (K, v0), _ = calls[MIDDLE_SITE]
            for iters in (8, 24):
                rows.append(hold("lanczos_fused", rmax, dtype, (K, v0),
                                 dict(iters=iters), compare=ritz_err,
                                 tag=f" sweep K, iters {iters}, Ritz pair"))
            if dtype == torch.float32:
                deterministic("lanczos_fused", (K, v0),
                              dict(iters=DMRG_ITERS))
            rng = np.random.default_rng(LANCZOS_M)
            K, v0 = spread_K(rng, LANCZOS_M, dtype, device)
            for iters in (8, 24):
                rows.append(hold("lanczos_fused", rmax, dtype, (K, v0),
                                 dict(iters=iters),
                                 tag=f" spread K, iters {iters}"))
    return rows


def dense_state(x, m):
    from ttnx_torch.core.decomp import ttv_to_tensor
    from ttnx_torch.solvers.als_scan import unpack_tt

    rks = [int(v) for v in m.sum(dim=1).tolist()]
    v = ttv_to_tensor(unpack_tt(x, rks)).reshape(-1).double().cpu().numpy()
    return v / np.linalg.norm(v)


def timed_sweeps(p, solver):
    """ms/sweep: median over 3 chains of DMRG_SWEEPS sweeps from the
    start, after one warm-up sweep; returns (ms, x, masks, energies)."""
    dmrg_sweeps(p, 1, solver)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        x, m, E = dmrg_sweeps(p, DMRG_SWEEPS, solver)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / DMRG_SWEEPS * 1e3)
    return statistics.median(times), x, m, E


def phase_dmrg_path(device):
    """6: the DMRG eigensweeps at full width; returns the launch counts."""
    from ttnx_torch.entry import dense_xxx_groundstate, dmrg_problem
    from ttnx_torch.kernels.dispatch import launch_counts, reset_launch_counts
    from ttnx_torch.utils.flops import dmrg_eig_sweep_flops

    total = {}
    for d, rmax in DMRG_CONFIGS:
        E0 = dense_xxx_groundstate(d)
        p = dmrg_problem(device, d=d, rmax=rmax)
        RA = p["A_stack"].shape[1]
        for solver in (("lanczos", "lanczos_fused") if rmax == 16
                       else ("lanczos",)):
            reset_launch_counts()
            ms, x, m, E = timed_sweeps(p, solver)
            counts = launch_counts()
            for label, name in (("B9", "lanczos_fused"),
                                ("B8", "env_chain_A_fused")):
                taken = routes_of(name)
                if set(taken) - {"cluster"}:
                    raise RuntimeError(f"dmrg d={d} r{rmax} {solver}: "
                                       f"{label} took routes "
                                       f"{sorted(taken)}, not all cluster")
            b8, b9 = routes_of("env_chain_A_fused"), routes_of("lanczos_fused")
            sweeps = 1 + 3 * DMRG_SWEEPS
            want = dict.fromkeys(counts, 0)
            want["env_chain_A_fused"] = 2 * sweeps
            if solver == "lanczos_fused":
                want["lanczos_fused"] = 2 * (d - 1) * sweeps
            if counts != want:
                raise RuntimeError(f"dmrg d={d} r{rmax} {solver}: launches "
                                   f"{counts}, expected {want}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            with plain_versions():
                plain_ms, xp, mp, Ep = timed_sweeps(p, solver)
            e, ep = float(E[-1]), float(Ep[-1])
            rel = abs(e - E0) / abs(E0)
            agree = abs(e - ep) / abs(ep)
            overlap = abs(float(dense_state(x, m) @ dense_state(xp, mp)))
            finite = bool(torch.isfinite(E).all() and torch.isfinite(x).all())
            gflops = dmrg_eig_sweep_flops(d, rmax, RA, 2, DMRG_ITERS) / (
                ms * 1e-3) / 1e9
            per_sweep = {k: v // sweeps for k, v in counts.items() if v}
            SCAN_MS[f"dmrg d{d} r{rmax} {solver}"] = ms
            log(f"dmrg d={d} r{rmax} {solver:13s} f32: {ms:.3f} ms/sweep "
                f"({gflops:.2f} GFLOP/s) | plain {plain_ms:.3f} ms/sweep | "
                f"E {e:.9f} dense {E0:.9f} rel {rel:.3e} (<= 1e-5) | "
                f"ranks {[int(v) for v in m.sum(dim=1).tolist()]} | kernel "
                f"vs plain E rel {agree:.3e} (<= 1e-5) overlap "
                f"{overlap:.9f} (>= 1 - 1e-4) | launches/sweep {per_sweep}"
                f" | B8 routes {set(b8)}"
                f"{f' | B9 routes {set(b9)}' if b9 else ''}")
            if not (finite and rel <= 1e-5 and agree <= 1e-5
                    and overlap >= 1 - 1e-4):
                raise RuntimeError(f"dmrg d={d} r{rmax} {solver} failed its "
                                   f"gates: finite={finite} rel={rel:.3e} "
                                   f"agree={agree:.3e} overlap={overlap}")
    return total


def phase_tdvp_path(device):
    """7: TDVP steps against the analytic decay, and the batched DMRG
    sweeps against single runs; returns the launch counts of the batch."""
    from ttnx_torch.core.decomp import ttv_to_tensor
    from ttnx_torch.entry import dmrg_problem, tdvp_problem
    from ttnx_torch.kernels.dispatch import launch_counts, reset_launch_counts
    from ttnx_torch.ops.operators import xxz_tto
    from ttnx_torch.parallel.batch import batched_dmrg_eig_sweeps
    from ttnx_torch.solvers.als_scan import pack_op, rank_masks, unpack_tt
    from ttnx_torch.solvers.dmrg_scan import dmrg_eig_sweep
    from ttnx_torch.solvers.tdvp_scan import tdvp1_step, tdvp2_step

    p = tdvp_problem(device, d=TDVP_D, rmax=TDVP_RMAX)
    A, u0 = p["A_stack"], p["u0"]
    m2 = rank_masks(u0.ranks, TDVP_RMAX, dtype=torch.float32, device=device)

    def tdvp1(n):
        x = p["x_stack"]
        for _ in range(n):
            x = tdvp1_step(A, x, p["masks"], TDVP_H, krylov_dim=8,
                           imag_real=True)
        return x, p["masks"]

    def tdvp2(n):
        x, m = p["x_stack"], m2
        for _ in range(n):
            x, m = tdvp2_step(A, x, m, TDVP_H, 0.0, TDVP_RMAX, krylov_dim=10,
                              imag_real=True, split="gram")
        return x, m

    u0d = ttv_to_tensor(u0).reshape(-1).double().cpu().numpy()
    for name, run, n in (("tdvp1_step", tdvp1, 16), ("tdvp2_step", tdvp2, 8)):
        sec, (x, m) = timed_calls(lambda: run(n))
        rks = [int(v) for v in m.sum(dim=1).tolist()]
        got = ttv_to_tensor(unpack_tt(x, rks)).reshape(-1).double().cpu()
        expect = u0d * np.exp(-p["lam1"] * n * TDVP_H)
        rel = float(np.linalg.norm(got.numpy() - expect)
                    / np.linalg.norm(expect))
        SCAN_MS[name] = sec / n * 1e3
        log(f"{name} d={TDVP_D} r{TDVP_RMAX} h={TDVP_H} f32 imag_real: "
            f"{sec / n * 1e3:.3f} ms/step ({n} steps, median of 3) | rel "
            f"to the analytic decay {rel:.3e} (<= 1e-3) | ranks {rks}")
        if not (np.isfinite(rel) and rel <= 1e-3):
            raise RuntimeError(f"{name} failed its gate: rel={rel:.3e}")

    d, rmax, B = DMRG_CONFIGS[0][0], DMRG_CONFIGS[0][1], 4
    fields = [0.0, 0.25, 0.5, 0.75]  # transverse: distinct ground states
    A6 = torch.stack([pack_op(xxz_tto(d, delta=0.5, h=f, field="x",
                                      device=device).astype(torch.float32), 5)
                      for f in fields[:B]])
    starts = [dmrg_problem(device, d=d, rmax=rmax, seed=3 + i)
              for i in range(B)]
    xb = torch.stack([s["x_stack"] for s in starts])
    mb = torch.stack([s["masks"] for s in starts])
    tol = starts[0]["tol"]
    reset_launch_counts()
    t0 = time.perf_counter()
    _, _, Eb = batched_dmrg_eig_sweeps(A6, xb, mb, tol, tol, n_sweeps=2,
                                       lanczos_iters=DMRG_ITERS, split="gram")
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = launch_counts()
    if counts["env_chain_A_fused"] != 2 * 2 * B:
        raise RuntimeError(f"batched dmrg: launches {counts}")
    b8 = routes_of("env_chain_A_fused")
    if set(b8) - {"cluster"}:
        raise RuntimeError(f"batched dmrg: B8 took routes {sorted(b8)}, not "
                           f"all cluster")
    singles = []
    for i in range(B):
        x, m, Es = xb[i], mb[i], []
        for _ in range(2):
            x, m, E = dmrg_eig_sweep(A6[i], x, m, tol, tol,
                                     lanczos_iters=DMRG_ITERS, split="gram")
            Es.append(E)
        singles.append(torch.cat(Es))
    same = torch.equal(Eb, torch.stack(singles))
    log(f"batched_dmrg_eig_sweeps XXZ d={d} r{rmax} B={B} fields {fields} "
        f"f32 2 sweeps: {sec * 1e3:.1f} ms | last energies "
        f"{[round(float(e), 6) for e in Eb[:, -1]]} | equal to the single "
        f"runs: {same} | B8 launches {counts['env_chain_A_fused']} on "
        f"route {set(b8)}")
    if not (same and bool(torch.isfinite(Eb).all())):
        raise RuntimeError("batched dmrg differs from the single runs")
    return counts


# ---------------------------------------------------------------------------
# Convection-diffusion CN and the contraction chain (slice 4)
# ---------------------------------------------------------------------------


def conv_setup(device, dtype=torch.float32):
    """The convection CN step on the three-mode state, and the dense f64
    start."""
    from ttnx_torch.entry import convection_cn_step, three_mode_state

    hg = 1.0 / (2 ** D + 1)
    step_fn, pack, unpack = convection_cn_step(
        device, rmax=CONV_RMAX, d=D, h=H_STEP, c=CONV_C, dtype=dtype,
        bicg_iters=BICG_ITERS)
    u0 = three_mode_state(D, hg, device)
    return step_fn, pack(u0), unpack, dense(lambda u: u, u0)


def as_float(compare):
    return lambda got, ref: compare(got.float(), ref.float())


def singular_site_report(args, kwargs):
    """B10 on the forward sweep's K at MIDDLE_SITE, which is singular to
    rounding: its conditioning, and kernel against plain by residual and
    by solution (a report, not a gate)."""
    from ttnx_torch.kernels.local_cg import (bicgstab_solve_fused,
                                             bicgstab_solve_plain)

    K, rhs = args
    Kd, bd = K.double().cpu().numpy(), rhs.double().cpu().numpy()
    sv = np.linalg.svd(Kd, compute_uv=False)
    got = bicgstab_solve_fused(K, rhs, **kwargs).double().cpu().numpy()
    ref = bicgstab_solve_plain(K, rhs, **kwargs).double().cpu().numpy()

    def res(x):
        return np.linalg.norm(Kd @ x - bd) / np.linalg.norm(bd)

    log(f"B10 report {str(K.dtype)[6:]} local solve {MIDDLE_SITE} (forward "
        f"site {MIDDLE_SITE}): singular values {sv[-1]:.3e} .. {sv[0]:.3e} "
        f"(cond {sv[0] / sv[-1]:.3e}) | residual kernel {res(got):.3e} "
        f"plain {res(ref):.3e} | kernel vs plain max rel "
        f"{np.abs(got - ref).max() / np.abs(ref).max():.3e}")


def fro_err(got, ref):
    """(max abs err, relative Frobenius err) in float32."""
    got, ref = got.float(), ref.float()
    return (float((got - ref).abs().max()),
            float((got - ref).norm() / ref.norm()))


def norm_keeping_hold(device):
    """B11 at the bench shape and 2048 iterations on the norm-keeping
    input, bf16: rel Frobenius <= 1e-3 against the plain version, output
    norm within 1 % of the input's."""
    from ttnx_torch.entry import norm_keeping_contraction_problem
    from ttnx_torch.kernels.contraction import merge_resplit_chain

    p = norm_keeping_contraction_problem(device)
    args = (p["a"], p["b"], p["w"])
    row = hold("merge_resplit_chain", 64, torch.bfloat16, args,
               dict(iters=CHAIN_ITERS), 1, 1,
               f" iters {CHAIN_ITERS} norm-keeping", fro_err, 1e-3)
    out = merge_resplit_chain(*args, iters=CHAIN_ITERS).float()
    a = p["a"].float()
    ratio = float(out.norm() / a.norm())
    moved = float((out - a).norm() / a.norm())
    log(f"B11 norm-keeping bf16 {tuple(a.shape)} iters {CHAIN_ITERS}: "
        f"|out| / |a| {ratio:.7f} (within 1 %) | |out - a| / |a| "
        f"{moved:.3e} (the roundings' drift)")
    if not (np.isfinite(ratio) and abs(ratio - 1.0) <= 1e-2):
        raise RuntimeError(f"B11 norm-keeping: norm ratio {ratio}")
    return row


def norm_keeping_matmul_hold(device):
    """B12 at the bench shape and 1024 iterations on its norm-keeping
    input, bf16: rel Frobenius <= 1e-3 against the plain version, output
    norm within 1 % of the input's."""
    from ttnx_torch.entry import norm_keeping_matmul_problem
    from ttnx_torch.kernels.contraction import matmul_chain

    q = norm_keeping_matmul_problem(device)
    row = hold("matmul_chain", 128, torch.bfloat16, (q["x"], q["w"]),
               dict(iters=CEIL_ITERS), 1, 1,
               f" iters {CEIL_ITERS} norm-keeping", fro_err, 1e-3)
    out = matmul_chain(q["x"], q["w"], iters=CEIL_ITERS).float()
    x = q["x"].float()
    ratio = float(out.norm() / x.norm())
    log(f"B12 norm-keeping bf16 {tuple(x.shape)} iters {CEIL_ITERS}: "
        f"|out| / |x| {ratio:.7f} (within 1 %)")
    if not (np.isfinite(ratio) and abs(ratio - 1.0) <= 1e-2):
        raise RuntimeError(f"B12 norm-keeping: norm ratio {ratio}")
    return row


def deterministic(name, args, kwargs):
    """Two launches of a kernel on the same inputs give the same bits."""
    from ttnx_torch.kernels.dispatch import route_counts

    kernel = wrappers()[name][0]
    before = route_counts()
    first, again = kernel(*args, **kwargs), kernel(*args, **kwargs)
    torch.cuda.synchronize()
    if torch.is_tensor(first):
        first, again = (first,), (again,)
    same = all(torch.equal(f, a) for f, a in zip(first, again))
    log(f"kernel {KERNELS[name][0]} {name} routes "
        f"{routes_of(name, before)}: two launches bit-identical {same}")
    if not same:
        raise RuntimeError(f"{name}: two launches differ")


def phase_new_kernels(device):
    """3d: B10-B13 against their plain versions."""
    from ttnx_torch.entry import contraction_problem, matmul_ceiling_problem

    rows = []
    for dtype in (torch.float32, torch.float64):
        step_fn, us, _, _ = conv_setup(device, dtype)
        seen = record_calls(lambda: step_fn(us))
        singular_site_report(*seen["bicgstab_solve_fused"][MIDDLE_SITE])
        args, kwargs = seen["bicgstab_solve_fused"][CONV_SITE]
        rows.append(hold("bicgstab_solve_fused", CONV_RMAX, dtype, args,
                         kwargs, tag=" convection K"))
        deterministic("bicgstab_solve_fused", args, kwargs)
        M = 999
        rng = np.random.default_rng(M)
        K = rng.standard_normal((M, M)) / np.sqrt(M) + 2.0 * np.eye(M)
        K, rhs = (torch.as_tensor(a, dtype=dtype, device=device)
                  for a in (K, rng.standard_normal(M)))
        rows.append(hold("bicgstab_solve_fused", CONV_RMAX, dtype, (K, rhs),
                         dict(iters=BICG_ITERS), tag=" M=999 diag-dominant"))
    short = dict(iters=SHORT_ITERS)
    for dtype in (torch.bfloat16, torch.float32):
        p = contraction_problem(device, dtype=dtype)
        q = matmul_ceiling_problem(device, dtype=dtype)
        bf = dtype == torch.bfloat16
        reps, repeats = (10, 5) if bf else (3, 3)
        rows.append(hold(
            "merge_resplit_chain", 64, dtype, (p["a"], p["b"], p["w"]),
            short, reps, repeats, f" iters {SHORT_ITERS}", as_float(max_err),
            2 * SHORT_ITERS * BF16_ULP if bf else 1e-4))
        rows.append(hold(
            "matmul_chain", 128, dtype, (q["x"], q["w"]), short, reps,
            repeats, f" iters {SHORT_ITERS}", as_float(max_err),
            SHORT_ITERS * BF16_ULP if bf else 1e-4))
        rows.append(hold("two_site_merge", 64, dtype, (p["a"], p["b"]), {},
                         reps, repeats, " merge", as_float(max_err), 1e-5))
    rows.append(norm_keeping_hold(device))
    rows.append(norm_keeping_matmul_hold(device))
    return rows


@contextlib.contextmanager
def forced_env_route(route):
    """Inside the block every B2 and B6 launch takes ``route``."""
    from ttnx_torch.kernels import env_chain

    chosen = env_chain.env_route
    env_chain.env_route = lambda *shape: route
    try:
        yield
    finally:
        env_chain.env_route = chosen


def profiler(activities):
    """A torch.profiler window that keeps every event of the window (no
    cycle clears them, where the installed torch has the option)."""
    from torch.profiler import profile

    try:
        return profile(activities=activities, acc_events=True)
    except TypeError:
        return profile(activities=activities)


def device_ms(run, n, part=""):
    """(wall ms, device kernel ms, kernels, device ms of the kernels whose
    name holds ``part``) a call of ``run`` over ``n`` calls in one
    torch.profiler window, after one warm call."""
    from torch.profiler import ProfilerActivity

    run()
    torch.cuda.synchronize()
    with profiler([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    dev, kernels, some = 0.0, 0, 0.0
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "device_time", None)
            t = e.cuda_time if t is None else t
            dev += t
            kernels += 1
            some += t if part and part in e.name else 0.0
    return wall, dev / n / 1e3, kernels / n, some / n / 1e3


def phase_env_routes(device):
    """3e: B2 (r16, r32, r64, right and left) and B6 (B = BATCH) timed by
    route, interleaved (new, staged, staged, new), then the device time of
    the CN r64 step with the B2 route forced each way (torch.profiler)."""
    cases = []
    for rmax in RANKS:
        inputs = capture_inputs(rmax, device, torch.float32)
        for name, side in zip(B2, (" right", " left")):
            cases.append((f"B2 r{rmax}{side}", name, *inputs[name], 10,
                          "cluster"))
    seen = bench_batch_calls(device)
    for call, side in zip(seen["env_chain_fused_batched"],
                          (" right", " left")):
        cases.append((f"B6 B={BATCH}{side}", "env_chain_fused_batched",
                      *call, 1, "resident"))
    for label, name, args, kwargs, reps, new in cases:
        kernel = wrappers()[name][0]
        times = []
        for route in (new, "staged", "staged", new):
            with forced_env_route(route):
                times.append(cuda_ms(lambda: kernel(*args, **kwargs), reps,
                                     3))
        log(f"interleaved {label} ({new}, staged, staged, {new}): "
            f"{', '.join(f'{t:.4f}' for t in times)} ms")
    # the profiles of the CN r16 step and of the explicit batched call
    # (PR 11's measurement, PERF.md) are cut to keep the run in its time
    step_fn, us, _ = setup(64, device)
    for route in ("cluster", "staged"):
        with forced_env_route(route):
            wall, dev, kernels, env = device_ms(lambda: step_fn(us), N_STEPS,
                                                "ttnx_env")
        log(f"profile cn_step d={D} r64, B2/B6 route {route}: wall "
            f"{wall:.3f} ms, device kernels {dev:.3f} ms a call "
            f"({kernels:.0f} kernels; B2/B6 {env:.3f} ms), busy share "
            f"{dev / wall:.3f}")


@contextlib.contextmanager
def forced_gram_envA_route(route):
    """Inside the block every B1 and B8 launch takes route ``staged``, or
    the route its wrapper chooses (``route == "new"``)."""
    from ttnx_torch.kernels import env_chain, gram

    saved = gram.gram_route, env_chain.env_A_route
    if route == "staged":
        gram.gram_route = lambda *shape: "staged"
        env_chain.env_A_route = lambda *shape: "staged"
    try:
        yield
    finally:
        gram.gram_route, env_chain.env_A_route = saved


def phase_gram_envA_routes(device):
    """3f: B1 (RB = 64, 128, 256) and B8 ((d, R) = (10, 16), (12, 64),
    right and left) timed by route, interleaved (new, staged, staged, new),
    then the device time of a CN r64 step and of a DMRG d = 12 sweep with
    the B1/B8 route forced each way (torch.profiler)."""
    from ttnx_torch.entry import dmrg_problem
    from ttnx_torch.kernels.dispatch import route_counts

    cases = []
    for rmax in RANKS:
        args, kwargs = capture_inputs(rmax, device,
                                      torch.float32)["gram_chain_fused"]
        cases.append((f"B1 r{rmax} RB={args[0].shape[1]}",
                      "gram_chain_fused", args, kwargs))
    for d, rmax in DMRG_CONFIGS:
        p = dmrg_problem(device, d=d, rmax=rmax)
        seen = record_calls(lambda: dmrg_sweeps(p, ENV_A_SWEEPS,
                                                "lanczos"))
        for args, kwargs in env_A_inputs(seen):
            side = "left" if kwargs.get("left") else "right"
            cases.append((f"B8 d={d} r{rmax} {side}", "env_chain_A_fused",
                          args, kwargs))
    for label, name, args, kwargs in cases:
        kernel = wrappers()[name][0]
        times, taken = [], []
        for route in ("new", "staged", "staged", "new"):
            with forced_gram_envA_route(route):
                before = route_counts()
                times.append(cuda_ms(lambda: kernel(*args, **kwargs), 10, 3))
                taken.append("/".join(routes_of(name, before)))
        log(f"interleaved {label} ({', '.join(taken)}): "
            f"{', '.join(f'{t:.4f}' for t in times)} ms")
        if taken[0] == "staged" or min(times[0], times[3]) >= min(times[1:3]):
            raise RuntimeError(f"{label}: route {taken[0]} is not faster "
                               f"than staged")
    step_fn, us, _ = setup(64, device)
    p = dmrg_problem(device, d=12, rmax=64)
    runs = ((f"cn_step d={D} r64", lambda: step_fn(us), N_STEPS,
             "ttnx_gram"),
            ("dmrg d=12 r64 sweep", lambda: dmrg_sweeps(p, 1, "lanczos"), 2,
             "ttnx_env"))
    for label, run, n, part in runs:
        for route in ("new", "staged"):
            with forced_gram_envA_route(route):
                wall, dev, kernels, some = device_ms(run, n, part)
            log(f"profile {label}, B1/B8 route {route}: wall {wall:.3f} ms, "
                f"device kernels {dev:.3f} ms a call ({kernels:.0f} "
                f"kernels; {'B1' if part == 'ttnx_gram' else 'B8'} "
                f"{some:.3f} ms), busy share {dev / wall:.3f}")


def phase_convection_path(device):
    """8: the convection-diffusion CN step; returns the launch counts.
    ``I -/+ h/2 A`` is tridiagonal Toeplitz, of exact QTT rank 3: the step
    packs it at RA = 4, so RB = 4 CONV_RMAX = 64 takes B1's route grid and
    B2 its route cluster."""
    from ttnx_torch.entry import (convection_cn_operators, convection_operator,
                                  dense_cn_reference)
    from ttnx_torch.kernels.dispatch import launch_counts, reset_launch_counts
    from ttnx_torch.solvers.round_scan import _cn_parts
    from ttnx_torch.utils.flops import cn_step_bicgstab_flops

    hg = 1.0 / (2 ** D + 1)
    step_fn, us, unpack, u0 = conv_setup(device)
    reset_launch_counts()
    one = step_fn(us)
    torch.cuda.synchronize()
    per_step = launch_counts()
    b1 = routes_of("gram_chain_fused")
    b2 = [routes_of(name) for name in B2]
    want = dict.fromkeys(per_step, 0)
    want.update({"gram_chain_fused": 1, "right_env_chain_fused": 1,
                 "left_env_chain_fused": 1,
                 "bicgstab_solve_fused": 2 * (D - 1)})
    if per_step != want:
        raise RuntimeError(f"convection: launches per step {per_step}, "
                           f"expected {want}")
    b10 = routes_of("bicgstab_solve_fused")
    if b10 != {"cluster": 2 * (D - 1)}:
        raise RuntimeError(f"convection: B10 took routes {b10}, not all "
                           f"cluster")
    if b1 != {"grid": 1}:
        raise RuntimeError(f"convection: B1 took routes {b1}, not grid")
    if b2 != [{"cluster": 1}] * 2:
        raise RuntimeError(f"convection: B2 took routes {b2}, not cluster")
    if one.shape != us.shape or not bool(torch.isfinite(one).all()):
        raise RuntimeError("convection: step output is not a finite stack")
    ms, v7, v8 = timed_chain(step_fn, us)
    counts = launch_counts()
    d7, d8 = dense(unpack, v7), dense(unpack, v8)
    exact = dense_cn_reference(D, hg, H_STEP, CONV_C, u0, N_STEPS)
    rel = float(np.linalg.norm(d8 - exact) / np.linalg.norm(exact))
    moved = float(np.linalg.norm(exact - u0) / np.linalg.norm(u0))
    lhs, rhs = convection_cn_operators(D, hg, H_STEP, CONV_C)
    res = float(np.linalg.norm(lhs @ d8 - rhs @ d7)
                / np.linalg.norm(rhs @ d7))
    with plain_versions():
        plain_ms, _, p8 = timed_chain(step_fn, us)
    agree = float(np.linalg.norm(d8 - dense(unpack, p8))
                  / np.linalg.norm(d8))
    # the step's packed operator rank, its operands formed on the host
    RA = _cn_parts(convection_operator(D, CONV_C, "cpu"), H_STEP, CONV_RMAX,
                   (2,) * D, (1,) + (CONV_RMAX,) * (D - 1) + (1,),
                   torch.float32)["RA"]
    gflops = cn_step_bicgstab_flops(D, CONV_RMAX, RA, RA,
                                    bicg_iters=BICG_ITERS) / (ms * 1e-3) / 1e9
    log(f"convection cn_step d={D} r{CONV_RMAX} c={CONV_C:g} f32 "
        f"bicgstab_fused: {ms:.3f} ms/step ({gflops:.2f} GFLOP/s) | plain "
        f"{plain_ms:.3f} ms/step | rel to the sparse-LU oracle {rel:.3e} "
        f"(<= 1e-3; the state moved {moved:.3e}) residual {res:.3e} (<= "
        f"1e-2) | kernel vs plain 8-step rel {agree:.3e} (<= 1e-4) | "
        f"launches/step { {k: v for k, v in per_step.items() if v} } | "
        f"B10 route {b10} | B1 route {set(b1)} | B2 routes "
        f"{set(b2[0]) | set(b2[1])} | RA {RA}")
    if not (np.isfinite(rel) and rel <= 1e-3 and res <= 1e-2
            and agree <= 1e-4):
        raise RuntimeError(f"convection failed its gates: rel={rel:.3e} "
                           f"residual={res:.3e} agree={agree:.3e}")
    return counts


def library_bmm_ms(a, b):
    """One PyTorch call computing B13's function (bf16 in, f32 out), or
    None where the installed torch has no such call."""
    try:
        torch.bmm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as err:
        log(f"library: torch.bmm(..., out_dtype=float32) unavailable: "
            f"{str(err).splitlines()[0]}")
        return None
    return cuda_ms(lambda: torch.bmm(a, b, out_dtype=torch.float32))


def phase_contraction_path(device):
    """9: the contraction path at the bench's shapes in bf16; returns (the
    launch counts, one row per kernel)."""
    from ttnx_torch.entry import (contraction_problem, matmul_ceiling_problem,
                                  norm_keeping_contraction_problem,
                                  norm_keeping_matmul_problem)
    from ttnx_torch.kernels import contraction as ct
    from ttnx_torch.kernels.dispatch import launch_counts, reset_launch_counts
    from ttnx_torch.utils.flops import (contraction_chain_flops,
                                        matmul_chain_flops)

    p = contraction_problem(device)
    q = matmul_ceiling_problem(device)
    B, r2, r = p["a"].shape
    n = r2 // r
    bw = torch.bmm(p["b"].float(), p["w"].float()).cpu().numpy()
    rho = np.abs(np.linalg.eigvals(bw)).max(axis=1)
    start = float(p["a"].float().norm())
    decay = {it: float(ct.merge_resplit_chain(p["a"], p["b"], p["w"],
                                              iters=it).float().norm())
             / start for it in (8, 64, 256, 2048)}
    nk = norm_keeping_contraction_problem(device)
    kept = float(ct.merge_resplit_chain(nk["a"], nk["b"], nk["w"],
                                        iters=CHAIN_ITERS).float().norm()
                 / nk["a"].float().norm())
    nq = norm_keeping_matmul_problem(device)
    kept12 = float(ct.matmul_chain(nq["x"], nq["w"], iters=CEIL_ITERS)
                   .float().norm() / nq["x"].float().norm())
    decay12 = float(ct.matmul_chain(q["x"], q["w"], iters=CEIL_ITERS)
                    .float().norm() / q["x"].float().norm())
    log(f"contraction chain: spectral radius of b w median "
        f"{np.median(rho):.3f} max {rho.max():.3f} (bf16 factors) | "
        f"|acc| / |a| after {list(decay)} iterations (B11, bf16): "
        f"{[f'{v:.3e}' for v in decay.values()]} | norm-keeping input "
        f"(b w = I): |acc| / |a| after {CHAIN_ITERS} iterations "
        f"{kept:.7f} | B12 |x| / |x0| after {CEIL_ITERS} iterations: bench "
        f"input {decay12:.3e}, norm-keeping input (w w^T = I) "
        f"{kept12:.7f}")
    runs = {
        "two_site_merge": (lambda: ct.two_site_merge(p["a"], p["b"]),
                           (p["a"], p["b"]), {}, 2.0 * B * r2 * r * r2),
        "merge_resplit_chain": (
            lambda: ct.merge_resplit_chain(p["a"], p["b"], p["w"],
                                           iters=CHAIN_ITERS),
            (p["a"], p["b"], p["w"]), dict(iters=CHAIN_ITERS),
            contraction_chain_flops(B, r, n, CHAIN_ITERS)),
        "matmul_chain": (
            lambda: ct.matmul_chain(q["x"], q["w"], iters=CEIL_ITERS),
            (q["x"], q["w"]), dict(iters=CEIL_ITERS),
            matmul_chain_flops(*q["x"].shape, CEIL_ITERS)),
    }
    reset_launch_counts()
    outs = {name: run() for name, (run, *_) in runs.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    want = dict.fromkeys(counts, 0)
    want.update(dict.fromkeys(runs, 1))
    if counts != want:
        raise RuntimeError(f"contraction: launches {counts}, expected {want}")
    for name in ("merge_resplit_chain", "matmul_chain"):
        if routes_of(name) != {"wgmma": 1}:
            raise RuntimeError(f"contraction: {name} took routes "
                               f"{routes_of(name)}, not wgmma")
    rows = []
    for name, (run, args, kw, flops) in runs.items():
        out = outs[name]
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{name}: output is not finite")
        reps, repeats = (10, 5) if name == "two_site_merge" else (1, 3)
        ms = cuda_ms(run, reps, repeats)
        with plain_versions():
            plain_ms = cuda_ms(run, reps, repeats)
        row = dict(name=name, rmax=r, dtype=p["a"].dtype, ms=ms,
                   plain_ms=plain_ms, tag=" path", work=work(name, args, kw,
                                                             out),
                   library_ms=(library_bmm_ms(*args)
                               if name == "two_site_merge" else None))
        bound_ms, by = bound(row)
        route = row["route"] = getattr(wrappers()[name][0], "route", None)
        log(f"contraction {KERNELS[name][0]} {name} bf16 "
            f"{tuple(args[0].shape)} {kw}"
            f"{f' route {route}' if route else ''}: {ms:.3f} ms "
            f"({flops / ms / 1e6:.1f} GFLOP/s, "
            f"{bound_ms / ms:.3f} of the {by} bound {bound_ms:.4f} ms) | "
            f"plain {plain_ms:.3f} ms | library {row['library_ms']} ms | "
            f"output {tuple(out.shape)} {str(out.dtype)[6:]}, max |x| "
            f"{float(out.float().abs().max()):.3e}, zero share "
            f"{float((out == 0).float().mean()):.3f}")
        rows.append(row)
    return counts, rows


# ---------------------------------------------------------------------------
# QTT constructors, ALS eigensolve and MALS (slice 13)
# ---------------------------------------------------------------------------


def tridiag(n, alpha, beta, gamma):
    """alpha*I + beta*superdiag + gamma*subdiag (numpy)."""
    return (alpha * np.eye(n) + beta * np.eye(n, k=1)
            + gamma * np.eye(n, k=-1))


def held(label, ok, err):
    """Log one closed-form comparison; raise if it fails."""
    log(f"qtt {label}: max abs err {err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"qtt {label} disagrees with its closed form "
                           f"(max abs err {err:.3e})")


def allclose(label, got, ref):
    """``np.allclose``'s test (rtol 1e-5, atol 1e-8), the reference tests'
    own, on the card."""
    ref = torch.as_tensor(ref, device=got.device)
    err = float((got - ref).abs().max())
    held(label, bool(torch.allclose(got, ref)), err)


def constructors_on_card(device):
    """10a: the constructors at d = QTT_D in f64 (complex128 for Fourier)
    against the closed forms of their reference tests."""
    import ttnx_torch as tx

    d, N = QTT_D, 2 ** QTT_D
    lap = tridiag(N, 2, -1, -1)
    bc = {}
    for name, first, last in (("DN", 2, 1), ("ND", 1, 2), ("NN", 1, 1)):
        bc[name] = lap.copy()
        bc[name][0, 0], bc[name][-1, -1] = first, last
    per = lap.copy()
    per[0, -1] = per[-1, 0] = -1
    for label, op, ref in (("laplacian", tx.laplacian, lap),
                           ("laplacian_DN", tx.laplacian_DN, bc["DN"]),
                           ("laplacian_ND", tx.laplacian_ND, bc["ND"]),
                           ("laplacian_NN", tx.laplacian_NN, bc["NN"]),
                           ("laplacian_P", tx.laplacian_P, per),
                           ("shift", tx.shift, tridiag(N, 0, 1, 0)),
                           ("gradient", tx.gradient, tridiag(N, 1, 0, -1))):
        allclose(f"qtto_to_matrix({label}({d}))",
                 tx.qtto_to_matrix(op(d, device=device)), ref)
    prod = tx.inv_laplacian_DN(d, device=device) @ tx.laplacian_DN(
        d, device=device)
    allclose(f"inv_laplacian_DN({d}) @ laplacian_DN({d})",
             tx.qtto_to_matrix(prod), np.eye(N))

    gen = torch.Generator().manual_seed(QTT_D)
    x = tx.rand_tt(gen, (2,) * d, rmax=4, normalise=True).to(device)
    y = tx.fourier_qtto(d, device=device) @ tx.reverse_qtt_bits(x)
    spec = tx.qtt_to_vector(y)
    ref = torch.fft.fft(tx.qtt_to_vector(x).to(torch.complex128)) / N ** 0.5
    rel = float((spec - ref).norm() / ref.norm())
    held(f"fourier_qtto({d}) @ reverse_qtt_bits(x) vs torch.fft.fft "
         f"(rel {rel:.3e} <= 1e-10)", rel <= 1e-10,
         float((spec - ref).abs().max()))

    xs = np.arange(N) / (N - 1)
    for label, tt, ref in (
            ("function_to_qtt(sin(pi x) exp(x))",
             tx.function_to_qtt(lambda t: np.sin(np.pi * t) * np.exp(t), d,
                                device=device),
             np.sin(np.pi * xs) * np.exp(xs)),
            ("qtt_cos(lam=3)", tx.qtt_cos(d, lam=3.0, device=device),
             np.cos(3.0 * np.pi * xs)),
            ("qtt_exp(1.3 x - 0.2)", tx.qtt_exp(d, alpha=1.3, beta=-0.2,
                                                 device=device),
             np.exp(1.3 * xs - 0.2)),
            ("qtt_polynom(1 - 2x + x^2/2 + 3x^3)",
             tx.qtt_polynom([1.0, -2.0, 0.5, 3.0], d, device=device),
             1 - 2 * xs + 0.5 * xs ** 2 + 3 * xs ** 3)):
        got = tx.qtt_to_vector(tt)
        err = float((got - torch.as_tensor(ref, device=device)).abs().max())
        held(f"{label} at d={d} (atol 1e-12)", err <= 1e-12, err)

    bits = LAP2D_BITS
    n, h = 2 ** bits, 1.0 / (2 ** bits - 1)
    t0 = time.perf_counter()
    L = tx.qtt_laplacian(2, bits, "interleaved", device=device)
    built = time.perf_counter() - t0
    q = tx.function_to_qttv(
        lambda c: np.sin(np.pi * c[..., 0]) * np.sin(np.pi * c[..., 1]), 2,
        bits, device=device)
    got = tx.qttv_to_array(L @ q)
    grid = np.sin(np.pi * np.arange(n) * h)
    F = grid[:, None] * grid[None, :]

    def dn(v):  # the DN stencil along axis 0, the Neumann row last
        out = 2 * v
        out[:-1] -= v[1:]
        out[1:] -= v[:-1]
        out[-1] -= v[-1]
        return out / h ** 2

    allclose(f"qtt_laplacian(2, {bits}) @ function_to_qttv(sin sin) "
             f"(operator ranks up to {max(L.ranks)}, built in {built:.1f} s "
             f"on the host)", got, dn(F) + dn(F.T).T)


def phase_qtt_path(device):
    """10: the QTT constructors on the card, the ALS eigensolve (B8), and
    the MALS linear solve and eigensolve; returns the launch counts of the
    ALS eigensolve."""
    from ttnx_torch.core.decomp import ttv_to_tensor
    from ttnx_torch.entry import (als_eig_problem, dense_xxx_groundstate,
                                  mals_problem)
    from ttnx_torch.kernels.dispatch import launch_counts, reset_launch_counts
    from ttnx_torch.solvers.als_scan import als_eigsolve_scan
    from ttnx_torch.solvers.mals_scan import (mals_eigsolve_scan,
                                              mals_linsolve_scan)

    def unit(x):
        v = ttv_to_tensor(x).reshape(-1).double().cpu().numpy()
        return v / np.linalg.norm(v)

    def wall(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    timed("10a", constructors_on_card, device)

    # 10b: the ALS eigensolve, f32, B8 on both env stacks of each sweep
    d, rmax = ALS_EIG
    E0 = dense_xxx_groundstate(d)
    p = als_eig_problem(device, d=d, rmax=rmax, dtype=torch.float32)

    def als():
        return als_eigsolve_scan(p["A"], p["x0"], n_sweeps=ALS_EIG_SWEEPS)

    als_eigsolve_scan(p["A"], p["x0"], n_sweeps=1)  # warm-up
    reset_launch_counts()
    ms, (E, x) = wall(als)
    counts = launch_counts()
    b8 = routes_of("env_chain_A_fused")
    want = dict.fromkeys(counts, 0)
    want["env_chain_A_fused"] = 2 * ALS_EIG_SWEEPS
    with plain_versions():
        plain_ms, (Ep, xp) = wall(als)
    rel = abs(E[-1] - E0) / abs(E0)
    agree = abs(E[-1] - Ep[-1]) / abs(Ep[-1])
    overlap = abs(float(unit(x) @ unit(xp)))
    finite = bool(np.isfinite(E).all())
    bounded = bool((E >= E0 - 1e-5 * abs(E0)).all())
    log(f"als_eigsolve d={d} r{rmax} f32: {ms / ALS_EIG_SWEEPS:.3f} "
        f"ms/sweep | plain {plain_ms / ALS_EIG_SWEEPS:.3f} ms/sweep | E "
        f"{E[-1]:.9f} dense {E0:.9f} rel {rel:.3e} (<= 1e-5) | min E - E0 "
        f"{float(E.min() - E0):.3e} | kernel vs plain E rel {agree:.3e} "
        f"(<= 1e-5) overlap {overlap:.9f} (>= 1 - 1e-4) | B8 launches "
        f"{counts['env_chain_A_fused']} routes {b8}")
    if not (finite and bounded and rel <= 1e-5 and agree <= 1e-5
            and overlap >= 1 - 1e-4 and counts == want
            and not set(b8) - {"cluster"}):
        raise RuntimeError(f"als_eigsolve failed its gates: finite={finite} "
                           f"bounded={bounded} rel={rel:.3e} "
                           f"agree={agree:.3e} overlap={overlap} launches "
                           f"{counts} routes {b8}")
    seen = record_calls(als)
    for args, kwargs in env_A_inputs(seen):
        side = " right" if not kwargs.get("left") else " left"
        hold("env_chain_A_fused", rmax, torch.float32, args, kwargs,
             tag=f" als{side}")
        deterministic("env_chain_A_fused", args, kwargs)

    # 10c: the MALS linear solve, f64 (gated), then f32 (reported)
    d, rmax = MALS_LIN
    for dtype in (torch.float64, torch.float32):
        p = mals_problem(device, d=d, rmax=rmax, dtype=dtype)
        torch.cuda.reset_peak_memory_stats()
        ms, x = wall(lambda: mals_linsolve_scan(p["A"], p["b"], p["x0"],
                                                tol=1e-12, rmax=rmax))
        u = ttv_to_tensor(p["u"]).reshape(-1).double()
        rel = float((ttv_to_tensor(x).reshape(-1).double() - u).norm()
                    / u.norm())
        gate = dtype == torch.float64
        log(f"mals_linsolve d={d} rmax={rmax} {str(dtype)[6:]}: {ms:.1f} "
            f"ms/sweep | rel err to u_sin {rel:.3e}"
            f"{' (<= 1e-9)' if gate else ' (reported, no gate)'} | realized "
            f"ranks {list(x.ranks)} | peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if gate and not rel <= 1e-9:
            raise RuntimeError(f"mals_linsolve f64 rel err {rel:.3e} > 1e-9")

    # 10d: the MALS eigensolve, f32
    d, rmax = MALS_EIG
    E0 = dense_xxx_groundstate(d)
    p = als_eig_problem(device, d=d, rmax=rmax, dtype=torch.float32)
    ms, (E, x) = wall(lambda: mals_eigsolve_scan(p["A"], p["x0"], rmax=rmax,
                                                 n_sweeps=2))
    rel = abs(E[-1] - E0) / abs(E0)
    log(f"mals_eigsolve d={d} rmax={rmax} f32: {ms / 2:.1f} ms/sweep | E "
        f"{E[-1]:.9f} dense {E0:.9f} rel {rel:.3e} (<= 1e-5) | realized "
        f"ranks {list(x.ranks)}")
    if not (np.isfinite(E).all() and rel <= 1e-5):
        raise RuntimeError(f"mals_eigsolve rel err {rel:.3e} > 1e-5")
    return counts


# ---------------------------------------------------------------------------
# The eager solver tier
# ---------------------------------------------------------------------------


def wall_ms(run):
    """``(ms, run())`` by the host clock, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def eager_dense(x):
    """The represented vector of a TT on the card, as float64 (complex128
    for complex cores) numpy; raises if a core left the card."""
    from ttnx_torch.core.decomp import ttv_to_tensor

    if not all(c.is_cuda for c in x.cores):
        raise RuntimeError("an eager result left the card")
    v = ttv_to_tensor(x).reshape(-1)
    return v.to(torch.complex128 if v.is_complex() else torch.float64
                ).cpu().numpy()


def rel_to(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def gate(label, ok, **values):
    if not ok:
        raise RuntimeError(f"{label} failed its gate: {values}")


def scan_beside(key):
    ms = SCAN_MS.get(key)
    return "not run" if ms is None else f"{ms:.3f}"


def eager_implicit_steppers(device, ranks=EAGER_RANKS):
    """11a: the flagship's heat problem through the eager implicit
    steppers: CN with ALS at each guess rank in f32 (bench.py:670's two
    gates), then in f64 against the per-mode CN recurrence (ALS at r16,
    MALS, DMRG and TT-Krylov at rank 16 for EAGER_F64_STEPS steps) and
    implicit Euler with ALS against its own per-mode factor."""
    from ttnx_torch.entry import mode_sum, sine_mode_problem
    from ttnx_torch.solvers.steppers import (crank_nicholson_method,
                                             implicit_euler_method)

    hg = 1.0 / (2 ** D + 1)
    heat = dict(d=D, scale=1.0 / hg ** 2, modes=HEAT_MODES)
    exact = cn_analytic(D, hg, H_STEP, N_STEPS)

    def cn(p, n, solver, **kw):
        return crank_nicholson_method(p["A"], p["u0"], p["guess"],
                                      [H_STEP] * n, normalize=False,
                                      return_error=True, tt_solver=solver,
                                      **kw)

    warm = sine_mode_problem(device, rmax=ranks[0], dtype=torch.float32,
                             **heat)
    cn(warm, 1, "als")  # cuSOLVER and einsum set-up out of the timings
    for rmax in ranks:
        p = sine_mode_problem(device, rmax=rmax, dtype=torch.float32, **heat)
        ms, (u, err) = wall_ms(lambda: cn(p, N_STEPS, "als"))
        u8 = eager_dense(u)
        rel = rel_to(u8, exact)
        # the last step's residual with the exact operators, from the
        # closed-form state before it (return_error's TT norm of a
        # difference rounds to 0 in f32)
        res = cn_residual(u8, cn_analytic(D, hg, H_STEP, N_STEPS - 1), hg,
                          H_STEP)
        log(f"11a crank_nicholson_method als d={D} r{rmax} f32 ({N_STEPS} "
            f"steps, h={H_STEP}): {ms / N_STEPS:.1f} ms/step | scan tier "
            f"(phase 4) {scan_beside(f'cn r{rmax}')} ms/step | traj rel "
            f"{rel:.3e} (<= 1e-3) return_error {err:.3e} (<= 1e-2) dense "
            f"residual {res:.3e} (<= 1e-2) | dtype {str(u.dtype)[6:]} "
            f"ranks {max(u.ranks)}")
        gate(f"11a cn als r{rmax} f32", u.dtype == torch.float32
             and np.isfinite(rel) and rel <= 1e-3 and err <= 1e-2
             and res <= 1e-2, rel=rel, err=err, res=res)

    r = EAGER_F64_RANK
    p = sine_mode_problem(device, rmax=r, dtype=torch.float64, **heat)
    lam = np.array(p["lam"])
    g_cn = (1 + H_STEP * lam / 2) / (1 - H_STEP * lam / 2)
    runs = [("als", N_STEPS, {}, 1e-10),
            ("mals", EAGER_F64_STEPS, dict(rmax=r), 1e-6),
            ("dmrg", EAGER_F64_STEPS, dict(rmax_schedule=[r]), 1e-6),
            ("krylov", EAGER_F64_STEPS, dict(max_bond=r, issymmetric=True,
                                             isposdef=True), 1e-6)]
    for solver, n, kw, tol in runs:
        ms, (u, _) = wall_ms(lambda: cn(p, n, solver, **kw))
        rel = rel_to(eager_dense(u), mode_sum(D, hg, HEAT_MODES, g_cn ** n))
        log(f"11a crank_nicholson_method {solver} d={D} r{r} f64 ({n} "
            f"steps): {ms / n:.1f} ms/step | rel to the per-mode CN "
            f"recurrence {rel:.3e} (<= {tol:g}) | ranks {max(u.ranks)}")
        gate(f"11a cn {solver} f64", np.isfinite(rel) and rel <= tol,
             rel=rel)
    ms, u = wall_ms(lambda: implicit_euler_method(
        p["A"], p["u0"], p["guess"], [H_STEP] * N_STEPS, normalize=False,
        tt_solver="als"))
    g_ie = 1 / (1 - H_STEP * lam)
    rel = rel_to(eager_dense(u), mode_sum(D, hg, HEAT_MODES,
                                          g_ie ** N_STEPS))
    log(f"11a implicit_euler_method als d={D} r{r} f64 ({N_STEPS} steps): "
        f"{ms / N_STEPS:.1f} ms/step | rel to the per-mode factor "
        f"{rel:.3e} (<= 1e-10)")
    gate("11a implicit euler f64", np.isfinite(rel) and rel <= 1e-10,
         rel=rel)


def eager_explicit_steppers(device):
    """11b: tridiag(1, -2, 1) (every |lam| <= 4) on three modes, f64, T =
    10 in 50 steps: the explicit steppers and the exponential integrator
    at their accuracy classes against ``sum c_k e^{T lam_k} mode_k``."""
    from ttnx_torch.entry import mode_sum, sine_mode_problem
    from ttnx_torch.solvers.krylov import expintegrator_tt
    from ttnx_torch.solvers.steppers import (crank_nicholson_method,
                                             euler_method,
                                             implicit_euler_method,
                                             rk4_method)

    p = sine_mode_problem(device, d=D, modes=EXPL_MODES)
    A, u0, hg = p["A"], p["u0"], p["hg"]
    h = EXPL_T / EXPL_STEPS
    steps = [h] * EXPL_STEPS
    exact = mode_sum(D, hg, EXPL_MODES, np.exp(EXPL_T * np.array(p["lam"])))
    moved = rel_to(exact, eager_dense(u0))
    runs = [
        ("euler_method", lambda: euler_method(A, u0, steps, normalize=False),
         5e-3, EXPL_STEPS),
        ("implicit_euler_method als", lambda: implicit_euler_method(
            A, u0, u0, steps, normalize=False, tt_solver="als"), 5e-3,
         EXPL_STEPS),
        ("crank_nicholson_method mals", lambda: crank_nicholson_method(
            A, u0, u0, steps, normalize=False, tt_solver="mals"), 1e-5,
         EXPL_STEPS),
        ("rk4_method max_bond=25", lambda: rk4_method(
            A, u0, steps, max_bond=25, normalize=False), 1e-9, EXPL_STEPS),
        ("expintegrator_tt krylov_dim=30 max_bond=16",
         lambda: expintegrator_tt(A, EXPL_T, u0, krylov_dim=30,
                                  max_bond=16)[0], 1e-9, 1),
    ]
    for name, run, tol, n in runs:
        ms, u = wall_ms(run)
        rel = rel_to(eager_dense(u), exact)
        per = f"{ms / n:.1f} ms/step" if n > 1 else f"{ms:.1f} ms/call"
        log(f"11b {name} d={D} f64 T={EXPL_T} ({n} steps): {per} | rel "
            f"to the exact evolution {rel:.3e} (<= {tol:g}; the state "
            f"moves {moved:.3e}) | ranks {max(u.ranks)}")
        gate(f"11b {name}", np.isfinite(rel) and rel <= tol, rel=rel)


def eager_eigensolvers(device):
    """11c: the open XXX chain from the seeded rank-4 start, f32, against
    the dense ground energy: DMRG, ALS (rank grown to rmax) and MALS with
    dense local eigh at (d, rmax) = EIG; DMRG with LOBPCG at EIG_LOBPCG;
    the pencil (A, 2 I) by ALS."""
    from ttnx_torch.core.tt import id_tto
    from ttnx_torch.entry import als_eig_problem, dense_xxx_groundstate
    from ttnx_torch.solvers.als import als_eigsolve, als_gen_eigsolv
    from ttnx_torch.solvers.dmrg import dmrg_eigsolve
    from ttnx_torch.solvers.mals import mals_eigsolve

    d, rmax = EIG
    E0 = dense_xxx_groundstate(d)
    p = als_eig_problem(device, d=d, rmax=4, dtype=torch.float32)
    A, x0 = p["A"], p["x0"]
    grow = dict(sweep_schedule=[1, EIG_SWEEPS + 1], rmax_schedule=[4, rmax])
    runs = [
        ("dmrg_eigsolve", lambda: dmrg_eigsolve(
            A, x0, sweep_schedule=[EIG_SWEEPS + 1], rmax_schedule=[rmax])),
        ("als_eigsolve", lambda: als_eigsolve(A, x0, **grow)),
        ("mals_eigsolve", lambda: mals_eigsolve(
            A, x0, sweep_schedule=[EIG_SWEEPS + 1], rmax_schedule=[rmax])),
        ("als_gen_eigsolv (A, 2 I)", lambda: als_gen_eigsolv(
            A, 2.0 * id_tto(d, dtype=torch.float32, device=device), x0,
            **grow)),
    ]
    for name, run in runs:
        ms, (E, x, *_) = wall_ms(run)
        want = E0 / 2 if "gen" in name else E0
        rel = abs(E[-1] - want) / abs(want)
        scan = (f" | scan tier (phase 6, lanczos) "
                f"{scan_beside(f'dmrg d{d} r{rmax} lanczos')} ms/sweep"
                if name == "dmrg_eigsolve" else "")
        log(f"11c {name} d={d} rmax={rmax} f32 ({EIG_SWEEPS} sweeps): "
            f"{ms / EIG_SWEEPS:.1f} ms/sweep{scan} | E {E[-1]:.9f} dense "
            f"{want:.9f} rel {rel:.3e} (<= 1e-5) | ranks {max(x.ranks)}")
        eager_dense(x)  # on the card
        gate(f"11c {name}", np.isfinite(E).all() and rel <= 1e-5, rel=rel)

    d, rmax = EIG_LOBPCG
    E0 = dense_xxx_groundstate(d)
    p = als_eig_problem(device, d=d, rmax=4, dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    ms, (E, x, r_hist) = wall_ms(lambda: dmrg_eigsolve(
        p["A"], p["x0"], sweep_schedule=[LOBPCG_SWEEPS + 1],
        rmax_schedule=[rmax], it_solver=True))
    rel = abs(E[-1] - E0) / abs(E0)
    log(f"11c dmrg_eigsolve it_solver=True (LOBPCG above M = 256) d={d} "
        f"rmax={rmax} f32 ({LOBPCG_SWEEPS} sweeps): "
        f"{ms / LOBPCG_SWEEPS:.1f} ms/sweep | scan tier (phase 6, lanczos) "
        f"{scan_beside(f'dmrg d{d} r{rmax} lanczos')} ms/sweep | E "
        f"{E[-1]:.9f} dense {E0:.9f} rel {rel:.3e} (<= 1e-5) | ranks "
        f"{max(x.ranks)} | peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    eager_dense(x)
    gate("11c dmrg LOBPCG", np.isfinite(E).all() and rel <= 1e-5, rel=rel)


def eager_tdvp(device):
    """11d: phase 7's imaginary-time problem through the eager tdvp (16
    steps) and tdvp2 (max_bond 8, 8 steps), complex128 as the reference
    computes, against the analytic decay."""
    from ttnx_torch.entry import tdvp_problem
    from ttnx_torch.solvers.tdvp import tdvp, tdvp2

    p = tdvp_problem(device, d=TDVP_D, rmax=TDVP_RMAX)
    u0d = eager_dense(p["u0"])
    for name, fn, n, kw, scan in (
            ("tdvp", tdvp, 16, {}, "tdvp1_step"),
            ("tdvp2", tdvp2, 8, dict(max_bond=TDVP_RMAX), "tdvp2_step")):
        ms, u = wall_ms(lambda: fn(p["A"], p["u0"], [TDVP_H] * n,
                                   imaginary_time=True, normalize=False,
                                   **kw))
        rel = rel_to(eager_dense(u), u0d * np.exp(-p["lam1"] * n * TDVP_H))
        log(f"11d {name} d={TDVP_D} h={TDVP_H} ({n} steps, "
            f"{str(u.dtype)[6:]}): {ms / n:.1f} ms/step | scan tier "
            f"(phase 7, {scan}) {scan_beside(scan)} ms/step | rel to the "
            f"analytic decay {rel:.3e} (<= 1e-3) | ranks {max(u.ranks)}")
        gate(f"11d {name}", np.isfinite(rel) and rel <= 1e-3, rel=rel)


def phase_eager_tier(device):
    """11: the eager solver tier on the card, TF32 off; it runs no kernel
    (11e: the launch counts are the same before and after)."""
    from ttnx_torch.config import matmul_precision
    from ttnx_torch.kernels.dispatch import launch_counts

    before = launch_counts()
    with matmul_precision("highest"):
        timed("11a", eager_implicit_steppers, device)
        timed("11b", eager_explicit_steppers, device)
        timed("11c", eager_eigensolvers, device)
        timed("11d", eager_tdvp, device)
    after = launch_counts()
    log(f"11e kernel launches during phase 11: "
        f"{ {k: after[k] - before[k] for k in after} } (all 0)")
    if after != before:
        raise RuntimeError(f"the eager tier launched kernels: {before} -> "
                           f"{after}")


# ---------------------------------------------------------------------------
# Cross and utilities
# ---------------------------------------------------------------------------

CROSS_BATCH = {"maxvol": 16, "dmrg": 8}  # bench.py's batches
CROSS_CALLS = 3


def smi_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def reads_and_launches(run):
    """``(host reads, stream syncs, kernels, copies)`` of one ``run()``: the
    synchronizing calls torch's sync-debug mode reports, and the
    ``cudaStreamSynchronize`` calls (cuSOLVER's own included), device
    kernels and memory copies and sets torch.profiler records."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    reads = sum("synchroniz" in str(w.message) for w in caught)
    with profiler([ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # the raw events: building the profiler's event tree for some 10^5
    # device events takes many seconds
    events = prof.profiler.kineto_results.events()
    syncs = sum(e.name() == "cudaStreamSynchronize" for e in events)
    names = [e.name() for e in events if e.device_type() == DeviceType.CUDA]
    copies = sum(n.startswith(("Memcpy", "Memset")) for n in names)
    return reads, syncs, len(names) - copies, copies


def wishart_exact(theta, coords):
    """The Wishart integrand in float64 numpy, ``det(I + theta sigma
    diag(c))^(-p)``, the independent check of the f32 cross."""
    from ttnx_torch.entry import WISHART_SIGMA

    m = np.eye(5) + theta * 2 * WISHART_SIGMA * coords[:, None, :]
    return np.linalg.det(m) ** (-3.5)


def batched_cross(device, method, smi):
    """12a/12b: the bench's batched Wishart cross through the maker's
    ``fn(generator)`` (f32, TF32 off): the validation gate, the rel-L2 of
    the first and last problem on 200 fresh points against the float64
    function, crosses/s (median and best of CROSS_CALLS calls after a
    warm-up, host clock ending in a synchronize) and one call's host reads
    and CUDA launches."""
    from ttnx_torch.cross.device import evaluate_tt_indices
    from ttnx_torch.entry import wishart_cross_problem

    B = CROSS_BATCH[method]
    p = wishart_cross_problem(device, batch=B, method=method)

    def run():
        return p["fn"](torch.Generator(device=device).manual_seed(p["seed"]))

    first_ms, _ = wall_ms(run)
    times = []
    for _ in range(CROSS_CALLS):
        ms, (cores, eps) = wall_ms(run)
        times.append(ms)
    if any(c.device != device for c in cores) or tuple(eps.shape) != (B, 3):
        raise RuntimeError(f"{method} cross: a result left the card or has "
                           f"the shape {tuple(eps.shape)}")
    last = float(eps[:, -1].max())
    gate(f"{method}_cross_device val_eps", np.isfinite(last)
         and last <= p["gate"], max_last_val_eps=last)
    rng = np.random.default_rng(2027)
    idx = np.stack([rng.integers(0, 8, 200) for _ in range(5)], axis=1)
    grid = np.linspace(0.0, 2.0, 8)
    fresh = []
    for k in (0, B - 1):
        want = wishart_exact(float(p["thetas"][k]), grid[idx])
        got = evaluate_tt_indices([c[k] for c in cores], torch.as_tensor(
            idx, device=device)).double().cpu().numpy()
        fresh.append(rel_to(got, want))
    gate(f"{method}_cross_device fresh points", max(fresh) <= p["gate"],
         rel_l2=fresh)
    reads, syncs, kernels, copies = reads_and_launches(run)
    per_s = sorted(B / (t / 1e3) for t in times)
    log(f"12{'a' if method == 'maxvol' else 'b'} {method}_cross_device "
        f"Wishart d=5 r8 B={B} f32 (TF32 off): "
        f"{statistics.median(per_s):.2f} crosses/s median of {CROSS_CALLS} "
        f"calls (best {per_s[-1]:.2f}; {statistics.median(times):.1f} "
        f"ms a call; first call {first_ms:.1f} ms) | max last val_eps "
        f"{last:.3e} (gate <= {p['gate']:g}) | rel-L2 on 200 fresh points "
        f"(problems 0, {B - 1}) {fresh[0]:.2e}, {fresh[1]:.2e} | one call: "
        f"{reads} host reads ({syncs} cudaStreamSynchronize), {kernels} "
        f"CUDA kernels, {copies} copies | {smi}")


def gaussian_grid(g, d):
    xs = np.stack(np.meshgrid(*[g] * d, indexing="ij"), axis=-1)
    return np.exp(-np.sum(xs ** 2, axis=-1))


def device_cross_f64(device, smi):
    """12c: the separable Gaussian (4 dims x 12 points, rank 3) by both
    makers in f64 against the closed form (<= 1e-8), and the adaptive
    cross's escalation."""
    from ttnx_torch.cross.device import (tt_cross_device,
                                         tt_cross_device_adaptive)

    def gaussian(X):
        return torch.exp(-(X ** 2).sum(-1))

    g = np.linspace(-1, 1, 12)
    for method in ("maxvol", "dmrg"):
        ms, (tt, eps) = wall_ms(lambda: tt_cross_device(
            gaussian, [g] * 4, rank=3, n_iters=3, n_val=300, method=method,
            device=device))
        err = rel_to(eager_dense(tt), gaussian_grid(g, 4).reshape(-1))
        gate(f"12c {method} Gaussian", err <= 1e-8 and eps[-1] <= 1e-8,
             rel=err, val_eps=eps[-1])
        log(f"12c tt_cross_device {method} Gaussian 4 x 12 r3 f64: rel "
            f"{err:.2e} (gate <= 1e-8), val_eps {eps[-1]:.2e}, {ms:.1f} ms "
            f"| {smi}")
    g10 = np.linspace(-1, 1, 10)

    def coupled(X):
        return torch.exp(-(X ** 2).sum(-1)) / (
            1.1 + torch.prod(torch.sin(3 * X), dim=-1))

    ms, (_, eps1, r1) = wall_ms(lambda: tt_cross_device_adaptive(
        gaussian, [g10] * 3, tol=1e-8, rank_schedule=(2, 4, 8),
        device=device))
    _, eps2, r2 = tt_cross_device_adaptive(coupled, [g10] * 3, tol=1e-12,
                                           rank_schedule=(2, 4),
                                           device=device)
    gate("12c adaptive escalation", r1 == 2 and eps1[-1] < 1e-8 and r2 == 4
         and eps2[-1] < 0.5, ranks=(r1, r2), eps=(eps1[-1], eps2[-1]))
    log(f"12c tt_cross_device_adaptive: the Gaussian stops at rank {r1} "
        f"(val_eps {eps1[-1]:.2e}, {ms:.1f} ms), the coupled function "
        f"escalates to rank {r2} (val_eps {eps2[-1]:.2e}) | {smi}")


def host_cross(device, smi):
    """12d: the host cross with its cores on the card: the reference
    README's 4-D Gaussian by MaxVol (ranks 2, <= 1e-12), DMRGCross and
    Greedy on one case each of tests/test_cross.py at those tests'
    tolerances, and tt_integrate of exp(-|x|^2) over [-1, 1]^3 at nquad =
    30 within 1e-9 of (sqrt(pi) erf 1)^3."""
    import math

    from ttnx_torch.cross import DMRGCross, Greedy, MaxVol, tt_cross
    from ttnx_torch.utils.profiling import sync_and_time

    def gauss(X):
        return np.exp(-np.sum(X ** 2, axis=1))

    g10, g12 = np.linspace(-1, 1, 10), np.linspace(-1, 1, 12)
    g8 = np.linspace(0.1, 1, 8)
    exp_sum = np.exp(g8[:, None, None] + g8[None, :, None]
                     + g8[None, None, :])
    cases = (("MaxVol README Gaussian 4 x 10 ranks 2", gauss, [g10] * 4,
              MaxVol(tol=1e-8), 2, gaussian_grid(g10, 4), 1e-12),
             ("DMRGCross Gaussian 4 x 12 ranks 3", gauss, [g12] * 4,
              DMRGCross(tol=1e-10), 3, gaussian_grid(g12, 4), 1e-8),
             ("Greedy exp(x+y+z) 3 x 8", lambda X: np.exp(np.sum(X, axis=1)),
              [g8] * 3, Greedy(tol=1e-9), 2, exp_sum, 1e-7))
    for label, f, domain, alg, ranks, want, tol in cases:
        secs, tt = sync_and_time(lambda: tt_cross(f, domain, alg, ranks=ranks,
                                                  device=device))
        err = rel_to(eager_dense(tt), want.reshape(-1))
        gate(f"12d {label}", err <= tol, rel=err)
        log(f"12d tt_cross {label} f64, cores on the card: rel {err:.2e} "
            f"(gate <= {tol:g}), ranks {max(tt.ranks)}, {secs * 1e3:.1f} "
            f"ms | {smi}")
    from ttnx_torch.cross import tt_integrate

    exact = (math.sqrt(math.pi) * math.erf(1.0)) ** 3
    secs, val = sync_and_time(lambda: tt_integrate(
        gauss, -np.ones(3), np.ones(3), alg=MaxVol(tol=1e-10), nquad=30,
        device=device))
    gate("12d tt_integrate", abs(val - exact) <= 1e-9, value=val,
         exact=exact)
    log(f"12d tt_integrate exp(-|x|^2) over [-1, 1]^3 nquad=30: error "
        f"{abs(val - exact):.2e} (gate <= 1e-9), {secs * 1e3:.1f} ms | {smi}")


def utilities(device, smi):
    """12e: a QTT vector on the card through save_tt/load_tt (a file under
    build/; same subclass and metadata, bit-equal cores on the card),
    resilient_linsolve with the eager als_linsolve on the CN system (I -
    h/2 A) x = u0 of entry.sine_mode_problem at the heat scaling (d = 12,
    h = 1e-6, guess rank 8, f64; a first attempt that diverges to NaN,
    then solves from perturbed guesses until the residual is below 1e-6;
    the dense solution within 1e-8 of the per-mode closed form), and
    assert_finite raising on a core with a NaN."""
    import os

    from ttnx_torch.core.algebra import add_op, scale_op
    from ttnx_torch.core.tt import TTVector, id_tto
    from ttnx_torch.entry import mode_sum, sine_mode_problem
    from ttnx_torch.ops.qtt import QTTVector, function_to_qttv
    from ttnx_torch.solvers.als import als_linsolve
    from ttnx_torch.utils.checkpoint import load_tt, save_tt
    from ttnx_torch.utils.resilience import resilient_linsolve
    from ttnx_torch.utils.validation import assert_finite, assert_valid_tt

    q = function_to_qttv(lambda c: np.sin(3 * c[..., 0]) * np.exp(c[..., 1]),
                         2, 8, ordering="serial", device=device)
    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", "phase12_qtt.npz")
    save_tt(path, q)
    back = load_tt(path, device=device)
    same = (isinstance(back, QTTVector) and back.ordering == "serial"
            and (back.n_dims, back.bits_per_dim) == (2, 8)
            and all(c.device == device for c in back.cores)
            and all(torch.equal(a, b) for a, b in zip(q.cores, back.cores)))
    gate("12e save_tt/load_tt", same, ranks=back.ranks)
    d, h = 12, 1e-6
    hg = 1.0 / (2 ** d + 1)
    p = sine_mode_problem(device, scale=1.0 / hg ** 2, rmax=8)
    lhs = add_op(id_tto(d, device=device), scale_op(-h / 2, p["A"]))
    attempts = []

    def solver(A, b, guess, **kw):
        attempts.append(1)
        if len(attempts) == 1:
            return float("nan") * guess
        return als_linsolve(A, b, guess, **kw)

    ms, x = wall_ms(lambda: resilient_linsolve(
        lhs, p["u0"], p["guess"], solver, max_residual=1e-6, sweep_count=4,
        generator=torch.Generator(device=device).manual_seed(0)))
    assert_valid_tt(x)
    want = mode_sum(d, hg, p["modes"], [1 / (1 - h / 2 * lam)
                                         for lam in p["lam"]])
    err = rel_to(eager_dense(x), want)
    gate("12e resilient_linsolve", len(attempts) >= 2 and err <= 1e-8,
         attempts=len(attempts), rel=err)
    bad = TTVector([c.clone() for c in x.cores])
    bad.cores[2][0, 0, 0] = float("nan")
    try:
        assert_finite(bad)
    except FloatingPointError:
        raised = True
    else:
        raised = False
    gate("12e assert_finite", raised)
    log(f"12e save_tt/load_tt QTTVector 2 x 8 bits on the card: bit-equal "
        f"| resilient_linsolve(als_linsolve) CN d=12 f64 after a NaN attempt: "
        f"{len(attempts)} attempts, rel {err:.2e} (gate <= 1e-8), {ms:.1f} "
        f"ms | assert_finite raises on a NaN core | {smi}")


def phase_cross(device):
    """12: the cross and the utilities on the card, TF32 off; no kernel
    launches (12f: the launch counts are the same before and after)."""
    from ttnx_torch.config import matmul_precision
    from ttnx_torch.kernels.dispatch import launch_counts

    smi = smi_line()
    before = launch_counts()
    with matmul_precision("highest"):
        timed("12a", batched_cross, device, "maxvol", smi)
        timed("12b", batched_cross, device, "dmrg", smi)
        timed("12c", device_cross_f64, device, smi)
        timed("12d", host_cross, device, smi)
        timed("12e", utilities, device, smi)
    after = launch_counts()
    log(f"12f kernel launches during phase 12: "
        f"{ {k: after[k] - before[k] for k in after} } (all 0)")
    if after != before:
        raise RuntimeError(f"the cross launched kernels: {before} -> "
                           f"{after}")


# ---------------------------------------------------------------------------
# The distributed layer (slice 16)
# ---------------------------------------------------------------------------

# 13a's and 13b's CN step (phase 4's problem at r64), 13c's batch over dp,
# and the longest wait for a rank
DIST_RMAX, DIST_SWEEPS = 64, 2
DIST_BATCH, DIST_DP = 8, 2
RANK_TIMEOUT = 300.0
# launches a step of the distributed CN step: the ALS solve's B2 and B4 on
# every rank; B1 only where the rounding runs replicated (13a)
DIST_STEP = {"right_env_chain_fused": 1, "left_env_chain_fused": 1,
             "cg_matfree_fused": 2 * (D - 1)}


def heat_operator(device):
    """Phase 4's operator: the interior heat Laplacian ``-(1/hg^2)
    tridiag(-1, 2, -1)`` on ``hg = 1/(2^D + 1)``."""
    from ttnx_torch.ops.operators import toeplitz_to_qtto

    hg = 1.0 / (2 ** D + 1)
    return (-1.0 / hg ** 2) * toeplitz_to_qtto(2.0, -1.0, -1.0, D,
                                               device=device)


def dist_cn_step(A, mesh, force_tp):
    """``make_cn_step_dist`` on phase 4's problem (``A`` from
    :func:`heat_operator`) at rank DIST_RMAX (f32, ``cg_fused``,
    ``gram_chain``, DIST_SWEEPS half-sweeps): ``(step_fn, packed three-mode
    state, unpack)``."""
    from ttnx_torch.entry import three_mode_state
    from ttnx_torch.parallel.round_dist import make_cn_step_dist

    hg = 1.0 / (2 ** D + 1)
    step, pack, unpack = make_cn_step_dist(
        A, H_STEP, DIST_RMAX, (2,) * D,
        (1,) + (DIST_RMAX,) * (D - 1) + (1,), mesh, dtype=torch.float32,
        sweep_count=DIST_SWEEPS, solver="cg_fused",
        round_method="gram_chain", force_tp=force_tp)
    return step, pack(three_mode_state(D, hg, A.device)), unpack


def dist_step_run(step, us, unpack):
    """One step for its launch counts, then :func:`timed_chain`; returns
    the launches of that step (by wrapper and by route), of the whole run,
    ms/step and the dense states after 7 and 8 steps."""
    from ttnx_torch.kernels.dispatch import (launch_counts,
                                             reset_launch_counts,
                                             route_counts)

    reset_launch_counts()
    one = step(us)
    torch.cuda.synchronize()
    per_step = {k: v for k, v in launch_counts().items() if v}
    routes = {k: v for k, v in route_counts().items() if v}
    if one.shape != us.shape or not bool(torch.isfinite(one).all()):
        raise RuntimeError(f"distributed CN step: not a finite "
                           f"{tuple(us.shape)} stack")
    ms, v7, v8 = timed_chain(step, us)
    return dict(per_step=per_step, routes=routes, launches=launch_counts(),
                ms=ms, d7=dense(unpack, v7), d8=dense(unpack, v8))


def rounding_ms(A, us, mesh, sharded, calls=5):
    """ms a call of the distributed step's rounding alone, on the chain its
    first step's right-hand side gives: ``I + h/2 A`` packed and applied to
    the packed state ``us``, rounded to the step's output ranks, sharded
    over ``tp`` or replicated (``tt_round_gram``, B1). Launches here are
    not counted."""
    from ttnx_torch.core.algebra import add_op, scale_op
    from ttnx_torch.core.tt import id_tto
    from ttnx_torch.parallel.round_dist import (gram_chain_round_dist,
                                                shard_chain)
    from ttnx_torch.solvers.als_scan import pack_op, rank_masks
    from ttnx_torch.solvers.round_scan import (matvec_padded, round_masks,
                                               tt_round_gram)

    f32 = torch.float32
    rhs = add_op(id_tto(D, dtype=f32, device=us.device),
                 scale_op(H_STEP / 2, A.astype(f32)))
    big = matvec_padded(pack_op(rhs, max(rhs.ranks)), us)
    # the step's output ranks: the feasible ranks at DIST_RMAX
    out_rks = round_masks((1,) + (DIST_RMAX,) * (D - 1) + (1,), DIST_RMAX,
                          (2,) * D)
    masks_out = rank_masks(out_rks, DIST_RMAX, dtype=f32, device=us.device)
    if sharded:
        big = shard_chain(big, mesh, "tp")

        def run():
            return gram_chain_round_dist(big, DIST_RMAX, masks_out, mesh)
    else:
        def run():
            return tt_round_gram(big, DIST_RMAX, masks_out)
    sec, _ = timed_calls(run, calls)
    return sec * 1e3


def cn_tp_rank(ctx, shape):
    """13b on one rank: the step with its rounding sharded over ``tp``."""
    from ttnx_torch.config import matmul_precision
    from ttnx_torch.parallel.comm import route

    mesh = ctx.meshes[shape]
    with matmul_precision("highest"):
        A = heat_operator(ctx.device)
        step, us, unpack = dist_cn_step(A, mesh, True)
        out = dist_step_run(step, us, unpack)
        out["round_ms"] = rounding_ms(A, us, mesh, True)
    out["route"] = route(mesh, "tp", us)
    return out


def batched_dp_problem(device):
    """13c's problems: the operator of ``entry.batched_als_problem`` (d =
    D, rank 64), DIST_BATCH right-hand sides ``(1 + 0.2 k) u`` of its
    rank-64 state ``u``, which is also every guess."""
    from ttnx_torch.entry import batched_als_problem
    from ttnx_torch.solvers.als_scan import unpack_tt

    p = batched_als_problem(device, batch=1, rmax=64, d=D, h=H_STEP)
    u = unpack_tt(p["b_batch"][0], p["u_rks"])
    return p["lhs"], [(1 + 0.2 * k) * u for k in range(DIST_BATCH)], u


def batched_dp_rank(ctx, shape):
    """13c on one rank: ``batched_als_linsolve`` over ``dp``."""
    from ttnx_torch.config import matmul_precision
    from ttnx_torch.core.decomp import ttv_to_tensor
    from ttnx_torch.kernels.dispatch import launch_counts, reset_launch_counts
    from ttnx_torch.parallel.batch import batched_als_linsolve
    from ttnx_torch.parallel.comm import route

    mesh = ctx.meshes[shape]
    with matmul_precision("highest"):
        lhs, bs, u = batched_dp_problem(ctx.device)
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = batched_als_linsolve(mesh, lhs, bs, [u] * len(bs),
                                    sweep_count=2, rmax=64,
                                    solver="cg_fused")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    return dict(launches=launch_counts(), sec=sec,
                route=route(mesh, "dp", bs[0].cores[0]),
                dense=[ttv_to_tensor(x).reshape(-1).double() for x in outs])


def dryrun_rank(ctx):
    """13d on one rank: ``entry.dryrun_multichip`` in float64."""
    from ttnx_torch.entry import dryrun_multichip
    from ttnx_torch.kernels.dispatch import launch_counts, reset_launch_counts

    reset_launch_counts()
    errs = dryrun_multichip(ctx.device)
    torch.cuda.synchronize()
    return dict(errs=errs, launches=launch_counts())


def check_step(label, run, exact, hg):
    """The CN gates on a distributed step's run; returns (traj rel,
    residual)."""
    rel = float(np.linalg.norm(run["d8"] - exact) / np.linalg.norm(exact))
    res = cn_residual(run["d8"], run["d7"], hg, H_STEP)
    if not (np.isfinite(rel) and rel <= 1e-3 and res <= 1e-2):
        raise RuntimeError(f"{label} failed its gates: rel={rel:.3e} "
                           f"residual={res:.3e}")
    return rel, res


def add_counts(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def dist_nccl(device, smi, exact, hg, total):
    """13a: a one-rank NCCL mesh in this process; the collectives on it and
    the replicated distributed CN step against ``make_cn_step``."""
    import torch.distributed as dist

    from ttnx_torch.parallel.batch import make_mesh
    from ttnx_torch.parallel.comm import all_gather, psum, psum_scatter, route
    from ttnx_torch.solvers.round_scan import make_cn_step

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(1, 1, device=device)
        x = torch.arange(24.0, device=device).reshape(2, 3, 4)
        coll = {axis: route(mesh, axis, x) for axis in ("dp", "tp")}
        same = all(torch.equal(f(x, mesh, "tp", *a), x) for f, a in (
            (psum, ()), (psum_scatter, (1,)), (all_gather, (2,))))
        if coll != {"dp": "nccl", "tp": "nccl"} or not same:
            raise RuntimeError(f"13a collectives: routes {coll}, values "
                               f"kept {same}")
        A = heat_operator(device)
        step, us, unpack = dist_cn_step(A, mesh, None)
        run = dist_step_run(step, us, unpack)
        run["round_ms"] = rounding_ms(A, us, mesh, False)
    finally:
        dist.destroy_process_group()
    want = dict(DIST_STEP, gram_chain_fused=1)
    fast = {name: {"grid" if name == "gram_chain_fused" else "cluster": n}
            for name, n in want.items()}
    if run["per_step"] != want or run["routes"] != fast:
        raise RuntimeError(f"13a: launches/step {run['per_step']}, expected "
                           f"{want}; routes {run['routes']}")
    add_counts(total, run["launches"])
    ref_step, ref_pack, ref_unpack = make_cn_step(
        A, H_STEP, rmax=DIST_RMAX, dims=(2,) * D,
        u_rks=(1,) + (DIST_RMAX,) * (D - 1) + (1,), dtype=torch.float32,
        sweep_count=DIST_SWEEPS, solver="cg_fused", round_method="gram_chain")
    _, ref8 = run_chain(ref_step, us, N_STEPS)
    rel, res = check_step("13a", run, exact, hg)
    agree = float(np.linalg.norm(run["d8"] - dense(ref_unpack, ref8))
                  / np.linalg.norm(run["d8"]))
    log(f"13a make_cn_step_dist d={D} r{DIST_RMAX} f32 on a one-rank NCCL "
        f"mesh (replicated rounding): {run['ms']:.3f} ms/step (the "
        f"rounding alone {run['round_ms']:.3f} ms) | traj rel "
        f"{rel:.3e} (<= 1e-3) residual {res:.3e} (<= 1e-2) | vs "
        f"make_cn_step 8-step rel {agree:.3e} (<= 1e-4) | launches/step "
        f"{run['per_step']} | kernel routes {run['routes']} | collectives "
        f"on the mesh: {routes_line(coll.values())} | {smi}")
    if agree > 1e-4:
        raise RuntimeError(f"13a: 8-step state {agree:.3e} from "
                           f"make_cn_step")
    return run


def routes_line(seen):
    """How each collective runs on the routes ``seen``."""
    how = {"nccl": "psum all_reduce, psum_scatter reduce_scatter_tensor, "
                   "all_gather all_gather_into_tensor (NCCL)",
           "gloo-cuda": "psum all_reduce, psum_scatter all_reduce + slice, "
                        "all_gather all_reduce of a zero-padded buffer "
                        "(gloo, CUDA tensors staged through the host)"}
    return "; ".join(f"{r}: {how[r]}" for r in sorted(set(seen)))


def phase_distributed(device):
    """13: the distributed layer on the card; returns the launches of the
    distributed runs, this process's and every rank's."""
    from ttnx_torch.core.canonical import orthogonalize
    from ttnx_torch.core.decomp import ttv_to_tensor
    from ttnx_torch.parallel.batch import batched_als_sweeps
    from ttnx_torch.parallel.launch import RankPool
    from ttnx_torch.solvers.als_scan import (pack_op, pack_tt, rank_masks,
                                             unpack_tt)

    smi = smi_line()
    hg = 1.0 / (2 ** D + 1)
    exact = cn_analytic(D, hg, H_STEP, N_STEPS)
    total = {}
    t0 = time.perf_counter()
    run_a = timed("13a", dist_nccl, device, smi, exact, hg, total)

    def tp_step(pool, tp):
        runs = pool.run("chip_smoke:cn_tp_rank", (1, tp))
        for rank, run in enumerate(runs):
            if run["per_step"] != DIST_STEP:
                raise RuntimeError(f"13b tp={tp} rank {rank}: launches/step "
                                   f"{run['per_step']}, expected {DIST_STEP}")
            rel, res = check_step(f"13b tp={tp} rank {rank}", run, exact, hg)
            agree = float(np.linalg.norm(run["d8"] - run_a["d8"])
                          / np.linalg.norm(run_a["d8"]))
            if agree > 1e-4:
                raise RuntimeError(f"13b tp={tp} rank {rank}: 8-step state "
                                   f"{agree:.3e} from 13a's")
            add_counts(total, run["launches"])
            log(f"13b tp={tp} rank {rank}/{tp} (gloo, cuda:0): "
                f"{run['ms']:.3f} ms/step, the sharded rounding alone "
                f"{run['round_ms']:.3f} ms (13a one rank {run_a['ms']:.3f}, "
                f"{run_a['round_ms']:.3f}) |"
                f" vs 13a 8-step rel {agree:.3e} (<= 1e-4) | traj rel "
                f"{rel:.3e} (<= 1e-3) residual {res:.3e} (<= 1e-2) | "
                f"launches/step {run['per_step']} | {smi}")
        log(f"13b tp={tp} collectives: "
            f"{routes_line([r['route'] for r in runs])}")

    with RankPool(2, device=device, meshes=((1, 2), (DIST_DP, 1)),
                  timeout=RANK_TIMEOUT) as pool:
        log(f"13b/13c: 2 gloo ranks on {device} up in "
            f"{time.perf_counter() - t0:.1f} s of phase 13")
        timed("13b tp=2", tp_step, pool, 2)
        t1 = time.perf_counter()
        runs = pool.run("chip_smoke:batched_dp_rank", (DIST_DP, 1))
        lhs, bs, u = batched_dp_problem(device)
        x0 = orthogonalize(u, 0)
        ref = batched_als_sweeps(
            pack_op(lhs, max(lhs.ranks)),
            torch.stack([pack_tt(b, max(b.ranks)) for b in bs]),
            torch.stack([pack_tt(x0, 64)] * len(bs)),
            rank_masks(x0.ranks, 64, dtype=torch.float32, device=device),
            2, solver="cg_fused")
        ref = [dense(lambda s: unpack_tt(s, x0.ranks), r) for r in ref]
        c = H_STEP / (2 * hg ** 2)
        b0 = ttv_to_tensor(bs[0]).reshape(-1).double().cpu().numpy()
        for rank, run in enumerate(runs):
            worst = max(float(np.linalg.norm(g.astype(np.float64) - r)
                              / np.linalg.norm(r))
                        for g, r in zip(run["dense"], ref))
            x0s = np.asarray(run["dense"][0], dtype=np.float64)
            lhs0 = x0s + c * (2 * x0s - np.pad(x0s[1:], (0, 1))
                              - np.pad(x0s[:-1], (1, 0)))
            res = float(np.linalg.norm(lhs0 - b0) / np.linalg.norm(b0))
            add_counts(total, run["launches"])
            log(f"13c batched_als_linsolve dp={DIST_DP} rank {rank}: "
                f"{DIST_BATCH} problems d={D} r64 f32 cg_fused in "
                f"{run['sec'] * 1e3:.1f} ms | worst per-problem rel to "
                f"single-device batched_als_sweeps {worst:.3e} (<= 1e-4) | "
                f"residual[0] {res:.3e} (<= 1e-2) | launches "
                f"{ {k: v for k, v in run['launches'].items() if v} } | "
                f"{routes_line([run['route']])} | {smi}")
            if not (worst <= 1e-4 and res <= 1e-2):
                raise RuntimeError(f"13c rank {rank} failed its gates: "
                                   f"worst={worst:.3e} residual={res:.3e}")
        log(f"phase 13c: {time.perf_counter() - t1:.1f} s wall")
    t1 = time.perf_counter()
    with RankPool(4, device=device, meshes=((1, 4),),
                  timeout=RANK_TIMEOUT) as pool:
        log(f"13b/13d: 4 gloo ranks on {device} up in "
            f"{time.perf_counter() - t1:.1f} s")
        timed("13b tp=4", tp_step, pool, 4)
        t1 = time.perf_counter()
        runs = pool.run("chip_smoke:dryrun_rank")
        for rank, run in enumerate(runs):
            add_counts(total, run["launches"])
        log(f"13d dryrun_multichip (dp=2, tp=2) f64, 4 gloo ranks on "
            f"{device}: every leg under its threshold on every rank; rank 0 "
            f"{runs[0]['errs']} | {smi}")
        log(f"phase 13d: {time.perf_counter() - t1:.1f} s wall")
    log(f"13 launches (this process and every rank): "
        f"{ {k: v for k, v in total.items() if v} }")
    return total


# ---------------------------------------------------------------------------
# Autograd interop, the NaN trap and the examples
# ---------------------------------------------------------------------------

GRAD_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
ADAM_STEPS, ADAM_GATE = 100, 1e-2  # tests/test_ad_interop.py's optax twin
# the launches a run of each examples_torch/ script makes: one a wrapper
# call, as many as its CPU run calls the wrappers (scripts not named
# launch nothing)
EXAMPLE_LAUNCHES = {
    "als_quickstart": {"right_env_chain_fused": 2, "left_env_chain_fused": 2},
    "ising_phase_transition": {"env_chain_A_fused": 52},
    "batched_dmrg_tdvp_sweep": {"env_chain_A_fused": 60},
    "batched_parameter_sweep": {"right_env_chain_fused": 16,
                                "left_env_chain_fused": 16},
}
# scripts that stop, as their examples/ twins do, at a failing assert of
# the twin's, and the line they print before it (ROADMAP C.24)
FAILS_AS_ITS_TWIN = {"quadrature_cross": "d=10  rel err 8.512e-06"}


def rayleigh_grad(A, x0, device, dtype):
    """The core gradient of the Rayleigh quotient of ``A`` at ``x0``, in
    ``dtype`` on ``device``, as float64 CPU tensors."""
    from ttnx_torch.utils.manifold import core_grad, rayleigh_quotient

    g = core_grad(rayleigh_quotient(A.astype(dtype).to(device)),
                  x0.astype(dtype).to(device))
    return [c.double().cpu() for c in g]


def adam_run(device, dtype):
    """The torch.optim.Adam twin of ttnx's optax test: 100 steps of lr
    0.05 on the Rayleigh quotient of laplacian(4) from a seeded rank-4
    state. Returns (first value, last value, dense ground energy)."""
    from ttnx_torch.core.tt import TTVector, rand_tt
    from ttnx_torch.ops.operators import laplacian
    from ttnx_torch.ops.qtt import qtto_to_matrix
    from ttnx_torch.utils.manifold import rayleigh_quotient

    H = laplacian(4, device=device).astype(dtype)
    cost = rayleigh_quotient(H)
    x = rand_tt(torch.Generator().manual_seed(1234), (2,) * 4, rmax=4,
                normalise=True, orthogonal=True, dtype=dtype).to(device)
    cores = [c.clone().requires_grad_() for c in x.cores]
    opt = torch.optim.Adam(cores, lr=0.05)
    first = float(cost(x))
    for _ in range(ADAM_STEPS):
        opt.zero_grad()
        val = cost(TTVector(cores))
        val.backward()
        opt.step()
    e_dense = np.linalg.eigvalsh(qtto_to_matrix(H).double().cpu().numpy())[0]
    return first, float(val.detach()), float(e_dense)


def refusal_cases(device):
    """One wrapper of each kernel file with small inputs on ``device``:
    ``{name: (wrapper, args, kwargs)}``."""
    from ttnx_torch.kernels import (als_sweep_fused, contraction, env_chain,
                                    gram, lanczos, local_cg, local_cg_mf,
                                    qr_batched)

    g = torch.Generator().manual_seed(14)

    def t(*shape, dtype=torch.float64):
        return (torch.randn(shape, generator=g, dtype=torch.float64) / 4
                ).to(device=device, dtype=dtype)

    d, R, n, RA, M = 3, 4, 2, 3, 6
    K = t(M, M)
    K = K @ K.T + torch.eye(M, dtype=K.dtype, device=device)
    masks = torch.ones((d + 1, R), dtype=torch.float64, device=device)
    return {
        "gram_chain_fused": (gram.gram_chain_fused, (t(d, R, n, R),), {}),
        "right_env_chain_fused": (env_chain.right_env_chain_fused,
                                  (t(d, R, n, R), t(d, RA, n, n, RA),
                                   t(d, 2, n, 2)), {}),
        "lanczos_fused": (lanczos.lanczos_fused, (K, t(M)), dict(iters=3)),
        "als_fwd_bwd_fused_batched": (
            als_sweep_fused.als_fwd_bwd_fused_batched,
            (t(d, RA, n, n, RA), t(2, d, R, n, R), t(2, d, R, n, R), masks),
            {}),
        "matmul_chain": (contraction.matmul_chain,
                         (t(2, 3, 4, dtype=torch.float32),
                          t(2, 4, 4, dtype=torch.float32)), {}),
        "cg_solve_fused": (local_cg.cg_solve_fused, (K, t(M)),
                           dict(x0=t(M))),
        "cg_matfree_fused": (local_cg_mf.cg_matfree_fused,
                             (t(R, RA, R), t(RA, n, n, RA), t(R, RA, R),
                              t(R, n, R), torch.ones_like(t(R, n, R))),
                             dict(x0=t(R, n, R))),
        "qr_batched": (qr_batched.qr_batched, (t(2, n * R, R),), {}),
    }


def autograd_on_card(device, smi):
    """14a: the Rayleigh-quotient core gradient of phase 11's XXX chain on
    the card against the CPU's in f64; the Adam run's gate; the gradient
    gate of one wrapper of each kernel file on CUDA inputs."""
    from ttnx_torch.entry import als_eig_problem
    from ttnx_torch.kernels.dispatch import route_counts

    cpu = torch.device("cpu")
    p = als_eig_problem(cpu, d=EIG[0], rmax=4, dtype=torch.float64)
    ref = rayleigh_grad(p["A"], p["x0"], cpu, torch.float64)
    scale = max(float(r.abs().max()) for r in ref)
    for dtype in (torch.float64, torch.float32):
        got = rayleigh_grad(p["A"], p["x0"], device, dtype)
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        log(f"14a Rayleigh-quotient core gradient, XXX chain d={EIG[0]} "
            f"rank 4, {dtype} on {device} vs CPU float64: max abs err "
            f"{err / scale:.3e} of max |g| {scale:.3e} (<= "
            f"{GRAD_TOL[dtype]:.0e}) | {smi}")
        gate(f"14a gradient {dtype}", err <= GRAD_TOL[dtype] * scale,
             err=err / scale)
    for dtype in (torch.float64, torch.float32):
        first, last, e_dense = adam_run(device, dtype)
        log(f"14a torch.optim.Adam {ADAM_STEPS} steps lr 0.05, {dtype}: "
            f"cost {first:.6f} -> {last:.6f}, dense ground {e_dense:.6f}, "
            f"gap {last - e_dense:.3e} (< {ADAM_GATE:.0e}) | {smi}")
        gate(f"14a Adam {dtype}", last < first and last - e_dense < ADAM_GATE,
             first=first, last=last, e_dense=e_dense)
    refused = []
    for name, (fn, args, kwargs) in refusal_cases(device).items():
        slots = [(True, i) for i in range(len(args))] + [
            (False, k) for k, v in kwargs.items() if torch.is_tensor(v)]
        for positional, slot in slots:
            a, kw = list(args), dict(kwargs)
            if positional:
                a[slot] = a[slot].clone().requires_grad_()
            else:
                kw[slot] = kw[slot].clone().requires_grad_()
            before = route_counts()
            try:
                fn(*a, **kw)
            except RuntimeError as e:
                if "the kernel has no backward" not in str(e):
                    raise
            else:
                raise RuntimeError(f"14a {name} took a CUDA input that "
                                   f"requires grad")
            gate(f"14a {name} launched nothing",
                 not routes_of(fn.__name__, before))
        refused.append(f"{name} ({len(slots)} inputs)")
    log(f"14a the gradient gate refused a CUDA input that requires grad, "
        f"each input in turn, launching nothing: {', '.join(refused)}")


def nan_trap_on_card(device, smi):
    """14b: one NaN in the input of phase 4's CN step at r16. With
    debug_nans the step raises FloatingPointError naming the first op or
    kernel to return a NaN. Without it, the NaN runs on: to the output, or
    into cuSOLVER's eigh of the rounding's Gram, which then raises a
    LinAlgError that does not name the NaN (on the CPU, LAPACK returns
    NaN). The clean step under the trap raises nothing and equals the
    step without it."""
    from ttnx_torch.kernels.dispatch import launch_counts
    from ttnx_torch.utils.validation import debug_nans

    step_fn, us, _ = setup(16, device)
    bad = us.clone()
    bad[0, 0, 0, 0] = float("nan")
    before = launch_counts()
    with debug_nans():
        try:
            step_fn(bad)
        except FloatingPointError as e:
            message = str(e)
        else:
            raise RuntimeError("14b: the NaN trap let a NaN through")
    inside = {k: v - before[k] for k, v in launch_counts().items()
              if v != before[k]}
    log(f"14b CN step d={D} r16 f32 with one NaN at site 0, trap on: "
        f"FloatingPointError '{message}' (launches before it {inside}) | "
        f"{smi}")
    try:
        out = step_fn(bad)
        torch.cuda.synchronize()
        off = f"the step runs, NaN in the output {bool(torch.isnan(out).any())}"
        gate("14b trap off", bool(torch.isnan(out).any()))
    except torch.linalg.LinAlgError as e:
        off = f"LinAlgError '{str(e).splitlines()[0]}'"
    with debug_nans():  # no false alarm on the clean input
        clean = step_fn(us)
    same = bool(torch.equal(clean, step_fn(us)))
    log(f"14b trap off: {off} | the clean step under the trap runs and "
        f"equals it without: {same}")
    gate("14b clean step under the trap", same)


def examples_on_card(device, smi):
    """14c: every script of examples_torch/ in this process (runpy), the
    launch counts reset before each; returns the launches of all."""
    import io
    import runpy
    from pathlib import Path

    from ttnx_torch.kernels.dispatch import launch_counts, reset_launch_counts

    total = {}
    scripts = sorted((Path(__file__).resolve().parent
                      / "examples_torch").glob("*.py"))
    for path in scripts:
        name = path.stem
        reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        stopped = None
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(str(path), run_name="__main__")
        except AssertionError:
            twin = FAILS_AS_ITS_TWIN.get(name)
            if twin is None or twin not in buf.getvalue():
                raise
            stopped = twin
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if name in FAILS_AS_ITS_TWIN and stopped is None:
            raise RuntimeError(f"14c {name} passed where its twin fails")
        launched = {k: v for k, v in launch_counts().items() if v}
        want = EXAMPLE_LAUNCHES.get(name, {})
        gate(f"14c {name} launches", launched == want, launched=launched,
             want=want)
        add_counts(total, launched)
        lines = buf.getvalue().strip().splitlines()
        last = (f"stops at its twin's assert after '{stopped}'" if stopped
                else lines[-1] if lines else "")
        log(f"14c {name}: {secs:.1f} s wall | launches {launched} | {last}")
    log(f"14c {len(scripts)} scripts on {device} | {smi}")
    return total


def phase_autograd_examples(device):
    """14: autograd on the card, the NaN trap on a kernel path and the
    examples; returns the examples' launches."""
    smi = smi_line()
    timed("14a", autograd_on_card, device, smi)
    timed("14b", nan_trap_on_card, device, smi)
    return timed("14c", examples_on_card, device, smi)


def summarize(rows, path_rows, counts):
    """One JSON row per kernel at the type and rank where its path runs
    it: f32 at rank 64 (B3, B9, B10 at 16; B5 and B6, right, at B =
    BATCH; B9 the sweep's own K at iters 8, B10 the convection step's K),
    B11-B13 the bf16 contraction path with the error of the bf16
    comparison at 8 iterations."""
    pick = {"cg_solve_fused": 16, "lanczos_fused": 16,
            "bicgstab_solve_fused": CONV_RMAX}
    tag = {"cg_matfree_fused_batched": f" B={BATCH}",  # the path's batch
           "env_chain_fused_batched": f" B={BATCH} right",
           "qr_batched": f" B={BATCH} cols"}
    summary = []
    for name, (label, _, source, replaces) in KERNELS.items():
        held = [r for r in rows if r["name"] == name]
        r = next((r for r in path_rows if r["name"] == name), None)
        if r is None:
            r = next(r for r in held if r["dtype"] == torch.float32
                     and r["rmax"] == pick.get(name, 64)
                     and r["tag"] == tag.get(name, r["tag"]))
        else:
            r["abs_err"] = next(h["abs_err"] for h in held
                                if h["dtype"] == torch.bfloat16)
        bound_ms, by = bound(r)
        if r.get("route") == "site":
            source = "ttnx_torch/csrc/als_sweep_site.cu"
        if r.get("route") == "resident" and label in ("B4", "B5"):
            source = "ttnx_torch/csrc/local_cg_site.cu"
        if r.get("route") == "cluster" and label == "B4":
            source = "ttnx_torch/csrc/local_cg_cluster.cu"
        if r.get("route") in ("resident", "cluster") and label in ("B2",
                                                                   "B6",
                                                                   "B8"):
            source = "ttnx_torch/csrc/env_chain_site.cu"
        if r.get("route") == "grid":
            source = "ttnx_torch/csrc/gram_chain_grid.cu"
        summary.append({"name": f"{label} {name}", "route": "cuda",
                        "kernel_route": r.get("route"),
                        "source": source, "replaces": replaces,
                        "launches": counts[name],
                        "max_abs_err": r["abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
                        "bound_by": by,
                        "library_ms": r.get("library_ms")})
    return summary


def timed(label, phase, *args):
    """``phase(*args)``, logging its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"phase {label}: {time.perf_counter() - t0:.1f} s wall")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    import ttnx_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda", 0)
    # full-f32 products in the plain versions the kernels are held against
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()
    phase_device()
    timed("2", phase_build)
    rows = (timed("3", phase_kernels, device)
            + timed("3b", phase_batched_kernels, device)
            + timed("3c", phase_dmrg_kernels, device)
            + timed("3d", phase_new_kernels, device))
    counts = timed("4", phase_main_path, device)
    later = list(timed("5", phase_batched_path, device).values())
    timed("3e", phase_env_routes, device)
    timed("3f", phase_gram_envA_routes, device)
    later += [timed("6", phase_dmrg_path, device),
              timed("7", phase_tdvp_path, device),
              timed("8", phase_convection_path, device)]
    contraction_counts, path_rows = timed("9", phase_contraction_path,
                                          device)
    later += [contraction_counts, timed("10", phase_qtt_path, device)]
    timed("11", phase_eager_tier, device)
    timed("12", phase_cross, device)
    for path_counts in later:
        for name, n in path_counts.items():
            if name not in CN_KERNELS:
                counts[name] = counts.get(name, 0) + n
    add_counts(counts, timed("13", phase_distributed, device))
    add_counts(counts, timed("14", phase_autograd_examples, device))
    missing = [k for k in KERNELS if counts.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"the main paths launched no {missing}")
    summary = summarize(rows, path_rows, counts)
    log(f"chip_smoke: {time.perf_counter() - start:.1f} s wall in all")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
