"""ttnx_torch — tensor-train / quantics-tensor-train numerics on PyTorch and
CUDA (NVIDIA Hopper).

The port of ``ttnx`` (JAX) slice by slice: the Crank–Nicolson QTT heat
step, the batched ALS, the DMRG and TDVP scan tier, the last kernels
(dense-K BiCGStab behind ``solver='bicgstab_fused'``, the batched core
contractions of ``ttnx_torch.kernels.contraction``), the QTT constructor
library (operators, function encodings, multi-dimensional QTT wrappers,
the quantics Fourier transform, interpolation) and the scan-tier ALS
eigensolve and MALS, the eager solver tier (ALS, MALS, DMRG, the
TT-Krylov methods, TDVP and the four time steppers) with its config
objects and telemetry, and TT-cross with TT quadrature (the host MaxVol,
Greedy and DMRG cross; the device MaxVol and DMRG cross with a batch
axis) with the checkpoint, validation, resilience and profiling
utilities, and the autograd interop (the TT-manifold tools, ``debug_nans``,
``torch.optim`` on leaf cores; every kernel refuses gradients). Layouts match
``ttnx``: vector cores ``(r_left, n, r_right)``, operator cores
``(r_left, n_out, n_in, r_right)``, padded stacks ``(d, R, n, R)`` / ``(d,
RA, n, n, RA)``, masks ``(d+1, R)``, big-endian bits. Every device is
explicit.
"""

from ttnx_torch.config import (ALSConfig, DMRGConfig, KrylovConfig,
                               MALSConfig, TDVPConfig, matmul_precision)
from ttnx_torch.core.algebra import (add, add_op, dot, euclidean_distance,
                                     euclidean_distance_normalized, hadamard,
                                     hadamard_ttm, inner_core_product,
                                     kron_tt, kron_tto, linear_combination,
                                     matmul, matvec, norm, outer_product,
                                     scale, scale_op, sub, sub_op,
                                     ttv_to_diag_tto)
from ttnx_torch.core.canonical import (entanglement_entropy,
                                       entanglemententropy, orthogonalize,
                                       svdtrunc, tt_compress, tt_round)
from ttnx_torch.core.decomp import (matricize, tto_decomp, tto_to_tensor,
                                    tto_to_ttv, ttv_decomp, ttv_to_tensor,
                                    ttv_to_tto)
from ttnx_torch.core.tt import (TTOperator, TTVector, concatenate, id_tto,
                                increase_ranks, ones_tt, r_and_d_to_rks,
                                rand_tt, rand_tt_like, rand_tto, visualize,
                                zeros_tt, zeros_tto)
from ttnx_torch.cross.cross import (DMRG, DMRGCross, Greedy, MaxVol,
                                    MaxVolPivot, RandomPivot, tt_cross,
                                    tt_integrate)
from ttnx_torch.kernels.dispatch import launch_counts, reset_launch_counts
from ttnx_torch.ops.fourier import fourier_qtto, reverse_qtt_bits
from ttnx_torch.ops.interpolation import (interpolating_qtt,
                                          lagrange_rank_revealing)
from ttnx_torch.ops.operators import (H_mu, H_munu, gradient,
                                      heisenberg_xyz_tto, inv_laplacian_DN,
                                      ising_tto, laplacian, laplacian_DN,
                                      laplacian_ND, laplacian_NN,
                                      laplacian_P, pauli_matrix,
                                      pauli_pair_sum_tto, pauli_sum_tto,
                                      qtt_laplacian,
                                      qtto_constant_prolongation,
                                      qtto_linear_prolongation,
                                      qtto_prolongation, shift,
                                      toeplitz_to_qtto, xxx_tto, xxz_tto,
                                      xy_tto, Δ, Δ_DN, Δ_ND, Δ_NN, Δ_P)
from ttnx_torch.ops.qtt import (QTTOperator, QTTVector, check_compat,
                                function_to_qtt, function_to_qtt_uniform,
                                function_to_qttv, function_to_tensor,
                                gauss_chebyshev_lobatto, index_to_point,
                                qtt_basis_vector, qtt_chebyshev, qtt_cos,
                                qtt_exp, qtt_polynom, qtt_sin,
                                qtt_to_function, qtt_to_vector,
                                qtt_trapezoidal, qtto_to_matrix,
                                qttv_to_array, reorder, tensor_to_grid,
                                to_qtt, to_ttv, tuple_to_index)
from ttnx_torch.parallel.batch import (batched_als_sweeps,
                                       batched_dmrg_eig_sweeps,
                                       batched_tdvp1_steps,
                                       batched_tdvp2_steps)
from ttnx_torch.solvers.als import (als_eigsolve, als_gen_eigsolv,
                                    als_linsolve)
from ttnx_torch.solvers.als_scan import (als_eigsolve_scan,
                                         als_eigsolve_sweeps,
                                         als_linsolve_scan, als_sweeps,
                                         pack_op, pack_tt, rank_masks,
                                         unpack_tt)
from ttnx_torch.solvers.dmrg_scan import (cut_off_mask, dmrg_eig_sweep,
                                          dmrg_eigsolve_scan,
                                          dmrg_linsolve_scan, dmrg_sweep)
from ttnx_torch.solvers.dmrg import dmrg_eigsolve, dmrg_linsolve
from ttnx_torch.solvers.krylov import (expintegrator_tt, expm_multiply,
                                       krylov_linsolve)
from ttnx_torch.solvers.mals import mals_eigsolve, mals_linsolve
from ttnx_torch.solvers.mals_scan import (mals_eig_sweep,
                                          mals_eigsolve_scan,
                                          mals_linsolve_scan, mals_sweep)
from ttnx_torch.solvers.round_scan import (cn_step, make_cn_evolve,
                                           make_cn_step, matvec_padded,
                                           tt_round_gram, tt_round_scan)
from ttnx_torch.solvers.steppers import (crank_nicholson_method,
                                         euler_method, implicit_euler_method,
                                         rk4_method)
from ttnx_torch.solvers.tdvp import tdvp, tdvp2
from ttnx_torch.solvers.tdvp_scan import (tdvp1_scan, tdvp1_step, tdvp2_scan,
                                          tdvp2_step)
from ttnx_torch.utils.checkpoint import load_tt, save_tt
from ttnx_torch.utils.convert import from_reference_layout, to_ttvector
from ttnx_torch.utils.manifold import (manifold_gradient_descent,
                                       rayleigh_quotient, ttvector_manifold)
from ttnx_torch.utils.profiling import SolverTelemetry, Timer

__all__ = [
    "TTVector", "TTOperator", "zeros_tt", "rand_tt", "id_tto",
    "r_and_d_to_rks", "add", "sub", "add_op", "sub_op", "scale", "scale_op",
    "matvec", "matmul", "dot", "norm", "ttv_decomp", "ttv_to_tensor",
    "orthogonalize", "svdtrunc", "tt_round", "toeplitz_to_qtto", "qtt_sin",
    "pack_tt", "pack_op", "unpack_tt", "rank_masks", "als_sweeps",
    "als_linsolve_scan", "matvec_padded", "tt_round_scan", "tt_round_gram",
    "cn_step", "make_cn_step", "make_cn_evolve", "launch_counts",
    "reset_launch_counts", "pauli_matrix", "pauli_sum_tto",
    "pauli_pair_sum_tto", "H_mu", "H_munu", "heisenberg_xyz_tto",
    "ising_tto", "xxz_tto", "xxx_tto", "xy_tto", "cut_off_mask",
    "dmrg_eig_sweep", "dmrg_sweep", "dmrg_eigsolve_scan",
    "dmrg_linsolve_scan", "tdvp1_step", "tdvp2_step", "tdvp1_scan",
    "tdvp2_scan", "batched_als_sweeps", "batched_dmrg_eig_sweeps",
    "batched_tdvp1_steps", "batched_tdvp2_steps", "shift", "gradient",
    "laplacian", "laplacian_DN", "laplacian_ND", "laplacian_NN",
    "laplacian_P", "inv_laplacian_DN", "qtto_prolongation",
    "qtto_constant_prolongation", "qtto_linear_prolongation",
    "qtt_laplacian", "Δ", "Δ_DN", "Δ_ND", "Δ_NN", "Δ_P",
    "gauss_chebyshev_lobatto", "index_to_point", "tuple_to_index",
    "function_to_tensor", "tensor_to_grid", "function_to_qtt",
    "function_to_qtt_uniform", "qtt_to_function", "qtt_to_vector",
    "qtt_polynom", "qtt_cos", "qtt_exp", "qtt_chebyshev",
    "qtt_basis_vector", "qtt_trapezoidal", "qtto_to_matrix", "to_qtt",
    "to_ttv", "QTTVector", "QTTOperator", "check_compat", "reorder",
    "function_to_qttv", "qttv_to_array", "fourier_qtto",
    "reverse_qtt_bits", "interpolating_qtt", "lagrange_rank_revealing",
    "als_eigsolve_sweeps", "als_eigsolve_scan", "mals_sweep",
    "mals_linsolve_scan", "mals_eig_sweep", "mals_eigsolve_scan",
    "als_linsolve", "als_eigsolve", "als_gen_eigsolv", "mals_linsolve",
    "mals_eigsolve", "dmrg_linsolve", "dmrg_eigsolve", "tdvp", "tdvp2",
    "euler_method", "implicit_euler_method", "crank_nicholson_method",
    "rk4_method", "krylov_linsolve", "expm_multiply", "expintegrator_tt",
    "ALSConfig", "DMRGConfig", "KrylovConfig", "MALSConfig", "TDVPConfig",
    "matmul_precision", "SolverTelemetry", "MaxVol", "Greedy", "DMRGCross",
    "DMRG", "MaxVolPivot", "RandomPivot", "tt_cross", "tt_integrate",
    "to_ttvector", "from_reference_layout", "save_tt", "load_tt", "Timer",
    "concatenate", "increase_ranks", "ones_tt", "rand_tt_like", "rand_tto",
    "visualize", "zeros_tto", "matricize", "tto_decomp", "tto_to_tensor",
    "tto_to_ttv", "ttv_to_tto", "entanglement_entropy",
    "entanglemententropy", "tt_compress", "euclidean_distance",
    "euclidean_distance_normalized", "hadamard", "hadamard_ttm",
    "inner_core_product", "kron_tt", "kron_tto", "linear_combination",
    "outer_product", "ttv_to_diag_tto", "ttvector_manifold",
    "rayleigh_quotient", "manifold_gradient_descent", "AbstractTTvector",
    "AbstractTToperator", "TTvector", "TToperator", "QTTvector",
    "QTToperator",
]

# the reference's names for the containers, as ttnx keeps them
AbstractTTvector = TTvector = TTVector
AbstractTToperator = TToperator = TTOperator
QTTvector = QTTVector
QTToperator = QTTOperator
