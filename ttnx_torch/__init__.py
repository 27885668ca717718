"""ttnx_torch — tensor-train / quantics-tensor-train numerics on PyTorch and
CUDA (NVIDIA Hopper).

The port of ``ttnx`` (JAX) slice by slice: the Crank–Nicolson QTT heat
step, the batched ALS, the DMRG and TDVP scan tier, and the last kernels
(dense-K BiCGStab behind ``solver='bicgstab_fused'``, the batched core
contractions of ``ttnx_torch.kernels.contraction``). Layouts match
``ttnx``: vector cores ``(r_left, n, r_right)``, operator cores
``(r_left, n_out, n_in, r_right)``, padded stacks ``(d, R, n, R)`` / ``(d,
RA, n, n, RA)``, masks ``(d+1, R)``, big-endian bits. Every device is
explicit.
"""

from ttnx_torch.core.algebra import (add, add_op, dot, matmul, matvec, norm,
                                     scale, scale_op, sub, sub_op)
from ttnx_torch.core.canonical import orthogonalize, svdtrunc, tt_round
from ttnx_torch.core.decomp import ttv_decomp, ttv_to_tensor
from ttnx_torch.core.tt import (TTOperator, TTVector, id_tto, r_and_d_to_rks,
                                rand_tt, zeros_tt)
from ttnx_torch.kernels.dispatch import launch_counts, reset_launch_counts
from ttnx_torch.ops.operators import (H_mu, H_munu, heisenberg_xyz_tto,
                                      ising_tto, pauli_matrix,
                                      pauli_pair_sum_tto, pauli_sum_tto,
                                      toeplitz_to_qtto, xxx_tto, xxz_tto,
                                      xy_tto)
from ttnx_torch.ops.qtt import qtt_sin
from ttnx_torch.parallel.batch import (batched_als_sweeps,
                                       batched_dmrg_eig_sweeps,
                                       batched_tdvp1_steps,
                                       batched_tdvp2_steps)
from ttnx_torch.solvers.als_scan import (als_linsolve_scan, als_sweeps,
                                         pack_op, pack_tt, rank_masks,
                                         unpack_tt)
from ttnx_torch.solvers.dmrg_scan import (cut_off_mask, dmrg_eig_sweep,
                                          dmrg_eigsolve_scan,
                                          dmrg_linsolve_scan, dmrg_sweep)
from ttnx_torch.solvers.round_scan import (cn_step, make_cn_evolve,
                                           make_cn_step, matvec_padded,
                                           tt_round_gram, tt_round_scan)
from ttnx_torch.solvers.tdvp_scan import (tdvp1_scan, tdvp1_step, tdvp2_scan,
                                          tdvp2_step)

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
    "batched_tdvp1_steps", "batched_tdvp2_steps",
]
