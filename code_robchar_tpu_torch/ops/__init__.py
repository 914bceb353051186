"""Numeric ops: threefry PRNG, chain Hamiltonians, structured noise and
shot noise, the plain Jacobi solvers and their CUDA kernels, the
complex-eigh fidelities and gradient.  The PPO rollout and critic kernels
live in ops/rollout.py and ops/critic.py.

The names of code_robchar_tpu/ops/__init__.py mean what they mean there
(``fidelity_sym`` and ``fidelity_herm`` take (..., n, n) matrices); the
lanes-layout functions are exported beside them, and the kernels'
dispatch of the lanes fidelities is ``cuda_jacobi.fidelity_sym`` /
``cuda_jacobi.fidelity_herm``."""

from code_robchar_tpu_torch.ops.chain import (
    xx_hamiltonian,
    xx_hamiltonian_real,
    basis_state,
    control_projectors,
    add_bias,
)
from code_robchar_tpu_torch.ops.noise import (
    structured_perturbation,
    structured_perturbation_parts,
    directional_perturbation,
    shot_noise_fidelity,
    adaptive_shot_fidelity,
    assemble_lanes,
    fixed_hamiltonian_ensemble,
)
from code_robchar_tpu_torch.ops.realform import (
    jacobi_eigh_sym,
    jacobi_eigh_herm,
    fidelity_sym,
    fidelity_herm,
    fidelity_from_controller_sym,
    infidelity_and_gradient_sym,
    fidelity_herm_lanes,
    transfer_amp_sym_lanes,
    fidelity_sym_lanes,
    jacobi_eigh_sym_lanes,
    infidelity_and_gradient_sym_lanes,
)
from code_robchar_tpu_torch.ops.propagate import (
    propagator,
    transfer_fidelity,
    fidelity_from_controller,
    infidelity_and_gradient,
    overlap_ss,
    fidelity_batch,
)
from code_robchar_tpu_torch.ops.cuda_jacobi import transfer_amp_sym

__all__ = [
    "xx_hamiltonian",
    "xx_hamiltonian_real",
    "jacobi_eigh_sym",
    "jacobi_eigh_herm",
    "fidelity_sym",
    "fidelity_herm",
    "fidelity_from_controller_sym",
    "infidelity_and_gradient_sym",
    "basis_state",
    "control_projectors",
    "propagator",
    "transfer_fidelity",
    "fidelity_from_controller",
    "infidelity_and_gradient",
    "overlap_ss",
    "structured_perturbation",
    "directional_perturbation",
    "shot_noise_fidelity",
    "adaptive_shot_fidelity",
    "fixed_hamiltonian_ensemble",
    # the port's own
    "add_bias",
    "structured_perturbation_parts",
    "assemble_lanes",
    "fidelity_herm_lanes",
    "transfer_amp_sym_lanes",
    "fidelity_sym_lanes",
    "jacobi_eigh_sym_lanes",
    "infidelity_and_gradient_sym_lanes",
    "fidelity_batch",
    "transfer_amp_sym",
]
