"""Numeric ops: threefry PRNG, chain Hamiltonians, structured noise, the
plain Jacobi solvers and their CUDA kernels, the complex-eigh fidelities.  The PPO rollout and critic
kernels live in ops/rollout.py and ops/critic.py."""

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
    assemble_lanes,
    fixed_hamiltonian_ensemble,
)
from code_robchar_tpu_torch.ops.realform import (
    fidelity_herm_lanes,
    transfer_amp_sym_lanes,
    fidelity_sym_lanes,
    jacobi_eigh_sym_lanes,
    infidelity_and_gradient_sym_lanes,
    jacobi_eigh_sym,
    fidelity_from_controller_sym,
    infidelity_and_gradient_sym,
)
from code_robchar_tpu_torch.ops.propagate import (
    propagator,
    transfer_fidelity,
    fidelity_from_controller,
    fidelity_batch,
)
from code_robchar_tpu_torch.ops.cuda_jacobi import (
    fidelity_herm,
    transfer_amp_sym,
    fidelity_sym,
)

__all__ = [
    "xx_hamiltonian",
    "xx_hamiltonian_real",
    "basis_state",
    "control_projectors",
    "add_bias",
    "structured_perturbation",
    "structured_perturbation_parts",
    "assemble_lanes",
    "fixed_hamiltonian_ensemble",
    "fidelity_herm_lanes",
    "transfer_amp_sym_lanes",
    "fidelity_sym_lanes",
    "jacobi_eigh_sym_lanes",
    "infidelity_and_gradient_sym_lanes",
    "jacobi_eigh_sym",
    "fidelity_from_controller_sym",
    "infidelity_and_gradient_sym",
    "propagator",
    "transfer_fidelity",
    "fidelity_from_controller",
    "fidelity_batch",
    "fidelity_herm",
    "transfer_amp_sym",
    "fidelity_sym",
]
