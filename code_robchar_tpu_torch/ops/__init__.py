"""Numeric ops: threefry PRNG, chain Hamiltonians, structured noise, the
plain Jacobi transfer fidelity and its CUDA kernel."""

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
)
from code_robchar_tpu_torch.ops.realform import fidelity_herm_lanes
from code_robchar_tpu_torch.ops.cuda_jacobi import fidelity_herm

__all__ = [
    "xx_hamiltonian",
    "xx_hamiltonian_real",
    "basis_state",
    "control_projectors",
    "add_bias",
    "structured_perturbation",
    "structured_perturbation_parts",
    "assemble_lanes",
    "fidelity_herm_lanes",
    "fidelity_herm",
]
