"""Work of kernel 1 (csrc/herm_jacobi_fidelity.cu): the transfer fidelity of
one complex Hermitian n x n Hamiltonian by cyclic Jacobi.

Operations: the hand count of artifacts/perf/roofline.py:56-72, frozen from
chip_smoke.py:485-490 (``_pairs``, ``_herm_flops``): per sweep and pivot
pair the angle set-up (34), each off-pivot row (26), the pivot block (7)
and the two carried complex eigenvector rows (48), then the reconstruction
(14 n + 3).  SWEEPS is the float32 sweep count of the reference algorithm
for n <= 8 (ops/realform.py:53-57), the count chip_smoke.py:702 takes.
Bytes: each input read once and each output written once, float32: the
real and imaginary matrices, the time and the fidelity (chip_smoke.py:702,
``4 * b * (2 * n * n + 2)``)."""

SWEEPS = 5


def pairs(n: int) -> int:
    return n * (n - 1) // 2


def flops(n: int, sweeps: int = SWEEPS) -> int:
    """Operations for one Hamiltonian."""
    return sweeps * pairs(n) * (34 + 26 * (n - 2) + 7 + 48) + 14 * n + 3


def nbytes(n: int) -> int:
    """Bytes for one Hamiltonian."""
    return 4 * (2 * n * n + 2)
