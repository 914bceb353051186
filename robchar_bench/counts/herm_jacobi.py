"""Work of kernel 1 (csrc/herm_jacobi_fidelity.cu): the transfer fidelity of
one complex Hermitian n x n Hamiltonian by cyclic Jacobi.

Operations: the hand count of artifacts/perf/roofline.py:56-72, frozen from
chip_smoke.py:485-490 (``_pairs``, ``_herm_flops``): per sweep and pivot
pair the angle set-up (34), each off-pivot row (26), the pivot block (7)
and the two carried complex eigenvector rows (48), then the reconstruction
(14 n + 3).  SWEEPS is the float32 sweep count of the reference algorithm
for n <= 8 (ops/realform.py:53-57), the count chip_smoke.py:702 takes;
``sweeps(dtype, n)`` is that algorithm's whole policy.
Bytes: each input read once and each output written once, ``itemsize``
bytes each (float32 by default): the real and imaginary matrices, the time
and the fidelity (chip_smoke.py:702, ``4 * b * (2 * n * n + 2)``)."""

SWEEPS = 5


def sweeps(dtype: str, n: int) -> int:
    """The reference algorithm's sweeps for a configuration's ``dtype``
    ("float32" or "float64"): 5 at float32, 9 at float64, and 1 or 2 more
    above n = 8."""
    if dtype == "float32":
        return 5 + (n > 8)
    if dtype == "float64":
        return 9 + 2 * (n > 8)
    raise ValueError(f"dtype must be float32 or float64, got {dtype!r}")


def pairs(n: int) -> int:
    return n * (n - 1) // 2


def flops(n: int, sweeps: int = SWEEPS) -> int:
    """Operations for one Hamiltonian."""
    return sweeps * pairs(n) * (34 + 26 * (n - 2) + 7 + 48) + 14 * n + 3


def nbytes(n: int, itemsize: int = 4) -> int:
    """Bytes for one Hamiltonian."""
    return itemsize * (2 * n * n + 2)
