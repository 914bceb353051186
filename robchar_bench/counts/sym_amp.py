"""Work of kernel 3 (csrc/sym_jacobi_amp.cu): the transfer amplitude of one
real symmetric n x n Hamiltonian.

Operations: counts/rollout.amp_flops, frozen from chip_smoke.py:493
(``_amp_flops``): the Jacobi sweeps carrying the two eigenvector rows of
the transfer's sites, and the amplitude's sum (6 n + 2); ``sweeps`` as
counts/herm_jacobi.sweeps gives them.  Bytes, per matrix, float32
(chip_smoke.py:1817, ``4 * b * (n * n + 1 + 2)``): the matrix and the time
read, the amplitude's two parts written."""

from robchar_bench.counts.rollout import amp_flops


def flops(n: int, sweeps: int) -> int:
    """Operations for one matrix."""
    return amp_flops(n, sweeps)


def nbytes(n: int) -> int:
    """Bytes for one matrix."""
    return 4 * (n * n + 3)
