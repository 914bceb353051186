"""Work of kernel 2 (csrc/sym_jacobi_grad.cu): the infidelity and its exact
(Daleckii-Krein) gradient for one controller of a real symmetric n-site
chain.

Operations: the hand count of artifacts/perf/roofline.py:64-91, frozen from
chip_smoke.py:485-501 (``_sym_rot_flops``, ``_grad_flops``): the Jacobi
sweeps carrying all n eigenvector rows, the fidelity (7 n + 4), the
Daleckii-Krein cache (12 n^2), the bias gradient (n^2 (5 n + 5) + 5 n) and
the time gradient (6 n).  SWEEPS as in counts/herm_jacobi.py.  Bytes, per
controller: the controller (n + 1 floats) read, the infidelity and the
gradient (1 + n + 1) written, float32; the drift (n^2 floats) is read once
a launch and left out here (chip_smoke.py:1024-1025 counts it once)."""

from robchar_bench.counts.herm_jacobi import SWEEPS, pairs


def rot_flops(n: int, vrows: int) -> int:
    return 27 + 6 * (n - 2) + 6 + 6 * vrows


def flops(n: int, sweeps: int = SWEEPS) -> int:
    """Operations for one gradient evaluation."""
    return (sweeps * pairs(n) * rot_flops(n, n) + 7 * n + 4
            + 12 * n * n + n * n * (5 * n + 5) + 5 * n + 6 * n)


def nbytes(n: int) -> int:
    """Bytes for one gradient evaluation."""
    return 4 * (2 * (n + 1) + 1)
