"""herm_jacobi.roofline: kernel 1's share of its roofline, in %, over the
profiled units: the least time the chip could take for the Hamiltonians
characterised (counts/herm_jacobi.py, counts/peaks.py) over the summed
device time of the kernels whose name contains PATTERN.  A kernel that
replaces csrc/herm_jacobi_fidelity.cu keeps a name that PATTERN matches.
Moves mc_hams_per_s."""

from robchar_bench.counts import herm_jacobi, peaks

PATTERN = "herm_jacobi"


def read(ctx):
    kernels = ctx["trace"].kernels(PATTERN)
    hams = ctx["work"].get("hams")
    if not kernels or not hams:
        return None
    n = ctx["config"]["n"]
    seconds = sum(e - s for _, s, e in kernels) / 1e6
    bound = peaks.bound_s(hams * herm_jacobi.flops(n),
                          hams * herm_jacobi.nbytes(n))
    return 100.0 * bound / seconds
