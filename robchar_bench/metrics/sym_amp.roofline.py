"""sym_amp.roofline: kernel 3's share of its roofline, in %, over the
profiled pools: the least time the chip could take for the evaluations
the pools' restarts billed (run()'s func_calls over the mix's calls an
evaluation; the candidate slots the sequential algorithm would not
consult, finished and pending lanes' slots and the final re-evaluation
count no work) with counts/sym_amp.py at the configuration's sweeps and
counts/peaks.py, over the summed device time of the kernels whose name
contains PATTERN (both routes of csrc/sym_jacobi_amp.cu).  A kernel that
replaces it keeps a name that PATTERN matches.  Moves
zoo_restarts_per_s."""

from robchar_bench.counts import herm_jacobi, peaks, sym_amp

PATTERN = "sym_jacobi_amp"


def read(ctx):
    kernels = ctx["trace"].kernels(PATTERN)
    evals = ctx["work"].get("evals")
    if not kernels or not evals:
        return None
    cfg = ctx["config"]
    n = cfg["n"]
    sweeps = herm_jacobi.sweeps(cfg["dtype"], n)
    seconds = sum(e - s for _, s, e in kernels) / 1e6
    bound = peaks.bound_s(evals * sym_amp.flops(n, sweeps),
                          evals * sym_amp.nbytes(n))
    return 100.0 * bound / seconds
