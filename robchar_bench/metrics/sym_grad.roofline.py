"""sym_grad.roofline: kernel 2's share of its roofline, in %, over the
profiled pools: the least time the chip could take for the gradient
evaluations the pools' restarts billed (run()'s func_calls over the two
calls the noiseless branch bills an evaluation; padded and finished lanes
count no work) with counts/sym_grad.py and counts/peaks.py, over the
summed device time of the kernels whose name contains PATTERN.  A kernel
that replaces csrc/sym_jacobi_grad.cu keeps a name that PATTERN matches.
Moves zoo_restarts_per_s."""

from robchar_bench.counts import peaks, sym_grad

PATTERN = "sym_jacobi_grad"


def read(ctx):
    kernels = ctx["trace"].kernels(PATTERN)
    evals = ctx["work"].get("grad_evals")
    if not kernels or not evals:
        return None
    n = ctx["config"]["n"]
    seconds = sum(e - s for _, s, e in kernels) / 1e6
    bound = peaks.bound_s(evals * sym_grad.flops(n),
                          evals * sym_grad.nbytes(n))
    return 100.0 * bound / seconds
