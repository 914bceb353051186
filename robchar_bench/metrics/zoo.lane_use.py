"""zoo.lane_use: the share of the L-BFGS restart loop's evaluated lanes, in
%, that a restart billed, over the profiled pools: the gradient
evaluations run() billed (``grad_evals`` of drivers/zoo.py) over the
program's ``lbfgs.trial`` spans (models/lbfgs.py, one per line-search
trial, each an evaluation of the whole lane batch) times the mix's lane
width.  Lanes of finished restarts and of trials a lane had no need of
count as unused.  A program without the spans reads nothing.  Moves
zoo_restarts_per_s."""

SPAN = "lbfgs.trial"


def read(ctx):
    evals = ctx["work"].get("grad_evals")
    trials = sum(name == SPAN for name, _, _ in ctx["trace"].host)
    if not trials or not evals:
        return None
    return 100.0 * evals / (trials * ctx["mix"]["options"]["lane_width"])
