"""nm.lane_use: the share of the Nelder-Mead round loop's evaluated slots,
in %, that a restart billed, over the profiled pools: the evaluations run()
billed (``evals`` of drivers/nm.py) over the loop's rounds (its
``stats["rounds"]``) times the mix's lane width times the points a lane
puts into each round's batch, max(4, d + 1) with d = n + 1 parameters
(models/nmplus.py).  Candidate slots the sequential algorithm would not
consult, and slots of finished or idle lanes, count as unused.  A program
without the counter reads nothing.  Moves zoo_restarts_per_s."""


def read(ctx):
    evals = ctx["work"].get("evals")
    rounds = ctx["work"].get("rounds")
    if not evals or not rounds:
        return None
    slots = max(4, ctx["config"]["n"] + 2)
    return 100.0 * evals / (
        rounds * ctx["mix"]["options"]["lane_width"] * slots)
