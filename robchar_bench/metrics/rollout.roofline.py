"""rollout.roofline: kernel 4's share of its roofline, in %, over the
profiled epochs: the least time the chip could take for agents x steps
env steps a traced epoch (counts/rollout.py at the mix's rollout sweeps,
counts/peaks.py), over the summed device time of the kernels whose name
contains PATTERN.  A kernel that replaces csrc/actor_env_rollout.cu keeps a
name that PATTERN matches.  Moves ppo_env_steps_per_s."""

from robchar_bench.counts import peaks, rollout

PATTERN = "actor_env_rollout"
HIDDEN = 100


def read(ctx):
    kernels = ctx["trace"].kernels(PATTERN)
    mix, n = ctx["mix"], ctx["config"]["n"]
    steps = ctx["work"].get("env_steps")
    if not kernels or not steps:
        return None
    epochs = steps / (mix["agents"] * mix["steps_per_epoch"])
    seconds = sum(e - s for _, s, e in kernels) / 1e6
    bound = epochs * peaks.bound_s(
        mix["agents"] * mix["steps_per_epoch"]
        * rollout.step_flops(n, HIDDEN, mix["rollout_sweeps"]),
        rollout.nbytes(n, HIDDEN, mix["agents"], mix["steps_per_epoch"]))
    return 100.0 * bound / seconds
