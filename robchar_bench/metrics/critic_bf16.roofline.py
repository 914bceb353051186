"""critic_bf16.roofline: kernel 5's share of its roofline with bfloat16
operands, in %, over the profiled epochs: the least time the chip could
take for the critic's iterations (counts/critic_bf16.py: the products at
the bf16 tensor-core peak, the rest at the float32 peak; counts/peaks.py),
over the summed device time of the kernels whose name contains PATTERN.  A
kernel that replaces csrc/critic_train_bf16.cu keeps a name that PATTERN
matches.  Moves ppo_env_steps_per_s."""

from robchar_bench.counts import critic_bf16, peaks

PATTERN = "critic_train_bf16"
HIDDEN = 100


def read(ctx):
    kernels = ctx["trace"].kernels(PATTERN)
    mix, d1 = ctx["mix"], ctx["config"]["n"] + 2
    steps = ctx["work"].get("env_steps")
    if not kernels or not steps:
        return None
    agents, t_len = mix["agents"], mix["steps_per_epoch"]
    epochs = steps / (agents * t_len)
    macs, other = critic_bf16.iter_ops(d1, HIDDEN, t_len)
    iters = agents * mix["train_v_iters"]
    bound = epochs * peaks.bound_s(
        iters * other, critic_bf16.nbytes(d1, HIDDEN, agents, t_len),
        bf16_flops=iters * macs)
    seconds = sum(e - s for _, s, e in kernels) / 1e6
    return 100.0 * bound / seconds
