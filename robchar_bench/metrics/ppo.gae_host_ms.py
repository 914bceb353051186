"""ppo.gae_host_ms: host milliseconds an epoch in the PPO epoch's GAE loop
(models/ppo.gae_and_returns, a reverse loop over the epoch's steps that
enqueues a few torch operations a step), the mean over the profiled
epochs: the summed duration of the program's ``ppo.gae`` spans over the
epochs (env steps over agents x steps an epoch).  A program without the
spans reads nothing.  Moves ppo_env_steps_per_s."""

SPAN = "ppo.gae"


def read(ctx):
    mix = ctx["mix"]
    steps = ctx["work"].get("env_steps")
    spans = [e - s for name, s, e in ctx["trace"].host if name == SPAN]
    if not spans or not steps:
        return None
    epochs = steps / (mix["agents"] * mix["steps_per_epoch"])
    return sum(spans) / 1e3 / epochs
