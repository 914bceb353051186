"""ppo.values_gae_ms: milliseconds an epoch of the values, log-probabilities
and GAE stage of models/ppo.py's epoch (the host's 500-step GAE loop), from
CUDA events the driver records at the epoch's stage boundaries
(``PPO_en.stage_hook``) in the traced run, the mean over the traced
epochs.  Moves ppo_env_steps_per_s."""


def read(ctx):
    stages = ctx["job"].program.get("stages")
    if not stages:
        return None
    ms = [e["true_fid"].elapsed_time(e["values"]) for e in stages
          if "true_fid" in e and "values" in e]
    return sum(ms) / len(ms) if ms else None
