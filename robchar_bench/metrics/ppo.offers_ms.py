"""ppo.offers_ms: host milliseconds an epoch that PPO_en.run() spends
offering the epoch's (reward, controller) pairs to its top-c store, the
mean over the profiled epochs: the summed duration of the program's
``record.offers`` spans (utils/record.TopControllers.offer_many, one call
an epoch) over the epochs (env steps over agents x steps an epoch).  A
program without the spans reads nothing.  Moves ppo_env_steps_per_s."""

SPAN = "record.offers"


def read(ctx):
    mix = ctx["mix"]
    steps = ctx["work"].get("env_steps")
    spans = [e - s for name, s, e in ctx["trace"].host if name == SPAN]
    if not spans or not steps:
        return None
    epochs = steps / (mix["agents"] * mix["steps_per_epoch"])
    return sum(spans) / 1e3 / epochs
