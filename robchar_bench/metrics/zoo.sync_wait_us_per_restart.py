"""zoo.sync_wait_us_per_restart: host microseconds the L-BFGS restart loop
spends in its host reads of a device-side exit condition, per restart of
the profiled pools: the summed duration of the program's ``lbfgs.sync``
spans (models/lbfgs.py, one each round and each line-search trial after
the first) over the pools' restarts.  A read waits for the device to
finish what the host enqueued before it.  A program without the spans
reads nothing.  Moves zoo_restarts_per_s."""

SPAN = "lbfgs.sync"


def read(ctx):
    restarts = ctx["work"].get("restarts")
    spans = [e - s for name, s, e in ctx["trace"].host if name == SPAN]
    if not spans or not restarts:
        return None
    return sum(spans) / restarts
