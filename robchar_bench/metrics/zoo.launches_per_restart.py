"""zoo.launches_per_restart: kernel launches the host made (the runtime's
launch calls in the trace) per restart of the profiled pools.  Layer:
models/base.run and the models/lbfgs restart loop, whose torch operations
are launched one by one.  Moves zoo_restarts_per_s."""


def read(ctx):
    restarts = ctx["work"].get("restarts")
    launches = ctx["trace"].launches()
    if not restarts or not launches:
        return None
    return launches / restarts
