"""nm.syncs_per_restart: the host's reads of a device-side exit condition
in the Nelder-Mead round loop (its ``stats["syncs"]``, one a round and the
one that ends the loop, each waiting for the device to finish what the
host enqueued before it) per
restart of the profiled pools.  A program without the counter reads
nothing.  Moves zoo_restarts_per_s."""


def read(ctx):
    syncs = ctx["work"].get("syncs")
    restarts = ctx["work"].get("restarts")
    if not syncs or not restarts:
        return None
    return syncs / restarts
