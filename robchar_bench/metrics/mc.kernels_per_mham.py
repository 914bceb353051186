"""mc.kernels_per_mham: device operations (kernels, copies, fills) per
million Hamiltonians characterised, over the profiled units.  Layer:
mc/engine's chunk loop with the ops/prng and ops/noise draws, which
enqueue nearly all of them.  Moves mc_hams_per_s."""


def read(ctx):
    hams = ctx["work"].get("hams")
    if not hams or not ctx["trace"].device:
        return None
    return len(ctx["trace"].device) / (hams / 1e6)
