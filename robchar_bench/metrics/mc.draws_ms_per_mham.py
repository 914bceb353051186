"""mc.draws_ms_per_mham: host milliseconds in the MC chunk loop's draws
per million Hamiltonians characterised, over the profiled units: the
summed duration of the program's ``mc.draws`` spans (mc/engine.py: each
chunk's key fold_in and lanes assembly, ops/prng and ops/noise), which
enqueue most of the chunk's device operations.  A program without the
spans reads nothing.  Moves mc_hams_per_s."""

SPAN = "mc.draws"


def read(ctx):
    hams = ctx["work"].get("hams")
    spans = [e - s for name, s, e in ctx["trace"].host if name == SPAN]
    if not spans or not hams:
        return None
    return sum(spans) / 1e3 / (hams / 1e6)
