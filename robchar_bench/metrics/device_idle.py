"""device_idle.<cell kind> (device_idle.mc, device_idle.ppo,
device_idle.zoo): the share of the profiled window, in %, in which no
operation ran on the device (1 - the union of the device intervals over
the window).  One quantity, split by the end-to-end metric it moves: each
entry of BENCHMARK.json names its cells and its rate."""


def read(ctx):
    tr = ctx["trace"]
    if not tr.device or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)
