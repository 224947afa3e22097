"""device_idle_pct (%, layer "device"): the share of the traced window in
which nothing ran on the card: 1 - (the union of every kernel, copy and set
inside the window) / (the window), x 100."""

from benchmark import devtrace


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    lo, hi = t.window
    return 100.0 * (1.0 - devtrace.union(devtrace.clip(t.device_intervals(), lo, hi)) / (hi - lo))
