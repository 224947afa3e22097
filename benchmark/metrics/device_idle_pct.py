"""device_idle_pct (%, layer "device"): the share of the traced window in
which nothing ran on the card: 1 - (the union of every kernel, copy and set
inside the window) / (the window), x 100. On n ranks, each the mean over the
ranks, as the result's `busy_s` and `window_s` are (`harness.device_block`):
the idle share worked out from those is this one."""


def read(ctx):
    d = ctx.device
    if not d.get("busy_s"):
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
