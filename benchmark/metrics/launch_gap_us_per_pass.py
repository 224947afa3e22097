"""launch_gap_us_per_pass (us, layer "engine loop"): the device's idle time
inside the engine loops, per pass. For each engine loop the program records
in the window (its range "lbm_tpu_torch: engine <kernel> <path> K=<k>"),
the kernels it launched (its launch calls paired in time order with the
device's kernels), from the first one's start to the last one's end, minus
the union of every device event in that extent; summed over the loops and
divided by the pass ranges in them. This is what a pass costs in gaps
between its launches. None where the program records no loop, or launch
calls and kernels do not pair."""

from benchmark import spans


def read(ctx):
    parts = spans.split(ctx.trace)
    if parts is None or not parts["passes"]:
        return None
    return parts["gaps"] / parts["passes"]
