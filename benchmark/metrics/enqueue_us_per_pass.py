"""enqueue_us_per_pass (us, layer "engine loop"): the host's own time to
enqueue a pass. The mean, over the pass ranges the program records in the
window ("lbm_tpu_torch: pass"), of the range's length minus the union of the
CUDA runtime and driver calls inside it: the launches' wait in a full queue
left out, what remains is the Python and argument work of a pass, the
headroom the host has before it sets the pace. Read with tracing on, so an
upper bound of the untraced cost. None where the program records no pass."""

from benchmark import devtrace, spans


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    passes = spans.passes(t)
    if not passes:
        return None
    calls = devtrace.busy_in_spans(spans.runtime_calls(t), passes)
    return sum((b - a) - c for (a, b), c in zip(passes, calls)) / len(passes)
