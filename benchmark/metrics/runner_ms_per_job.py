"""runner_ms_per_job (ms, layer "runner"): the part of a job's span in which
no kernel ran, averaged over the window's jobs. A job's span is the
harness's range around the entry's call; the kernels are every kernel of the
trace (memory copies and sets are not kernels, so they count here: the
uploads and the copies to the host are the runner's). So this is what the
runner adds around the engine's kernels: the host's start state, the
uploads, the engine choice, the launches' gaps, the syncs and the copy-out."""

from benchmark import devtrace


def read(ctx):
    t = ctx.trace
    if t is None or not t.jobs or not t.kernels():
        return None
    busy = devtrace.busy_in_spans(t.kernels(), t.jobs)
    return sum((b - a) - k for (a, b), k in zip(t.jobs, busy)) / len(t.jobs) / 1e3
