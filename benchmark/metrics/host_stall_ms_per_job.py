"""host_stall_ms_per_job (ms, layer "runner"): the device's idle time inside
the jobs' spans that lies outside every engine loop's device extent (see
launch_gap_us_per_pass), per job: the time the card waits on the runner's
host phases and syncs (start state, engine choice, copy-out, total density,
the glue between them). With the launch gaps and the copies and sets that
no kernel covers it makes up runner_ms_per_job exactly (benchmark/spans.py,
`split`). None where the program records no engine loop, or launch calls
and kernels do not pair."""

from benchmark import spans


def read(ctx):
    parts = spans.split(ctx.trace)
    if parts is None:
        return None
    return parts["stall"] / parts["jobs"] / 1e3
