"""The program's own ranges in a trace of the window, and the interval
arithmetic of the metrics that read them.

The program records, while a profiler runs, one range around each engine
loop (ENGINE + "<kernel> <path> K=<k>") and one around each pass in it
(PASS), on the host clock the device's kernels and copies are put on. The
names are written here, not imported from the program: a program that
records none gives the readers nothing to read, and they return None.

A loop's kernels are found by pairing, in time order, the host's launch
calls with the device's kernels: one to one on the one stream a cell uses.
A loop's device extent runs from its first kernel's start to its last
kernel's end. Over the jobs of a window the runner's time splits exactly
(`split`): a job's span minus its kernels (runner_ms_per_job) is the idle
inside the loops' extents (the launch gaps), the idle outside them (the
host's stalls) and the copies and sets that no kernel covers. Times are in
microseconds.
"""

from __future__ import annotations

import bisect
import re

from benchmark import devtrace

ENGINE = "lbm_tpu_torch: engine "
PASS = "lbm_tpu_torch: pass"
# a CUDA runtime or driver call: cudaLaunchKernel, cuLaunchKernel, ...
RUNTIME = re.compile(r"cuda[A-Z]|cu[A-Z]")


def named(trace: devtrace.Trace, test) -> list[tuple[float, float]]:
    """The host events inside the window whose name passes `test`, sorted."""
    lo, hi = trace.window
    return sorted((a, b) for name, a, b in trace.host if test(name) and a >= lo and b <= hi)


def loops(trace: devtrace.Trace) -> list[tuple[float, float]]:
    return named(trace, lambda n: n.startswith(ENGINE))


def passes(trace: devtrace.Trace) -> list[tuple[float, float]]:
    return named(trace, lambda n: n == PASS)


def runtime_calls(trace: devtrace.Trace) -> list[tuple[float, float]]:
    return named(trace, RUNTIME.match)


def launch_calls(trace: devtrace.Trace) -> list[tuple[float, float]]:
    """Every launch call of the trace (cudaLaunchKernel, cuLaunchKernel,
    ...), in time order."""
    return sorted((a, b) for name, a, b in trace.host if RUNTIME.match(name) and "Launch" in name)


def extents(trace: devtrace.Trace):
    """[(device extent, passes)] for each engine loop in the window that
    launched a kernel; None where launch calls and kernels do not pair
    (their counts differ)."""
    calls, kernels = launch_calls(trace), sorted(trace.kernels())
    if len(calls) != len(kernels):
        return None
    starts = [a for a, _ in calls]
    pass_starts = [a for a, _ in passes(trace)]
    out = []
    for lo, hi in loops(trace):
        first, last = bisect.bisect_left(starts, lo), bisect.bisect_right(starts, hi)
        if last == first:
            continue
        ks = kernels[first:last]
        n = bisect.bisect_right(pass_starts, hi) - bisect.bisect_left(pass_starts, lo)
        out.append(((min(a for a, _ in ks), max(b for _, b in ks)), n))
    return out


def split(trace: devtrace.Trace) -> dict | None:
    """runner_ms_per_job's parts, summed over the window's jobs: "gaps"
    (each loop's extent minus the union of the device events in it),
    "stall" (the jobs' time in which the device is idle outside every
    extent), "copies" (the copies and sets that no kernel covers); with
    "passes" (of the loops with an extent) and "jobs". Their sum is the
    jobs' spans minus the kernels in them (runner_ms_per_job times the
    jobs) for loops that lie in the jobs. None where there is no job, no
    device event, no loop with an extent, or launches and kernels do not
    pair."""
    if trace is None or not trace.jobs or not trace.device:
        return None
    found = extents(trace)
    if not found:
        return None
    device = trace.device_intervals()
    ext = [e for e, _ in found]
    jobs = trace.jobs
    length = sum(b - a for a, b in jobs)
    return {
        "gaps": sum(b - a for a, b in ext) - sum(devtrace.busy_in_spans(device, ext)),
        "stall": length - sum(devtrace.busy_in_spans(device + ext, jobs)),
        "copies": (sum(devtrace.busy_in_spans(device, jobs))
                   - sum(devtrace.busy_in_spans(trace.kernels(), jobs))),
        "passes": sum(n for _, n in found),
        "jobs": len(jobs),
    }
