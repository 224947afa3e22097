"""What the benchmark reads from a `torch.profiler` trace of its window, and
the interval arithmetic of the per-layer metrics.

The window and each job are ranges the harness records itself (WINDOW,
JOB). Device events are the trace's kernels, memory copies and memory sets,
on the host's clock; host events are what the host was running (operators,
runtime calls, the harness's own ranges). Times are in microseconds.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import tempfile
from pathlib import Path

WINDOW = "benchmark: window"
JOB = "benchmark: job"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
LONG_US = 1_000.0
ATTRIBUTED = 1_000


@dataclasses.dataclass
class Trace:
    window: tuple[float, float]
    jobs: list[tuple[float, float]]
    device: list[tuple[str, str, float, float]]  # (name, kind, start, end)
    host: list[tuple[str, float, float]]

    def kernels(self) -> list[tuple[float, float]]:
        return [(a, b) for _, kind, a, b in self.device if kind == "kernel"]

    def device_intervals(self) -> list[tuple[float, float]]:
        return [(a, b) for _, _, a, b in self.device]


def from_events(events) -> Trace:
    """A Trace from (name, kind, start_us, end_us) tuples; kind is the
    profiler's activity type."""
    device, host, window, jobs = [], [], None, []
    for name, kind, a, b in events:
        if kind in DEVICE_KINDS:
            device.append((name, kind, a, b))
        elif kind in HOST_KINDS:
            if name == WINDOW:
                window = (a, b)
            elif name == JOB:
                jobs.append((a, b))
            host.append((name, a, b))
    if window is None:
        raise ValueError(f"the trace holds no {WINDOW!r} range")
    return Trace(window=window, jobs=sorted(jobs), device=device, host=host)


def from_profiler(prof, card: int | None = None) -> Trace:
    """A Trace from a finished torch.profiler.profile, through its Chrome
    trace, written to a temporary file (under TMPDIR) and removed; with
    `card`, the device events of that card only (see from_chrome)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        data = json.loads(path.read_text())
    return from_chrome(data, card)


def from_chrome(data, card: int | None = None) -> Trace:
    """A Trace from a Chrome trace's JSON (a dict with "traceEvents", or
    the list of events). With `card`, a device event that names another
    card (its "args"' "device") is left out: a process traces what it ran on
    every card, and a rank's trace stands for its own."""
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    return from_events((e.get("name", ""), e.get("cat"), float(e["ts"]),
                        float(e["ts"]) + float(e["dur"]))
                       for e in events if e.get("ph") == "X" and "dur" in e
                       and (card is None or e.get("cat") not in DEVICE_KINDS
                            or e.get("args", {}).get("device", card) == card))


def union(intervals) -> float:
    """The length covered by the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of `intervals` inside [lo, hi]."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def busy(trace: Trace) -> dict:
    """A rank's traced figures: `busy_s`, the seconds in which an operation
    ran on its card inside the traced window, `window_s`, the window's
    length, and `busy_share`, the one over the other."""
    lo, hi = trace.window
    busy_s = union(clip(trace.device_intervals(), lo, hi)) / 1e6
    window_s = (hi - lo) / 1e6
    return {"busy_s": busy_s, "window_s": window_s, "busy_share": busy_s / window_s}


def busy_in_spans(intervals, spans) -> list[float]:
    """For each (start, end) span, the length of the union of `intervals`
    inside it."""
    ordered = sorted(intervals)
    starts = [a for a, _ in ordered]
    # an interval that ends after a span's start may begin before it, by
    # at most the longest interval's length
    longest = max((b - a for a, b in ordered), default=0.0)
    out = []
    for lo, hi in spans:
        first = bisect.bisect_left(starts, lo - longest)
        last = bisect.bisect_right(starts, hi)
        out.append(union(clip(ordered[first:last], lo, hi)))
    return out


def merged(intervals) -> list[tuple[float, float]]:
    """The union of intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def device_ops(trace: Trace, n: int = 10) -> list[list]:
    """The n device operations that took most time in the window: [name,
    seconds], summed over their events."""
    lo, hi = trace.window
    total: dict = collections.defaultdict(float)
    for name, _, a, b in trace.device:
        for x, y in clip([(a, b)], lo, hi):
            total[name] += (y - x) / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: Trace, n: int = 10) -> list[list]:
    """The idle time of the device in the window by what the host was doing
    then: [host activity, seconds], the n largest. Each of the ATTRIBUTED
    longest gaps is named by the innermost host event running at its middle
    (the shortest one that covers it), or "(no host event)"; the shorter
    gaps are summed as "(shorter gaps)"."""
    lo, hi = trace.window
    busy = merged(clip(trace.device_intervals(), lo, hi))
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])
    # the few long host events (the window, the jobs) are searched whole,
    # the many short ones by their start
    long_ = [h for h in trace.host if h[2] - h[1] > LONG_US]
    short = sorted((h for h in trace.host if h[2] - h[1] <= LONG_US), key=lambda h: h[1])
    starts = [a for _, a, _ in short]
    total: dict = collections.defaultdict(float)
    for a, b in gaps[ATTRIBUTED:]:
        total["(shorter gaps)"] += (b - a) / 1e6
    for a, b in gaps[:ATTRIBUTED]:
        mid = (a + b) / 2
        first = bisect.bisect_left(starts, mid - LONG_US)
        last = bisect.bisect_right(starts, mid)
        covering = [(y - x, name) for name, x, y in short[first:last] + long_
                    if x <= mid <= y]
        total[min(covering)[1] if covering else "(no host event)"] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
