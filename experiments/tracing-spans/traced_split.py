"""One traced run of a benchmark cell, as `benchmark/run.py --trace 1` makes
it, and then what the program's ranges say of it: the launch calls and
kernels the trace holds (they must pair one to one), the passes inside
each of `run_simulation`'s warm-up and timed runs and where in their loops
the device waits, the runner's split (`benchmark/spans.py`), and how far
runner_ms_per_job lies from the sum of its parts.

    python3 experiments/tracing-spans/traced_split.py --root <checkout> \
        --workload d2q9-cavity.f32 --seed 2147483901 --seconds 10

`--root` is the checkout whose program and benchmark run (default: this
one). The run's own lines come first, as run.py prints them; the split is
the last line of standard output, a JSON object.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import types
from pathlib import Path


# run_simulation's phases that hold engine loops
PHASES = ("lbm_tpu_torch: warm-up run", "lbm_tpu_torch: timed run")


def passes_in(trace, passes) -> dict:
    """For each of PHASES: its ranges in the window, and the fewest and most
    passes one of them holds."""
    from benchmark import spans

    out = {}
    for phase in PHASES:
        counts = [sum(1 for a, b in passes if lo <= a and b <= hi)
                  for lo, hi in spans.named(trace, lambda n, phase=phase: n == phase)]
        out[phase] = {"ranges": len(counts), "fewest": min(counts, default=None),
                      "most": max(counts, default=None)}
    return out


# passes of a loop by their index in it
BINS = ((0, 10), (10, 100), (100, 1000), (1000, 10**9))


def gap_profile(trace) -> dict | None:
    """For each of PHASES and each of BINS, over the loops inside the
    phase's ranges: the passes, the device's idle a pass before and
    between its kernels (µs), the host's time a pass range lasts (µs), and
    the share of passes whose first kernel started within 5 µs of the end
    of its launch call (the device waiting on the host). None where launch
    calls and kernels do not pair."""
    from benchmark import spans

    calls, kernels = spans.launch_calls(trace), sorted(trace.kernels())
    if len(calls) != len(kernels):
        return None
    starts = [a for a, _ in calls]
    passes = spans.passes(trace)
    out = {}
    for phase in PHASES:
        sums = [[0, 0.0, 0.0, 0] for _ in BINS]
        for lo, hi in spans.named(trace, lambda n, phase=phase: n == phase):
            prev = None
            inside = [p for p in passes if lo <= p[0] and p[1] <= hi]
            for i, (a, b) in enumerate(inside):
                first, last = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
                ks = kernels[first:last]
                if not ks:
                    continue
                gap = sum(max(0.0, n0 - k1) for (_, k1), (n0, _) in zip(ks, ks[1:]))
                if prev is not None:
                    gap += max(0.0, ks[0][0] - prev)
                prev = ks[-1][1]
                acc = sums[next(j for j, (x, y) in enumerate(BINS) if x <= i < y)]
                acc[0] += 1
                acc[1] += gap
                acc[2] += b - a
                acc[3] += ks[0][0] - calls[first][1] < 5
        out[phase] = {f"{x}-{y}": {"passes": n, "gap_us": g / n, "host_us": h / n,
                                   "waiting": w / n}
                      for (x, y), (n, g, h, w) in zip(BINS, sums) if n}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", required=True)
    parser.add_argument("--seconds", default="10")
    args = parser.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    sys.pycache_prefix = str(root / "build" / "pycache")
    sys.dont_write_bytecode = False

    from benchmark import devtrace, harness, spans

    if Path(harness.__file__).resolve().parents[1] != root:
        raise SystemExit(f"the benchmark was imported from {harness.__file__}, not {root}")
    traces = []
    parse = devtrace.from_profiler

    def keep(prof):
        traces.append(parse(prof))
        return traces[-1]

    devtrace.from_profiler = keep
    rc = harness.main(["--workload", args.workload, "--seed", args.seed, "--seconds",
                       args.seconds, "--trace", "1"])
    if rc or not traces:
        return rc or 1
    t = traces[0]
    parts = spans.split(t)
    runner = harness.reader(root / "benchmark", "runner_ms_per_job")(
        types.SimpleNamespace(trace=t))
    out = {"workload": args.workload, "root": str(root),
           "launch_calls": len(spans.launch_calls(t)), "kernels": len(t.kernels()),
           "loops": len(spans.loops(t)), "passes": len(spans.passes(t)),
           "passes_in": passes_in(t, spans.passes(t)), "gap_profile": gap_profile(t),
           "split": parts}
    if parts:
        jobs = parts["jobs"]
        terms = {k: parts[k] / jobs / 1e3 for k in ("gaps", "stall", "copies")}
        out.update(runner_ms_per_job=runner, terms_ms_per_job=terms,
                   identity_rel_err=abs(runner - sum(terms.values())) / runner)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
