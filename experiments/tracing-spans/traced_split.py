"""One traced run of a benchmark cell, as `benchmark/run.py --trace 1` makes
it, and then what the program's ranges say of it: the launch calls and
kernels the trace holds (they must pair one to one), the runner's split
(`benchmark/spans.py`), and how far runner_ms_per_job lies from the sum of
its parts.

    python3 experiments/tracing-spans/traced_split.py --root <checkout> \
        --workload d2q9-cavity.f32 --seed 2147483901 --seconds 10

`--root` is the checkout whose program and benchmark run (default: this
one). The run's own lines come first, as run.py prints them; the split is
the last line of standard output, a JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path


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
           "loops": len(spans.loops(t)), "passes": len(spans.passes(t)), "split": parts}
    if parts:
        jobs = parts["jobs"]
        terms = {k: parts[k] / jobs / 1e3 for k in ("gaps", "stall", "copies")}
        out.update(runner_ms_per_job=runner, terms_ms_per_job=terms,
                   identity_rel_err=abs(runner - sum(terms.values())) / runner)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
