"""The runs that the bounds of BENCHMARK.json are set from.

    python3 benchmark/sets.py --workloads <name> ... --first-seed <n> --out <dir> \
        [--runs 6] [--sets 2] [--traced 3] [--seconds <s>]

For each cell in turn: `--sets` sets of `--runs` untraced runs of
`benchmark/run.py`, each run of a set on its own seed and every set on the
same seeds, then `--traced` traced runs on further seeds; every run is its
own process, one at a time, for `--seconds` (default: `run_seconds`). Each
run's result line, exit code and wall time go to `<dir>/runs.jsonl`, its
standard error to `<dir>/<cell>.<seed>.trace<t>.err`. Then for each cell
and end-to-end metric it prints the medians and spreads of the sets (`spread`:
the distance between the first and third quartile of
statistics.quantiles(n=4), as a share of the median; `spread_less_far`: the
same with the set's run farthest from its median left out) and the spread
of all its runs. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def less_far(values: list[float]) -> list[float]:
    """`values` without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def summary(rows: list[dict], metric: str) -> dict:
    """A cell's medians and spreads of `metric` by set, from its untraced runs."""
    sets: dict[int, list[float]] = {}
    for r in rows:
        if r["trace"] == 0 and r["result"] and metric in r["result"]["metrics"]:
            sets.setdefault(r["set"], []).append(r["result"]["metrics"][metric]["value"])
    out = {"sets": {}}
    for s, values in sorted(sets.items()):
        out["sets"][s] = {"n": len(values), "median": statistics.median(values),
                          "spread": spread(values) if len(values) > 2 else None,
                          "spread_less_far": (spread(less_far(values)) if len(values) > 3
                                              else None)}
    every = [v for values in sets.values() for v in values]
    out["spread_all"] = spread(every) if len(every) > 2 else None
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workloads", nargs="+", required=True)
    parser.add_argument("--first-seed", type=int, required=True)
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--runs", type=int, default=6)
    parser.add_argument("--sets", type=int, default=2)
    parser.add_argument("--traced", type=int, default=3)
    parser.add_argument("--seconds", type=float)
    args = parser.parse_args()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or spec["run_seconds"]
    args.out.mkdir(parents=True, exist_ok=True)
    seed = args.first_seed
    with open(args.out / "runs.jsonl", "a") as log:
        for workload in args.workloads:
            seeds = [seed + i for i in range(args.runs)]
            runs = [(s, i, 0) for s in range(1, args.sets + 1) for i in seeds]
            runs += [(0, seed + args.runs + i, 1) for i in range(args.traced)]
            seed += args.runs + args.traced
            rows = []
            for set_, run_seed, trace in runs:
                t0 = time.monotonic()
                proc = subprocess.run(
                    [sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
                     str(run_seed), "--seconds", f"{seconds:g}", "--trace", str(trace)],
                    cwd=ROOT, capture_output=True, text=True, timeout=1500)
                lines = proc.stdout.strip().splitlines()
                try:
                    result = json.loads(lines[-1]) if lines else None
                except ValueError:
                    result = None
                row = {"workload": workload, "set": set_, "seed": run_seed, "trace": trace,
                       "rc": proc.returncode, "wall_s": time.monotonic() - t0, "result": result}
                (args.out / f"{workload}.{run_seed}.trace{trace}.err").write_text(proc.stderr)
                log.write(json.dumps(row) + "\n")
                log.flush()
                rows.append(row)
            for m in spec["end_to_end"]:
                print(json.dumps({"workload": workload, "metric": m["name"],
                                  **summary(rows, m["name"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
