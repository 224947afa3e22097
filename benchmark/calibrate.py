"""The readings that the limits of `correct` are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds <n> ... \
        [--control-seeds <n> ...] [--store-every <k> ...] [--out FILE]

For each seed, in one process: the cell's inputs from the seed, one job
through the program's entry (the timed path, at the cell's sizes), one
replay by the reference, and the numbers of `reference.compare` (the lower
readings). For each control seed, the control in the program's place: the
reference in the storage type below the cell's (`control` of its traffic
mix) against the same replay (the upper readings). For each `--store-every`
k, the reference that stores its state once every k steps, in place of the
program, against the same replay: what a sound program that stores at
another k reads (it matters where the storage type rounds). Prints one JSON
line a reading; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import harness  # noqa: E402
from benchmark.reference import compare  # noqa: E402


def readings(root: Path, workload: str, seeds, control_seeds, device, emit, store_every=()):
    spec = harness.load_spec(root)
    c = harness.cell(spec, workload, root)
    drv = harness.driver(c.bench, c.config["driver"])
    for i, seed in enumerate(seeds):
        job = drv.Job(c.config, c.config_dir, c.traffic, seed, device)
        if i == 0:
            job.warm_up()
        t0 = time.perf_counter()
        out = job.run()
        t1 = time.perf_counter()
        job.release()
        ref_f, ref_av = job.reference(job.dtype)
        harness._sync(device)
        t2 = time.perf_counter()
        obstacle = job.obstacle()
        row = compare.gaps(*out, ref_f, ref_av, job.speed, obstacle)
        emit({"workload": workload, "seed": seed, "side": "program", **row,
              "job_s": t1 - t0, "reference_s": t2 - t1})
        del out
        if seed in control_seeds:
            t3 = time.perf_counter()
            ctrl_f, ctrl_av = job.reference(job.control)
            harness._sync(device)
            row = compare.gaps(ctrl_f, ctrl_av, ref_f, ref_av, job.speed, obstacle)
            emit({"workload": workload, "seed": seed, "side": "control",
                  "storage": str(job.control), **row, "control_s": time.perf_counter() - t3})
        for k in store_every:
            t3 = time.perf_counter()
            alt_f, alt_av = job.reference(job.dtype, k)
            harness._sync(device)
            row = compare.gaps(alt_f, alt_av, ref_f, ref_av, job.speed, obstacle)
            emit({"workload": workload, "seed": seed, "side": f"store_every_{k}",
                  "storage": str(job.dtype), **row, "reference_s": time.perf_counter() - t3})
            del alt_f, alt_av
        del job, ref_f, ref_av


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--store-every", type=int, nargs="*", default=[])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    spec = harness.load_spec()
    chips = harness._named(spec["workloads"], args.workload, "workload")["chips"]
    try:
        device = harness.require_devices(chips)
    except harness.NoDevice as exc:
        print(f"calibrate: {exc}", file=sys.stderr)
        return 2
    print(f"calibrate: card {harness.card_line()}", file=sys.stderr)
    sink = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    try:
        readings(harness.ROOT, args.workload, args.seeds, set(args.control_seeds), device, emit,
                 args.store_every)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
