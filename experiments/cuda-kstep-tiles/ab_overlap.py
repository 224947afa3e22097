#!/usr/bin/env python3
"""Time kernel B11's manual engines of two copies of the port on one card.

Each copy (a directory that holds a `lbm_tpu_torch/` package, e.g. the parent
commit unpacked by `git archive`) runs in a process of its own, which imports
that copy's package and builds its kernels into that copy's `build/`. Both
copies are built before anything is timed, and the processes run in the
order A, B, B, A, so that a drift of the card's clock or temperature falls on
both copies alike. Each process times every engine of ENGINES at 4096^2,
band 64, R = 0, 16 and 64 with this checkout's harness (overlap_probe.py
`time_engine`: the best of 3 x 200 chained calls), the engines in turn, and
`Tensor.copy_` at R = 0. The strided manual engines in (9, 16, 32) tiles
are what a change to their stage moves; `auto`, `manual_flat` and the
engines in (9, 1, 512) tiles are its control and should not move by more
than their spread.

Writes one CSV row a timing to results_ab_overlap.csv beside this file (or
--out), headed by the card's name and power limit, with the path each
engine's launches took in that copy (unknown to a copy without
`choose_path`: "-"), and prints each case's two timings for A and B and B's
mean against A's.

Run on a machine with the card, from the repository root:

    git archive PARENT lbm_tpu_torch | tar -x -C build/parent
    python3 experiments/cuda-kstep-tiles/ab_overlap.py --a build/parent --b . \\
        [--rounds 0 16 64] [--engines manual ...] [--out FILE]
"""

from __future__ import annotations

import argparse
import csv
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
SIZE, BAND, ITERS = 4096, 64, 200
ENGINES = ("manual", "manual3", "manual4", "manual6", "manual_alias", "manual_alias_safe",
           "auto", "manual_flat", "manual@1x512", "manual3@1x512", "manual4@1x512",
           "manual6@1x512")


def worker(root: str, engines, rounds_list, build_only: bool) -> None:
    """Time the engines of the package under `root`; print one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from lbm_tpu_torch.ops import _build
    from lbm_tpu_torch.ops import overlap_probe as op

    _build.load("overlap_probe")
    if build_only:
        print(json.dumps({}))
        return
    # this checkout's harness, on the package imported above
    spec = importlib.util.spec_from_file_location("overlap_harness", HERE / "overlap_probe.py")
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    times, paths = {}, {}
    for rounds in rounds_list:
        for name in (*engines, *(("copy_",) if rounds == 0 else ())):
            best, _, _ = harness.time_engine(name, SIZE, SIZE, BAND, rounds, ITERS)
            times[f"{name} {rounds}"] = best
            probe = None if name == "copy_" else harness.build(name, SIZE, SIZE, BAND, rounds)
            paths[name] = (op.choose_path(SIZE, SIZE, probe.tile, probe.flat, aligned=True)
                           if hasattr(op, "choose_path") and isinstance(probe, op.Probe)
                           and probe.kind == "manual" else "-")
            torch.cuda.empty_cache()
    print(json.dumps({"times": times, "paths": paths}))


def shown(root: str) -> str:
    path = Path(root).resolve()
    return str(path.relative_to(REPO)) if path.is_relative_to(REPO) else root


def worker_cmd(args, root: str, build_only: bool = False) -> list:
    cmd = [sys.executable, __file__, "--a", args.a, "--b", args.b, "--worker", root,
           "--rounds", *map(str, args.rounds), "--engines", *args.engines]
    return cmd + ["--build-only"] if build_only else cmd


def finish(proc) -> dict:
    out, err = proc.communicate()
    if proc.returncode:
        print(out, err, file=sys.stderr)
        raise SystemExit(1)
    return json.loads(out.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="directory of copy A (the reference)")
    ap.add_argument("--b", required=True, help="directory of copy B (the change)")
    ap.add_argument("--rounds", type=int, nargs="+", default=[0, 16, 64])
    ap.add_argument("--engines", nargs="+", default=list(ENGINES))
    ap.add_argument("--out", default=str(HERE / "results_ab_overlap.csv"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.engines, args.rounds, args.build_only)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    builds = [subprocess.Popen(worker_cmd(args, root, build_only=True), stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
              for root in dict.fromkeys((args.a, args.b))]
    for proc in builds:
        finish(proc)
    rows = []
    for order, (label, root) in enumerate((("A", args.a), ("B", args.b), ("B", args.b),
                                           ("A", args.a))):
        res = finish(subprocess.Popen(worker_cmd(args, root), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
        for key, ms in res["times"].items():
            name, rounds = key.split()
            rows.append(dict(copy=label, root=shown(root), process=order, engine=name,
                             rounds=int(rounds), path=res["paths"].get(name, "-"),
                             us_per_call=round(ms * 1e3, 2)))
        print(f"process {order} ({label}, {shown(root)}) done", flush=True)
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; (9, {SIZE}, {SIZE}) float32, band {BAND}, best of 3 x {ITERS} "
                 f"calls a timing; A = {shown(args.a)}, B = {shown(args.b)}; "
                 "experiments/cuda-kstep-tiles/ab_overlap.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    for rounds in args.rounds:
        for name in (*args.engines, *(("copy_",) if rounds == 0 else ())):
            sel = {label: [r for r in rows if r["copy"] == label and r["engine"] == name
                           and r["rounds"] == rounds] for label in ("A", "B")}
            mean = {label: statistics.mean(r["us_per_call"] for r in rs)
                    for label, rs in sel.items()}
            print(f"R={rounds:<3d} {name:20s} A {[r['us_per_call'] for r in sel['A']]} "
                  f"({sel['A'][0]['path']}) B {[r['us_per_call'] for r in sel['B']]} "
                  f"({sel['B'][0]['path']}): B against A {100 * (mean['B'] / mean['A'] - 1):+.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
