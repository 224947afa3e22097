#!/usr/bin/env python3
"""Time the D2Q9 K-step kernels B2 and B1 of two copies of the port on one card.

Each copy (a directory that holds a `lbm_tpu_torch/` package, e.g. the
parent commit unpacked by `git archive`) runs in a process of its own, which
imports that copy's package and builds its kernels into that copy's `build/`.
The processes run in the order A, B, B, A, so that a drift of the card's
clock or temperature falls on both copies alike. Each times B2
(`d2q9_kstep.run`) and B1 (`d2q9_kstep_inplace.run`) at 1024^2 float32, tile
16x32, K=4, `repeats` times each, the two kernels alternating, by CUDA
events over `passes` passes after a warm-up run. Writes one CSV row per
timing to results_ab2d.csv beside this file (or --out) and prints the median
of each (copy, kernel), its least and greatest time, and B's median against
A's.

Run on a machine with the card, from the repository root:

    git archive PARENT lbm_tpu_torch | tar -x -C build/parent
    python3 experiments/cuda-kstep-tiles/ab2d.py --a build/parent --b . \\
        [--passes 2000] [--repeats 5] [--out FILE]
"""

from __future__ import annotations

import argparse
import csv
import json
import statistics
import subprocess
import sys
from pathlib import Path

N = 1024
TILE = (16, 32)
K = 4
KW = dict(omega=1.85, accel_w1=0.1 * 0.01 / 9, accel_w2=0.1 * 0.01 / 36, accel_row=N - 2)


def worker(root: str, passes: int, repeats: int) -> None:
    """Time B2 and B1 of the package under `root`; print one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from lbm_tpu_torch.ops import d2q9_kstep, d2q9_kstep_inplace

    gen = torch.Generator(device="cuda").manual_seed(3)
    w = torch.tensor([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, device="cuda")[:, None, None]
    f = (0.1 * w * (1.0 + 0.2 * (2.0 * torch.rand((9, N, N), generator=gen, device="cuda")
                                 - 1.0))).contiguous()
    mask = torch.rand((N, N), generator=gen, device="cuda") < 0.05
    kernels = {"B2": d2q9_kstep, "B1": d2q9_kstep_inplace}
    times = {name: [] for name in kernels}
    run_kw = dict(num_steps=K * passes, k_steps=K, tile=TILE, **KW)
    for rep in range(repeats):
        for name, mod in kernels.items():
            g = f.clone()
            if rep == 0:
                mod.run(g, mask, **run_kw)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            mod.run(g, mask, **run_kw)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / passes)
    print(json.dumps(times))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="directory of copy A (the reference)")
    ap.add_argument("--b", required=True, help="directory of copy B (the change)")
    ap.add_argument("--passes", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_ab2d.csv")))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.passes, args.repeats)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    rows = []
    for order, (label, root) in enumerate((("A", args.a), ("B", args.b), ("B", args.b),
                                           ("A", args.a))):
        out = subprocess.run([sys.executable, __file__, "--a", args.a, "--b", args.b,
                              "--worker", root, "--passes", str(args.passes),
                              "--repeats", str(args.repeats)],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return 1
        times = json.loads(out.stdout.strip().splitlines()[-1])
        for kernel, ms_list in times.items():
            for rep, ms in enumerate(ms_list):
                rows.append(dict(copy=label, root=root, process=order, kernel=kernel, repeat=rep,
                                 ms_per_pass=round(ms, 6)))
        print(f"process {order} ({label}, {root}):",
              {k: [round(v, 5) for v in ms] for k, ms in times.items()}, flush=True)
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; 1024x1024 float32, tile 16x32, K=4, {args.passes} passes a "
                 f"timing; A = {args.a}, B = {args.b}; experiments/cuda-kstep-tiles/ab2d.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    for kernel in ("B2", "B1"):
        med = {}
        for label in ("A", "B"):
            ms = [r["ms_per_pass"] for r in rows if r["copy"] == label and r["kernel"] == kernel]
            med[label] = statistics.median(ms)
            print(f"{kernel} {label}: median {med[label]:.5f} ms a pass "
                  f"({min(ms):.5f}-{max(ms):.5f}, {len(ms)} timings)")
        print(f"{kernel}: B against A {100 * (med['B'] / med['A'] - 1):+.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
