#!/usr/bin/env python3
"""Time the D2Q9 K-step kernels B2, B1 and B3 of two copies of the port on one card.

Each copy (a directory that holds a `lbm_tpu_torch/` package, e.g. the
parent commit unpacked by `git archive`) runs in a process of its own, which
imports that copy's package and builds its kernels into that copy's `build/`.
Both copies are built before anything is timed. The processes run in the
order A, B, B, A, so that a drift of the card's clock or temperature falls on
both copies alike. Each times B2 (`d2q9_kstep.run`), B1
(`d2q9_kstep_inplace.run`) and B3 (`d2q9_kstep_manual.run`) at each grid
(float32, tile 16x32, K=4) and mode. The kernels that a change leaves alone
are its control and should not move by more than their spread: B1 and B2
when B3 changes (csrc/d2q9_manual.cu), B3 when B1 and B2 do. Each runs
`repeats` times, the kernels alternating, by CUDA events over `passes`
passes (at 1024^2; scaled by the cells at other grids) after a warm-up run.
Writes one CSV row per timing to results_ab2d.csv beside this file (or
--out), with the path each kernel's launches took, and prints the median of
each (grid, mode, kernel, copy), its least and greatest time, and B's median
against A's.

Run on a machine with the card, from the repository root:

    git archive PARENT lbm_tpu_torch | tar -x -C build/parent
    python3 experiments/cuda-kstep-tiles/ab2d.py --a build/parent --b . \\
        [--grids 1024 4096] [--modes full copy] [--passes 2000] [--repeats 5] \\
        [--out FILE]
"""

from __future__ import annotations

import argparse
import csv
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TILE = (16, 32)
K = 4
KERNELS = ("B2", "B1", "B3")


def kwargs(n: int) -> dict:
    return dict(omega=1.85, accel_w1=0.1 * 0.01 / 9, accel_w2=0.1 * 0.01 / 36, accel_row=n - 2)


def worker(root: str, grids, modes, passes: int, repeats: int, build_only: bool) -> None:
    """Time B2, B1 and B3 of the package under `root`; print one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from lbm_tpu_torch.ops import _build, d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual

    for name in ("d2q9_kstep", "d2q9_manual"):
        _build.load(name)
    if build_only:
        print(json.dumps({}))
        return
    mods = {"B2": d2q9_kstep, "B1": d2q9_kstep_inplace, "B3": d2q9_kstep_manual}
    times, paths = {}, {}
    for n in grids:
        gen = torch.Generator(device="cuda").manual_seed(3)
        w = torch.tensor([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, device="cuda")[:, None, None]
        f = (0.1 * w * (1.0 + 0.2 * (2.0 * torch.rand((9, n, n), generator=gen, device="cuda")
                                     - 1.0))).contiguous()
        mask = torch.rand((n, n), generator=gen, device="cuda") < 0.05
        npass = max(20, passes * 1024 * 1024 // (n * n))
        for mode in modes:
            run_kw = dict(num_steps=K * npass, k_steps=K, tile=TILE, mode=mode, **kwargs(n))
            for rep in range(repeats):
                for name, mod in mods.items():
                    g = f.clone()
                    if rep == 0:
                        mod.run(g, mask, **run_kw)
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    mod.run(g, mask, **run_kw)
                    end.record()
                    end.synchronize()
                    key = f"{n} {mode} {name}"
                    times.setdefault(key, []).append(start.elapsed_time(end) / npass)
                    paths[key] = getattr(mod, "last_path", None) or "thread"
                    del g
        del f, mask
        torch.cuda.empty_cache()
    print(json.dumps({"times": times, "paths": paths}))


def shown(root: str) -> str:
    """root as the CSV names it: relative to the repository where it lies in it."""
    path = Path(root).resolve()
    return str(path.relative_to(REPO)) if path.is_relative_to(REPO) else root


def worker_cmd(args, root: str, build_only: bool = False) -> list:
    cmd = [sys.executable, __file__, "--a", args.a, "--b", args.b, "--worker", root,
           "--passes", str(args.passes), "--repeats", str(args.repeats),
           "--grids", *map(str, args.grids), "--modes", *args.modes]
    return cmd + ["--build-only"] if build_only else cmd


def finish(proc) -> dict:
    out, err = proc.communicate()
    if proc.returncode:
        print(out, err, file=sys.stderr)
        raise SystemExit(1)
    return json.loads(out.strip().splitlines()[-1])


def run_worker(args, root: str) -> dict:
    return finish(subprocess.Popen(worker_cmd(args, root), stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="directory of copy A (the reference)")
    ap.add_argument("--b", required=True, help="directory of copy B (the change)")
    ap.add_argument("--grids", type=int, nargs="+", default=[1024])
    ap.add_argument("--modes", nargs="+", default=["full"], choices=("full", "stream_only", "copy"))
    ap.add_argument("--passes", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_ab2d.csv")))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.grids, args.modes, args.passes, args.repeats, args.build_only)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    builds = [subprocess.Popen(worker_cmd(args, root, build_only=True), stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
              for root in dict.fromkeys((args.a, args.b))]
    for proc in builds:  # both copies' kernels, built side by side before any timing
        finish(proc)
    rows = []
    for order, (label, root) in enumerate((("A", args.a), ("B", args.b), ("B", args.b),
                                           ("A", args.a))):
        res = run_worker(args, root)
        for key, ms_list in res["times"].items():
            n, mode, kernel = key.split()
            for rep, ms in enumerate(ms_list):
                rows.append(dict(copy=label, root=shown(root), process=order, grid=int(n),
                                 mode=mode, kernel=kernel, path=res["paths"][key], repeat=rep,
                                 ms_per_pass=round(ms, 6)))
        print(f"process {order} ({label}, {shown(root)}):",
              {k: [round(v, 5) for v in ms] for k, ms in res["times"].items()}, flush=True)
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; float32, tile 16x32, K=4, {args.passes} passes a timing at 1024^2 "
                 f"(scaled by the cells elsewhere); A = {shown(args.a)}, B = {shown(args.b)}; "
                 "experiments/cuda-kstep-tiles/ab2d.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    for n in args.grids:
        for mode in args.modes:
            for kernel in KERNELS:
                med = {}
                for label in ("A", "B"):
                    sel = [r for r in rows if r["copy"] == label and r["kernel"] == kernel
                           and r["grid"] == n and r["mode"] == mode]
                    ms = [r["ms_per_pass"] for r in sel]
                    med[label] = statistics.median(ms)
                    print(f"{n}^2 {mode} {kernel} {label} ({sel[0]['path']} path): median "
                          f"{med[label]:.5f} ms a pass ({min(ms):.5f}-{max(ms):.5f}, "
                          f"{len(ms)} timings)")
                print(f"{n}^2 {mode} {kernel}: B against A {100 * (med['B'] / med['A'] - 1):+.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
