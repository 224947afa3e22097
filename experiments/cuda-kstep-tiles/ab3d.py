#!/usr/bin/env python3
"""Time the blocked D3Q19 kernels B5 and B7 of two copies of the port on one card.

The 3-D counterpart of ab2d.py. Each copy (a directory that holds a
`lbm_tpu_torch/` package, e.g. the parent commit unpacked by `git archive`)
runs in a process of its own, which imports that copy's package and builds
its kernels into that copy's `build/`. Both copies are built before anything
is timed. The processes run in the order A, B, B, A, so that a drift of the
card's clock or temperature falls on both copies alike. Each times, float32,
K steps a pass, at each grid: B5 (`d3q19_kstep_inplace_blocked.run`) and B7
(`d3q19_kstep_blocked.run`) at the copy's own tile (`choose_config`), and the
one-step kernels B4 (`d3q19_kstep_inplace.run`) and B6 (`d3q19_kstep.run`),
the control of a change to csrc/d3q19_blocked.cu, which should not move by
more than their spread. Each runs `repeats` times, the kernels alternating,
by CUDA events over `passes` passes (at 32x256x256; scaled by the cells at
other grids) after a warm-up run. Writes one CSV row per timing to
results_ab3d.csv beside this file (or --out), with each kernel's tile and
the path its launches took ("-" where the copy has no `last_path`), and
prints the median of each (grid, kernel, copy), its least and greatest
time, and B's median against A's.

Run on a machine with the card, from the repository root:

    git archive PARENT lbm_tpu_torch | tar -x -C build/parent
    python3 experiments/cuda-kstep-tiles/ab3d.py --a build/parent --b . \\
        [--grids 32x256x256] [--k 2] [--passes 100] [--repeats 5] [--out FILE]
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
KERNELS = ("B5", "B7", "B4", "B6")
KW = dict(omega=1.85, density=0.1, accel=0.005)


def worker(root: str, grids, k: int, passes: int, repeats: int, build_only: bool) -> None:
    """Time B5, B7, B4 and B6 of the package under `root`; print one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from lbm_tpu_torch.ops import (_build, d3q19_kstep, d3q19_kstep_blocked,
                                   d3q19_kstep_inplace, d3q19_kstep_inplace_blocked, d3q19_lattice)

    for name in ("d3q19_kstep", "d3q19_blocked"):
        _build.load(name)
    if build_only:
        print(json.dumps({}))
        return
    mods = {"B5": d3q19_kstep_inplace_blocked, "B7": d3q19_kstep_blocked,
            "B4": d3q19_kstep_inplace, "B6": d3q19_kstep}
    times, paths, tiles = {}, {}, {}
    for shape in grids:
        gen = torch.Generator(device="cuda").manual_seed(3)
        w = torch.tensor(d3q19_lattice.W, dtype=torch.float32, device="cuda")[:, None, None, None]
        f = (0.1 * w * (1.0 + 0.2 * (2.0 * torch.rand((19, *shape), generator=gen, device="cuda")
                                     - 1.0))).contiguous()
        mask = torch.rand(shape, generator=gen, device="cuda") < 0.05
        npass = max(20, passes * 32 * 256 * 256 // (shape[0] * shape[1] * shape[2]))
        run_kw = dict(num_steps=k * npass, k_steps=k, accel_plane=shape[0] - 2, **KW)
        grid = "x".join(map(str, shape))
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
                key = f"{grid} {name}"
                times.setdefault(key, []).append(start.elapsed_time(end) / npass)
                paths[key] = getattr(mod, "last_path", None) or "-"
                tiles[key] = ("x".join(map(str, mod.choose_config(*shape, k)))
                              if name in ("B5", "B7") else "")
                del g
        del f, mask
        torch.cuda.empty_cache()
    print(json.dumps({"times": times, "paths": paths, "tiles": tiles}))


def shown(root: str) -> str:
    path = Path(root).resolve()
    return str(path.relative_to(REPO)) if path.is_relative_to(REPO) else root


def worker_cmd(args, root: str, build_only: bool = False) -> list:
    cmd = [sys.executable, __file__, "--a", args.a, "--b", args.b, "--worker", root,
           "--k", str(args.k), "--passes", str(args.passes), "--repeats", str(args.repeats),
           "--grids", *args.grids]
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
    ap.add_argument("--grids", nargs="+", default=["32x256x256"])
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--passes", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_ab3d.csv")))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    grids = [tuple(int(v) for v in g.split("x")) for g in args.grids]
    if args.worker:
        worker(args.worker, grids, args.k, args.passes, args.repeats, args.build_only)
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
        res = finish(subprocess.Popen(worker_cmd(args, root), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
        for key, ms_list in res["times"].items():
            grid, kernel = key.split()
            for rep, ms in enumerate(ms_list):
                rows.append(dict(copy=label, root=shown(root), process=order, grid=grid,
                                 kernel=kernel, tile=res["tiles"][key], path=res["paths"][key],
                                 repeat=rep, ms_per_pass=round(ms, 6)))
        print(f"process {order} ({label}, {shown(root)}):",
              {k: [round(v, 5) for v in ms] for k, ms in res["times"].items()}, flush=True)
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; float32, K={args.k}, {args.passes} passes a timing at 32x256x256 "
                 f"(scaled by the cells elsewhere); A = {shown(args.a)}, B = {shown(args.b)}; "
                 "experiments/cuda-kstep-tiles/ab3d.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    for grid in args.grids:
        for kernel in KERNELS:
            med = {}
            for label in ("A", "B"):
                sel = [r for r in rows if r["copy"] == label and r["kernel"] == kernel
                       and r["grid"] == grid]
                ms = [r["ms_per_pass"] for r in sel]
                med[label] = statistics.median(ms)
                print(f"{grid} {kernel} {label} (tile {sel[0]['tile'] or '-'}, {sel[0]['path']} "
                      f"path): median {med[label]:.5f} ms a pass ({min(ms):.5f}-{max(ms):.5f}, "
                      f"{len(ms)} timings)")
            print(f"{grid} {kernel}: B against A {100 * (med['B'] / med['A'] - 1):+.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
