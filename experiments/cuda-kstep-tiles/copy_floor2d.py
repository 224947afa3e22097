#!/usr/bin/env python3
"""The copy floor of a 2-D pass on the card: kernel B12 (copy_floor) and the
library's `Tensor.copy_`.

The card's counterpart of experiments/d2q9-blocked-floor/run.py. A pass of
out = in over the (9, n, n) float32 state moves 72 bytes a cell and computes
nothing, so no K-step pass that reads and writes the lattice once can be
faster. Two sweeps:

1. shape (default): B12 over the K-step kernels' tiles and over full-width
   bands of 16-64 rows, and `copy_`, at 1024^2-8192^2 (the lattices do not
   fit the 50 MB L2 at any of these);
2. L2 (`--residency` adds it), the counterpart of the TPU study's VMEM
   residency: B12 at the 16x32 tile and `copy_` at grids whose two lattices
   span ~10-150 MB, across the card's 50 MB L2.

Each time is CUDA events around `passes` passes after a warm-up, ping-ponging
two buffers as `run_copy` does. Writes results_copy_floor2d.csv beside this
file (or --out) with the effective rate, 72 bytes a cell over the time.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/copy_floor2d.py [--grids 1024 2048 4096 8192]
        [--residency] [--passes 400] [--out FILE]
"""

from __future__ import annotations

import argparse
import csv
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from lbm_tpu_torch.ops import copy_floor  # noqa: E402

TILES = ((16, 32), (8, 32), (16, 64), (32, 32), (32, 128))
BANDS = (16, 32, 64)
RESIDENCY_GRIDS = (384, 512, 640, 768, 896, 1024, 1152, 1280, 1440)
BYTES_PER_CELL = 72  # 9 float32 values read and written


def ms_per_pass(fn, passes: int) -> float:
    """Device time of one call of fn(), by CUDA events over `passes` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(passes):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / passes


def copy_ms(f, by, bx, passes):
    """B12: `passes` passes in one `run_copy`, per pass."""
    copy_floor.run_copy(f, 2, by, bx)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    copy_floor.run_copy(f, passes, by, bx)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / passes


def library_ms(f, passes):
    """`copy_` ping-ponging two buffers, per pass."""
    bufs = [torch.empty_like(f), torch.empty_like(f)]
    state = {"i": 0}

    def one():
        i = state["i"]
        bufs[(i + 1) % 2].copy_(bufs[i % 2] if i else f)
        state["i"] = i + 1

    return ms_per_pass(one, passes)


def row(pattern, n, by, bx, passes, ms):
    return dict(pattern=pattern, grid=f"{n}x{n}", by=by, bx=bx,
                lattices_mb=round(2 * 9 * n * n * 4 / 1e6, 1), passes=passes,
                us_per_pass=round(ms * 1e3, 3),
                gbps_effective=round(BYTES_PER_CELL * n * n / ms / 1e6, 1))


def shape_sweep(grids, passes):
    rows = []
    for n in grids:
        f = torch.rand((9, n, n), device="cuda", generator=torch.Generator("cuda").manual_seed(n))
        n_passes = max(20, passes * 1024 * 1024 // (n * n))
        for by, bx in TILES:
            rows.append(row("tile", n, by, bx, n_passes, copy_ms(f, by, bx, n_passes)))
            print(rows[-1], flush=True)
        for by in BANDS:
            rows.append(row("band", n, by, n, n_passes, copy_ms(f, by, n, n_passes)))
            print(rows[-1], flush=True)
        rows.append(row("copy_", n, "", "", n_passes, library_ms(f, n_passes)))
        print(rows[-1], flush=True)
        del f
    return rows


def residency_sweep(passes):
    rows = []
    for n in RESIDENCY_GRIDS:
        f = torch.rand((9, n, n), device="cuda", generator=torch.Generator("cuda").manual_seed(n))
        n_passes = max(200, passes * 1024 * 1024 // (n * n))
        rows.append(row("l2-tile", n, 16, 32, n_passes, copy_ms(f, 16, 32, n_passes)))
        print(rows[-1], flush=True)
        rows.append(row("l2-copy_", n, "", "", n_passes, library_ms(f, n_passes)))
        print(rows[-1], flush=True)
        del f
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grids", type=int, nargs="*", default=[1024, 2048, 4096, 8192])
    ap.add_argument("--residency", action="store_true")
    ap.add_argument("--passes", type=int, default=400, help="passes at 1024^2")
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_copy_floor2d.csv")))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("copy_floor2d: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    rows = shape_sweep(args.grids, args.passes)
    if args.residency:
        rows += residency_sweep(args.passes)
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; float32; experiments/cuda-kstep-tiles/copy_floor2d.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
