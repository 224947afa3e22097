#!/usr/bin/env python3
"""Tile and K sweep of the port's CUDA K-step kernels (B2 d2q9_kstep, B1
d2q9_kstep_inplace) at the flagship shape, 1024x1024 float32.

For every (tile_h, tile_w, K) that fits a block's shared memory: records
whether B2 reproduces `stepk_plain` on the card bit for bit (b2_equals_plain;
it does not, by ~1e-6 relative, see ROADMAP.md) and whether B1 equals B2
bit for bit in one `stepk` and over three passes of `run`
(b1_equals_b2), then times each kernel inside `run` (CUDA events over `passes`
launches, after warm-up) and the host's enqueue time of the same loop, which
shows whether the host or the card sets the pace. Writes one CSV row per
configuration to results.csv beside this file (or --out) and prints it.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/sweep.py [--passes 400] [--out FILE]
"""

from __future__ import annotations

import argparse
import csv
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from lbm_tpu_torch.core import state  # noqa: E402
from lbm_tpu_torch.ops import d2q9_kstep, d2q9_kstep_inplace  # noqa: E402

N = 1024
TILES = ((8, 32), (8, 64), (8, 128), (16, 32), (16, 64), (16, 128), (32, 32), (32, 64),
         (64, 64))
KS = (1, 2, 4, 8)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=400)
    ap.add_argument("--out", default=str(Path(__file__).with_name("results.csv")))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    rng = np.random.default_rng(3)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None]
    f_np = 0.1 * w * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (9, N, N)))
    mask_np = rng.uniform(size=(N, N)) < 0.05
    f, mask = state.to_torch(f_np, mask_np, device="cuda", dtype=torch.float32)
    kw = dict(omega=1.85, accel_w1=0.1 * 0.01 / 9, accel_w2=0.1 * 0.01 / 36, accel_row=N - 2)
    rows = []
    for k in KS:
        ref_f, _ = d2q9_kstep.stepk_plain(f, mask, k_steps=k, **kw)
        for tile in TILES:
            if d2q9_kstep.smem_bytes(*tile, k, 4) > d2q9_kstep.SMEM_PER_BLOCK:
                continue
            b2_f, b2_t = d2q9_kstep.stepk(f, mask, k_steps=k, tile=tile, **kw)
            b1_f, b1_t = d2q9_kstep_inplace.stepk(f.clone(), mask, k_steps=k, tile=tile, **kw)
            exact = bool(torch.equal(b2_f, ref_f))
            b1_eq = bool(torch.equal(b1_f, b2_f) and torch.equal(b1_t, b2_t))
            r2 = d2q9_kstep.run(f, mask, num_steps=3 * k, k_steps=k, tile=tile, **kw)
            r1 = d2q9_kstep_inplace.run(f.clone(), mask, num_steps=3 * k, k_steps=k, tile=tile, **kw)
            b1_eq = b1_eq and bool(torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1]))
            row = dict(tile_h=tile[0], tile_w=tile[1], k=k, b2_equals_plain=exact,
                       b1_equals_b2=b1_eq,
                       smem_bytes=d2q9_kstep.smem_bytes(*tile, k, 4))
            for name, mod in (("b2", d2q9_kstep), ("b1", d2q9_kstep_inplace)):
                g = f.clone()
                steps = k * args.passes
                mod.run(g, mask, num_steps=steps, k_steps=k, tile=tile, **kw)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                mod.run(g, mask, num_steps=steps, k_steps=k, tile=tile, **kw)
                host_ms = (time.perf_counter() - t0) * 1e3 / args.passes
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / args.passes
                row[f"{name}_ms_per_launch"] = round(ms, 5)
                row[f"{name}_host_enqueue_ms"] = round(host_ms, 5)
                row[f"{name}_mlups"] = round(N * N * k / ms / 1e3, 1)
                # the bytes one pass must move at f32: 9 values in and out and
                # the mask byte per cell
                row[f"{name}_eff_gbps"] = round((73 * N * N) / ms / 1e6, 1)
            rows.append(row)
            print(row, flush=True)
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; 1024x1024 float32; experiments/cuda-kstep-tiles/sweep.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    best = max(rows, key=lambda r: r["b1_mlups"])
    print("best B1:", best)
    return 0


if __name__ == "__main__":
    sys.exit(main())
