#!/usr/bin/env python3
"""Block-shape and K sweep of the port's CUDA D3Q19 kernels (B6 d3q19_kstep,
B4 d3q19_kstep_inplace) at the 3-D bench shape, 64x128x256 float32.

For every (bx, by, bz) block of BLOCKS and every K of KS: records whether B6
is within 1e-5 of `stepk_plain` on the card (b6_rel_err), whether B4 equals
B6 bit for bit in one `stepk` and over three passes of `run` (b4_equals_b6),
then times each kernel inside `run` (CUDA events over `passes` passes, after
warm-up) and the host's enqueue time of the same loop. A pass of K steps is
K launches of the one-step kernel (plus B4's swap after an odd K), so the
sweep shows what a step costs per block shape and what the swap costs. One
CSV row per configuration goes to results3d.csv beside this file (or --out).

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/sweep3d.py [--passes 200] [--out FILE]
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
from lbm_tpu_torch.ops import d3q19_kstep, d3q19_kstep_inplace, d3q19_lattice  # noqa: E402

NZ, NY, NX = 64, 128, 256
BLOCKS = ((256, 1, 1), (128, 2, 1), (128, 1, 2), (64, 4, 1), (64, 2, 2), (32, 8, 1),
          (32, 4, 2), (128, 1, 1), (64, 2, 1))
KS = (1, 2, 3, 4)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=200)
    ap.add_argument("--out", default=str(Path(__file__).with_name("results3d.csv")))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep3d: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    rng = np.random.default_rng(3)
    f_np = d3q19_lattice.initial_distributions(NZ, NY, NX, 0.1, np.float64)
    f_np = f_np * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, f_np.shape))
    mask_np = rng.uniform(size=(NZ, NY, NX)) < 0.05
    mask_np[0] = mask_np[-1] = True
    f, mask = state.to_torch3d(f_np, mask_np, device="cuda", dtype=torch.float32)
    kw = dict(omega=1.85, density=0.1, accel=0.005, accel_plane=NZ - 2)
    cells = NZ * NY * NX
    rows = []
    for k in KS:
        ref_f, _ = d3q19_kstep.stepk_plain(f, mask, k_steps=k, **kw)
        for block in BLOCKS:
            b6_f, b6_t = d3q19_kstep.stepk(f, mask, k_steps=k, block=block, **kw)
            b4_f, b4_t = d3q19_kstep_inplace.stepk(f.clone(), mask, k_steps=k, block=block, **kw)
            err = float((b6_f - ref_f).abs().max() / ref_f.abs().max())
            b4_eq = bool(torch.equal(b4_f, b6_f) and torch.equal(b4_t, b6_t))
            r6 = d3q19_kstep.run(f, mask, num_steps=3 * k, k_steps=k, block=block, **kw)
            r4 = d3q19_kstep_inplace.run(f.clone(), mask, num_steps=3 * k, k_steps=k,
                                         block=block, **kw)
            b4_eq = b4_eq and bool(torch.equal(r4[0], r6[0]) and torch.equal(r4[1], r6[1]))
            row = dict(bx=block[0], by=block[1], bz=block[2], k=k, b6_rel_err=f"{err:.3e}",
                       b4_equals_b6=b4_eq)
            for name, mod in (("b6", d3q19_kstep), ("b4", d3q19_kstep_inplace)):
                g = f.clone()
                steps = k * args.passes
                mod.run(g, mask, num_steps=2 * k, k_steps=k, block=block, **kw)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                mod.run(g, mask, num_steps=steps, k_steps=k, block=block, **kw)
                end.record()
                host_ms = (time.perf_counter() - t0) * 1e3 / args.passes
                end.synchronize()
                ms = start.elapsed_time(end) / args.passes
                row[f"{name}_ms_per_pass"] = f"{ms:.4f}"
                row[f"{name}_host_ms_per_pass"] = f"{host_ms:.4f}"
                row[f"{name}_mlups"] = f"{cells * k / ms / 1e3:.0f}"
            row["card"] = card.replace(",", "")
            rows.append(row)
            print(row, flush=True)
    with open(args.out, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
