#!/usr/bin/env python3
"""Device time by CUDA kernel of the port's D3Q19 K-step engines, from
torch.profiler, at the 3-D bench shape (64x128x256 float32) or, with
`--blocked`, at 32x256x256 for the blocked pair as well.

For each engine (B6 d3q19_kstep, B4 d3q19_kstep_inplace; with `--blocked`
also B7 d3q19_kstep_blocked and B5 d3q19_kstep_inplace_blocked, whose pass is
a snapshot, one launch and one flush per z-row of tiles) and each requested
K, runs `passes` launches inside `run` under the profiler and prints each
kernel's device time per pass, the device's busy share of the window and the
wall time per pass. Last, it times a plain copy of the lattice
(`Tensor.copy_`, CUDA events), which moves the bytes of one step (19 values
read and 19 written per cell): the rate the card reaches on that traffic.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/profile3d.py [--k 1 2 3] [--passes 200]
        [--blocked] [--shape NZ NY NX]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from lbm_tpu_torch.core import state  # noqa: E402
from lbm_tpu_torch.ops import (d3q19_kstep, d3q19_kstep_blocked, d3q19_kstep_inplace,  # noqa: E402
                               d3q19_kstep_inplace_blocked, d3q19_lattice)

ENGINES = (("B6 d3q19_kstep", d3q19_kstep), ("B4 d3q19_kstep_inplace", d3q19_kstep_inplace))
BLOCKED_ENGINES = (("B7 d3q19_kstep_blocked", d3q19_kstep_blocked),
                   ("B5 d3q19_kstep_inplace_blocked", d3q19_kstep_inplace_blocked))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--passes", type=int, default=200)
    ap.add_argument("--blocked", action="store_true")
    ap.add_argument("--shape", type=int, nargs=3, metavar=("NZ", "NY", "NX"),
                    help="another grid, e.g. 16 64 128, whose lattices stay in the 50 MB L2: "
                         "what a step costs when device memory is out of the way")
    args = ap.parse_args()
    NZ, NY, NX = args.shape or ((32, 256, 256) if args.blocked else (64, 128, 256))
    engines = ENGINES + BLOCKED_ENGINES if args.blocked else ENGINES
    if not torch.cuda.is_available():
        print("profile3d: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    rng = np.random.default_rng(3)
    f_np = d3q19_lattice.initial_distributions(NZ, NY, NX, 0.1, np.float64)
    f_np = f_np * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, f_np.shape))
    mask_np = rng.uniform(size=(NZ, NY, NX)) < 0.05
    mask_np[0] = mask_np[-1] = True
    f, mask = state.to_torch3d(f_np, mask_np, device="cuda", dtype=torch.float32)
    kw = dict(omega=1.85, density=0.1, accel=0.005, accel_plane=NZ - 2)
    for k in args.k:
        for name, mod in engines:
            g = f.clone()
            run = lambda: mod.run(g, mask, num_steps=k * args.passes, k_steps=k, **kw)  # noqa: E731
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            per_kernel = {}
            for evt in prof.key_averages():
                dev_us = getattr(evt, "device_time_total", None)
                if dev_us is None:
                    dev_us = evt.cuda_time_total
                if dev_us and evt.count and "kernel" in evt.key:
                    per_kernel[evt.key] = (dev_us, evt.count)
            busy_us = sum(v[0] for v in per_kernel.values())
            print(f"{name} K={k}: wall {wall * 1e3 / args.passes:.4f} ms/pass, "
                  f"device busy {busy_us / 1e3 / args.passes:.4f} ms/pass "
                  f"({100 * busy_us / 1e6 / wall:.1f}% of the window)")
            for key, (us, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0]):
                print(f"    {us / args.passes / 1e3:.4f} ms/pass  x{count / args.passes:g}  "
                      f"{key[:110]}")

    g = torch.empty_like(f)
    for _ in range(3):
        g.copy_(f)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.passes):
        g.copy_(f)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / args.passes
    nbytes = 2 * f.numel() * f.element_size()
    print(f"lattice copy: {ms:.4f} ms for {nbytes} B read + written, "
          f"{nbytes / ms / 1e6:.0f} GB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
