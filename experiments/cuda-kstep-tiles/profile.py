#!/usr/bin/env python3
"""Device time by CUDA kernel of the port's K-step engines, from
torch.profiler, at the flagship shape (1024x1024 float32).

For each engine (B2 d2q9_kstep, B1 d2q9_kstep_inplace) and each requested
(tile_h, tile_w, K), runs `passes` launches inside `run` under the profiler
and prints each kernel's device time per pass, the device's busy share of the
window and the wall time per pass.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/profile.py [--config 16,32,4 ...]
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
from lbm_tpu_torch.ops import d2q9_kstep, d2q9_kstep_inplace  # noqa: E402

N = 1024


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", action="append", default=None,
                    help="tile_h,tile_w,K (repeatable; default: choose_config's)")
    ap.add_argument("--passes", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    configs = ([tuple(int(v) for v in c.split(",")) for c in args.config] if args.config
               else [d2q9_kstep.choose_config(N, N, torch.float32)])
    rng = np.random.default_rng(3)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None]
    f_np = 0.1 * w * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (9, N, N)))
    f, mask = state.to_torch(f_np, rng.uniform(size=(N, N)) < 0.05, device="cuda",
                             dtype=torch.float32)
    kw = dict(omega=1.85, accel_w1=0.1 * 0.01 / 9, accel_w2=0.1 * 0.01 / 36, accel_row=N - 2)
    for th, tw, k in configs:
        for name, mod in (("B2 d2q9_kstep", d2q9_kstep), ("B1 d2q9_kstep_inplace", d2q9_kstep_inplace)):
            g = f.clone()
            run = lambda: mod.run(g, mask, num_steps=k * args.passes, k_steps=k, tile=(th, tw), **kw)  # noqa: E731
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
            print(f"{name} tile {th}x{tw} K={k}: wall {wall * 1e3 / args.passes:.4f} ms/pass, "
                  f"device busy {busy_us / 1e3 / args.passes:.4f} ms/pass "
                  f"({100 * busy_us / 1e6 / wall:.1f}% of the window)")
            for key, (us, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0]):
                print(f"    {us / args.passes / 1e3:.4f} ms/pass  x{count // args.passes}  {key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
