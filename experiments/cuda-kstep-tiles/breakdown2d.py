#!/usr/bin/env python3
"""Attribute the port's 2-D K-step time: memory movement against arithmetic.

The card's counterpart of experiments/d2q9-breakdown/run.py (which asked it
of the TPU kernels B2 and B3). Each of the D2Q9 kernels B2 (d2q9_kstep), B3
(d2q9_kstep_manual, the explicit copy pipeline) and B1 (d2q9_kstep_inplace)
runs in its three modes, at K = 1 and at choose_config's K:

  full        - the production pass;
  stream_only - the same load and store, K pull-streams in shared memory, no
                bounce-back and no collision;
  copy        - the same load and store, no step at all.

So copy is what the kernel's memory movement costs, stream_only - copy what
its K steps cost without the collision, and full - stream_only the
collisions. B3 against B2 at the same tile and K says whether hiding the
next tile's load behind the steps buys anything on this card.

The time of a pass is CUDA events around `passes` passes of the wrapper's
`run` (after a warm-up run), on a state seeded on the card with 5% obstacles,
float32. Each (engine, K) times its three modes `repeats` times, in rounds
that take the modes in a rotating order, so that a drift of the card's clock
or temperature falls on every mode alike. Writes results_breakdown2d.csv
beside this file (or --out): per (grid, engine, K, mode) the path of the
kernel's launches (box or thread), the median, least and
greatest µs per pass over the repeats, µs per step and MLUPS of the median,
and the bytes of a pass (73 per cell) over its median time.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/breakdown2d.py [--grids 1024 4096 8192]
        [--passes 2000] [--repeats 5] [--engines B2 B3 B1] [--ks 1 4]
        [--tile TH TW] [--out FILE]

(--ks and --tile replace K = 1 and choose_config's K, and choose_config's
tile: the modes of one kernel run different numbers of blocks an SM where
their registers, not their shared memory, bound it, as at K=1 on 16x32.)
"""

from __future__ import annotations

import argparse
import csv
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from lbm_tpu_torch.ops import d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual  # noqa: E402

ENGINES = {"B2": d2q9_kstep, "B3": d2q9_kstep_manual, "B1": d2q9_kstep_inplace}
MODES = ("full", "stream_only", "copy")
KW = dict(omega=1.85, accel_w1=0.1 * 0.005 / 9, accel_w2=0.1 * 0.005 / 36)
BYTES_PER_CELL = 73  # 9 float32 values in and out and the mask byte


def seeded_case(n: int, seed: int = 5):
    """Equilibrium weights at rest, each perturbed by up to 20%, and 5%
    obstacles, made on the card from a seeded generator."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.tensor([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, device="cuda")[:, None, None]
    u = torch.rand((9, n, n), generator=gen, device="cuda")
    f = 0.1 * w * (1.0 + 0.2 * (2.0 * u - 1.0))
    mask = torch.rand((n, n), generator=gen, device="cuda") < 0.05
    return f.contiguous(), mask


def ms_per_pass(mod, f, mask, *, k: int, tile, mode: str, passes: int, warm_up: bool) -> float:
    """Device time of one pass inside `run`, by CUDA events."""
    g = f.clone()
    kw = dict(num_steps=k * passes, k_steps=k, tile=tile, accel_row=f.shape[1] - 2, mode=mode,
              **KW)
    if warm_up:
        mod.run(g, mask, **kw)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    mod.run(g, mask, **kw)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / passes


def breakdown(grids, ks=None, engines=("B2", "B3", "B1"), passes=2000, repeats=5, tile=None):
    """One row per (grid, engine, K, mode). `ks` defaults to 1 and
    choose_config's K, `tile` to choose_config's; passes are scaled down with
    the grid from `passes` at 1024^2 (at least 30)."""
    rows = []
    for n in grids:
        f, mask = seeded_case(n)
        n_passes = max(30, passes * 1024 * 1024 // (n * n))
        for name in engines:
            mod = ENGINES[name]
            config = (mod.choose_config if mod is d2q9_kstep_manual else d2q9_kstep.choose_config)
            th, tw, k_main = config(n, n, torch.float32)
            th, tw = tile or (th, tw)
            for k in ks or sorted({1, k_main}):
                times = {mode: [] for mode in MODES}
                for rep in range(repeats):
                    for i in range(len(MODES)):
                        mode = MODES[(rep + i) % len(MODES)]
                        times[mode].append(ms_per_pass(mod, f, mask, k=k, tile=(th, tw), mode=mode,
                                                       passes=n_passes, warm_up=rep == 0))
                for mode in MODES:
                    ms = statistics.median(times[mode])
                    rows.append(dict(
                        engine=name, mode=mode, grid=f"{n}x{n}", tile=f"{th}x{tw}", k=k,
                        # each kernel moves regions by TMA or by the threads (PATHS)
                        path=mod.last_path,
                        passes=n_passes, repeats=repeats, us_per_pass=round(ms * 1e3, 3),
                        us_min=round(min(times[mode]) * 1e3, 3),
                        us_max=round(max(times[mode]) * 1e3, 3),
                        us_per_step=round(ms * 1e3 / k, 3),
                        mlups=round(n * n * k / ms / 1e3, 1),
                        gbps_of_73_b_per_cell=round(BYTES_PER_CELL * n * n / ms / 1e6, 1)))
                    print(rows[-1], flush=True)
        del f, mask
    return rows


def summary(rows):
    """Lines of copy / streaming / collision per step for each engine and K."""
    by_key, spread = {}, {}
    for r in rows:
        key = (r["grid"], r["engine"], r["k"])
        by_key.setdefault(key, {})[r["mode"]] = r["us_per_step"]
        spread.setdefault(key, []).append(
            f"{r['mode']} {r['us_min']:.3f}-{r['us_max']:.3f}")
    lines = []
    for (grid, engine, k), t in by_key.items():
        lines.append(f"{grid} {engine} K={k}: copy {t['copy']:.3f} us/step, streaming "
                     f"{t['stream_only'] - t['copy']:+.3f}, collision "
                     f"{t['full'] - t['stream_only']:+.3f}, full {t['full']:.3f}; us a pass "
                     + ", ".join(spread[(grid, engine, k)]))
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grids", type=int, nargs="*", default=[1024, 4096, 8192])
    ap.add_argument("--passes", type=int, default=2000, help="passes at 1024^2")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--engines", nargs="*", default=list(ENGINES), choices=list(ENGINES))
    ap.add_argument("--ks", type=int, nargs="*")
    ap.add_argument("--tile", type=int, nargs=2)
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_breakdown2d.csv")))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("breakdown2d: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    rows = breakdown(args.grids, ks=args.ks, engines=args.engines, passes=args.passes,
                     repeats=args.repeats, tile=args.tile)
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; float32; experiments/cuda-kstep-tiles/breakdown2d.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    print("\n".join(summary(rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
