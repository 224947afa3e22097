#!/usr/bin/env python3
"""Tile and k sweep of the port's blur kernels at a 4096x4096 RGBA image
(padded 4x4128x4224, 279 MB in float32, far beyond the 50 MB L2).

Rows, one per configuration, to results_blur.csv beside this file (or --out):
  * B9 (`stencil.blur_k`) for every (tile_h, tile_w, k) that fits a block's
    shared memory, float32, and the default tile in bfloat16: whether it
    equals `blur_k_plain` bit for bit, ms per launch, ms per pass (= per
    launch / k), and the bytes of one trip ((2C + 1) Hp Wp values) over the
    time of a launch, for blocks of 256 and 512 threads;
  * B10 (`stencil.blur_step`), the library's `blur_step_conv` and a plain copy
    of the image (its own bytes, 2C Hp Wp values), as the yardsticks of one
    pass;
  * B8 (`stencil.blur_resident`) at the padded bricks image 4x320x512 for
    256, 512 and 1024 threads a block: ms for 200 passes and microseconds per
    pass from runs of 200 and 2200.
Times are CUDA events over `--launches` launches after two of warm-up.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/sweep_blur.py [--launches 30] [--out FILE]
"""

from __future__ import annotations

import argparse
import csv
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from lbm_tpu_torch.ops import stencil  # noqa: E402

SHAPE, INNER = (4, 4128, 4224), (4096, 4096)
BRICKS, BRICKS_INNER = (4, 320, 512), (302, 499)
TILES = ((8, 128), (16, 64), (16, 128), (16, 256), (32, 32), (32, 64), (32, 128), (32, 256),
         (64, 64), (64, 128), (128, 64))
KS = (1, 2, 4, 8)
DEFAULTS = (stencil.DEFAULT_TILE, stencil.K_THREADS)  # before the sweep changes them
FIELDS = ("kernel", "dtype", "tile_h", "tile_w", "k", "threads", "smem_bytes", "equals_plain",
          "ms_per_launch", "ms_per_pass", "trip_gbps")


def time_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def make(rng, shape, inner, dtype):
    interior = np.zeros(shape[1:], np.float32)
    interior[1:1 + inner[0], 1:1 + inner[1]] = 1
    img = rng.random(shape).astype(np.float32) * interior
    return (torch.from_numpy(img).to("cuda", dtype), torch.from_numpy(interior).to("cuda", dtype))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launches", type=int, default=30)
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_blur.csv")))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_blur: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    rng = np.random.default_rng(4)
    rows = []

    def add(**row):
        rows.append({**dict.fromkeys(FIELDS, ""), **row})
        print(rows[-1], flush=True)

    c, h, w = SHAPE
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x, m = make(rng, SHAPE, INNER, dtype)
        trip_bytes = (2 * c + 1) * h * w * x.element_size()

        def one_pass(kernel, fn, nbytes=trip_bytes):
            ms = time_ms(fn, args.launches)
            add(kernel=kernel, dtype=dname, k=1, ms_per_launch=round(ms, 5),
                ms_per_pass=round(ms, 5), trip_gbps=round(nbytes / ms / 1e6, 1))

        one_pass("copy (clone of the image)", lambda: x.clone(),
                 2 * x.numel() * x.element_size())
        one_pass("library blur_step_conv", lambda: stencil.blur_step_conv(x, m))
        add(kernel="B10 blur_step", dtype=dname, k=1,
            equals_plain=bool(torch.equal(stencil.blur_step(x, m),
                                          stencil.blur_step_plain(x, m))))
        one_pass("B10 blur_step", lambda: stencil.blur_step(x, m))
        for k in KS:
            ref = stencil.blur_k_plain(x, m, k_passes=k)
            for tile in (TILES if dtype == torch.float32 else (DEFAULTS[0],)):
                smem = stencil.blur_k_smem_bytes(*tile, k)
                if smem > stencil.SMEM_PER_BLOCK:
                    continue
                for threads in ((256, 512) if dtype == torch.float32 else (DEFAULTS[1],)):
                    # the wrapper reads its tile's width and its threads from the module
                    stencil.DEFAULT_TILE, stencil.K_THREADS = tile, threads
                    equal = bool(torch.equal(stencil.blur_k(x, m, k_passes=k), ref))
                    ms = time_ms(lambda: stencil.blur_k(x, m, k_passes=k), args.launches)
                    add(kernel="B9 blur_k", dtype=dname, tile_h=tile[0], tile_w=tile[1], k=k,
                        threads=threads, smem_bytes=smem, equals_plain=equal,
                        ms_per_launch=round(ms, 5), ms_per_pass=round(ms / k, 5),
                        trip_gbps=round(trip_bytes / ms / 1e6, 1))
            del ref
        del x, m

    x, m = make(rng, BRICKS, BRICKS_INNER, torch.float32)
    tile = stencil.resident_tiling(*BRICKS, *stencil.device_limits(x.device))
    ref = stencil.blur_resident_plain(x, m, num_passes=200)
    for threads in (256, 512, 1024):
        stencil.RESIDENT_THREADS = threads
        equal = bool(torch.equal(stencil.blur_resident(x, m, num_passes=200), ref))
        t200 = time_ms(lambda: stencil.blur_resident(x, m, num_passes=200), 20)
        t2200 = time_ms(lambda: stencil.blur_resident(x, m, num_passes=2200), 5)
        add(kernel="B8 blur_resident 200 passes at 4x320x512", dtype="float32", tile_h=tile[0],
            tile_w=tile[1], k=200, threads=threads,
            smem_bytes=stencil.resident_smem_bytes(*tile), equals_plain=equal,
            ms_per_launch=round(t200, 5), ms_per_pass=round((t2200 - t200) / 2000, 6))

    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; 4096x4096 RGBA padded to {c}x{h}x{w}; "
                 "experiments/cuda-kstep-tiles/sweep_blur.py\n")
        writer = csv.DictWriter(fh, fieldnames=FIELDS)
        writer.writeheader()
        writer.writerows(rows)
    b9 = [r for r in rows if r["kernel"] == "B9 blur_k" and r["dtype"] == "float32"]
    print("best B9 per pass:", min(b9, key=lambda r: r["ms_per_pass"]))
    print("best B9 at k=4:", min((r for r in b9 if r["k"] == 4), key=lambda r: r["ms_per_pass"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
