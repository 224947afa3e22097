#!/usr/bin/env python3
"""Band, block and k sweep of the port's blur kernels at a 4096x4096 RGBA
image (padded 4x4128x4224, 279 MB in float32, far beyond the 50 MB L2).

Rows, one per configuration, to results_blur.csv beside this file (or --out):
  * B9 (`stencil.blur_k`) for every band of `--bands` (the rows a block
    writes) and column windows a channel in a block of `--windows` (the
    block takes as many channels as fit eight warps), at each k of `--ks`, in
    float32 and bfloat16: whether it equals `blur_k_plain` bit for bit, its
    path, ms per launch, ms per pass (= per launch / k), and the bytes of one
    trip ((2C + 1) Hp Wp values) over the time of a launch; then, at the
    default band and block, the same image cut to one channel (1x4128x4224),
    whose mask is read as often as its image: its time a channel against
    the four-channel image's says how much of the mask's trip the channels
    share through L2. k = 0 in `--ks` is B9's trip alone: the kernel's k = 0
    instance, the rows through the ring and out as they came in (the mask
    loaded too), held equal to its input;
  * B10 (`stencil.blur_step`), the library's `blur_step_conv` and a plain copy
    of the image (its own bytes, 2C Hp Wp values), as the yardsticks of one
    pass;
  * B8 (`stencil.blur_resident`) at the padded bricks image 4x320x512 for
    256 and 512 threads a block: ms for 200 passes and microseconds per
    pass from runs of 200 and 2200.
Times are CUDA events over `--launches` launches after two of warm-up.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/sweep_blur.py [--launches 30] [--ks 0 1 2 4 8]
        [--bands 32 64 128 256] [--windows 1 2 4 8] [--out FILE]
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

from lbm_tpu_torch.ops import _build, stencil  # noqa: E402

SHAPE, INNER = (4, 4128, 4224), (4096, 4096)
BRICKS, BRICKS_INNER = (4, 320, 512), (302, 499)
FIELDS = ("kernel", "dtype", "channels", "band", "windows", "k", "threads", "smem_bytes", "path",
          "equals_plain", "ms_per_launch", "ms_per_pass", "trip_gbps")


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
    ap.add_argument("--ks", type=int, nargs="+", default=[0, 1, 2, 4, 8])
    ap.add_argument("--bands", type=int, nargs="+", default=[32, 64, 128, 256])
    ap.add_argument("--windows", type=int, nargs="+", default=[1, 2, 4, 8])
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
        default_windows = stencil.K_WINDOWS
        entry = getattr(_build.load("stencil"),
                        "stencil_k_" + ("f32" if dtype == torch.float32 else "bf16"))

        def trip(band, windows, img=x):
            """B9's k = 0 instance: the rows through the ring, out as they came."""
            out = torch.empty_like(img)
            rc = entry(img.data_ptr(), m.data_ptr(), out.data_ptr(), *img.shape, band, 0,
                       windows, stencil.K_PATHS.index("vector"),
                       torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"stencil_k at k = 0 returned {rc}")
            stencil.last_path = "vector"
            return out

        for k in args.ks:
            ref = x if k == 0 else stencil.blur_k_plain(x, m, k_passes=k)
            for band in args.bands:
                for windows in args.windows:
                    stencil.K_WINDOWS = windows  # the wrapper reads its block from the module
                    run = ((lambda: trip(band, windows)) if k == 0 else
                           (lambda: stencil.blur_k(x, m, k_passes=k, band=band)))
                    equal = bool(torch.equal(run(), ref))
                    ms = time_ms(run, args.launches)
                    _, cpb, wpb = stencil.k_grid(c, h, w, dtype, max(k, 1), band, windows)
                    add(kernel="B9 blur_k", dtype=dname, channels=cpb, band=band, windows=wpb,
                        k=k, threads=32 * (cpb * wpb + 1), path=stencil.last_path,
                        smem_bytes=stencil.blur_k_smem_bytes(cpb, wpb, k, dtype) if k else "",
                        equals_plain=equal, ms_per_launch=round(ms, 5),
                        ms_per_pass=round(ms / max(k, 1), 5),
                        trip_gbps=round(trip_bytes / ms / 1e6, 1))
            del ref
        stencil.K_WINDOWS = default_windows
        # one channel: its mask crosses device memory once for one image plane
        x1, m1 = x[:1].contiguous(), m
        for k in args.ks:
            ms = time_ms((lambda: trip(stencil.DEFAULT_BAND, default_windows, x1)) if k == 0 else
                         (lambda: stencil.blur_k(x1, m1, k_passes=k)), args.launches)
            add(kernel="B9 blur_k, one channel", dtype=dname, channels=1,
                band=stencil.DEFAULT_BAND, windows=default_windows, k=k, path=stencil.last_path,
                ms_per_launch=round(ms, 5), ms_per_pass=round(ms / max(k, 1), 5),
                trip_gbps=round(3 * h * w * x.element_size() / ms / 1e6, 1))
        del x1
        del x, m

    x, m = make(rng, BRICKS, BRICKS_INNER, torch.float32)
    tile = stencil.resident_tiling(*BRICKS, *stencil.device_limits(x.device))
    ref = stencil.blur_resident_plain(x, m, num_passes=200)
    for threads in (256, 512):
        stencil.RESIDENT_THREADS = threads
        equal = bool(torch.equal(stencil.blur_resident(x, m, num_passes=200), ref))
        t200 = time_ms(lambda: stencil.blur_resident(x, m, num_passes=200), 20)
        t2200 = time_ms(lambda: stencil.blur_resident(x, m, num_passes=2200), 5)
        add(kernel=f"B8 blur_resident 200 passes at 4x320x512, tile {tile[0]}x{tile[1]}",
            dtype="float32", k=200, threads=threads,
            smem_bytes=stencil.resident_smem_bytes(*tile), equals_plain=equal,
            ms_per_launch=round(t200, 5), ms_per_pass=round((t2200 - t200) / 2000, 6))

    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; 4096x4096 RGBA padded to {c}x{h}x{w}; "
                 "experiments/cuda-kstep-tiles/sweep_blur.py\n")
        writer = csv.DictWriter(fh, fieldnames=FIELDS)
        writer.writeheader()
        writer.writerows(rows)
    for dname in ("float32", "bfloat16"):
        b9 = [r for r in rows if r["kernel"] == "B9 blur_k" and r["dtype"] == dname]
        for k in args.ks:
            best = min((r for r in b9 if r["k"] == k), key=lambda r: r["ms_per_launch"])
            print(f"best B9 {dname} k={k}: band {best['band']}, {best['windows']} windows, "
                  f"{best['ms_per_launch']} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
