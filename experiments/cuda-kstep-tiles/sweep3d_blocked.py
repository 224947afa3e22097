#!/usr/bin/env python3
"""Tile, thread-count and K sweep of the port's blocked CUDA D3Q19 kernels (B7
d3q19_kstep_blocked, B5 d3q19_kstep_inplace_blocked) at 32x256x256, the shape
of the reference's `d3q19_blocked_only` benchmark, in float32 and float64.

For every K of KS it first times the one-step kernels B6 and B4 at that K
(K launches per pass). Then, for every tile (tz, ty, tx) that fits the
device's shared memory and loads at most LOAD_SLACK times the cells per cell
kept of the best tile (small tiles load more but several fit an SM), and for
every thread count: the largest difference of
B7's state from B6's (0 when they are bit-equal), whether B5 equals B7 bit
for bit in one `stepk` (state and Sum|u|), then the time per pass of each
inside `run` (CUDA events over `passes` passes, after warm-up). One CSV row
per configuration goes to results3d_blocked.csv beside this file (or --out).

`--probe` is the short first call after a change to the kernels: it prints
what `nvcc -Xptxas -v` says of csrc/d3q19_blocked.cu (registers, spills),
checks B7 and B5 against `stepk_plain` and B6 at K = 1..4 in both types at
the default tile and on a shape no tile divides, and stops.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/sweep3d_blocked.py [--probe]
        [--passes 50] [--dtypes float32 float64] [--ks 1 2 3 4] [--out FILE]
"""

from __future__ import annotations

import argparse
import csv
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from lbm_tpu_torch.core import state  # noqa: E402
from lbm_tpu_torch.ops import (_build, d3q19_kstep, d3q19_kstep_blocked as b7,  # noqa: E402
                               d3q19_kstep_inplace, d3q19_kstep_inplace_blocked as b5,
                               d3q19_lattice)

NZ, NY, NX = 32, 256, 256
KS = (1, 2, 3, 4)
TZ = (1, 2, 3, 4, 5, 6, 8)
TY = (2, 3, 4, 5, 6, 8, 10, 12, 16)
TX = (8, 16, 32, 64)
LOAD_SLACK = 2.5
DTYPES = {"float32": torch.float32, "float64": torch.float64}
KW = dict(omega=1.85, density=0.1, accel=0.005)


def make_case(shape, dtype, seed=3):
    rng = np.random.default_rng(seed)
    f_np = d3q19_lattice.initial_distributions(*shape, 0.1, np.float64)
    f_np = f_np * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, f_np.shape))
    mask_np = rng.uniform(size=shape) < 0.05
    mask_np[0] = mask_np[-1] = True
    return state.to_torch3d(f_np, mask_np, device="cuda", dtype=dtype)


def time_run(mod, f, mask, k, passes, **kw):
    g = f.clone()
    mod.run(g, mask, num_steps=2 * k, k_steps=k, **kw)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    mod.run(g, mask, num_steps=k * passes, k_steps=k, **kw)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / passes


def probe() -> int:
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(Path(tmp) / "probe.so"), str(_build.source_path("d3q19_blocked"))]
        res = subprocess.run(cmd, capture_output=True, text=True)
        lines = [ln for ln in res.stderr.splitlines()
                 if "blocked_kernel" in ln or "registers" in ln or "error" in ln]
        print("\n".join(lines))
        if res.returncode:
            print(res.stderr)
            return 1
    ok = True
    for shape in ((NZ, NY, NX), (13, 50, 70)):
        nz = shape[0]
        windows = {"full": dict(accel_plane=nz - 2),
                   "window": dict(plane_offset=5, valid_planes=(2, nz - 3), valid_rows=(3, 40),
                                  global_nz=nz + 20, accel_plane=nz // 2 + 5)}
        for dname, dtype in DTYPES.items():
            f, mask = make_case(shape, dtype)
            for k in KS:
                for label, win in windows.items():
                    kw = dict(k_steps=k, **KW, **win)
                    ref_f, ref_t = d3q19_kstep.stepk_plain(f, mask, **kw)
                    b6_f, b6_t = d3q19_kstep.stepk(f, mask, **kw)
                    tile = b5.choose_config(*shape, k, dtype, f.device)
                    b7_f, b7_t = b7.stepk(f, mask, tile=tile, **kw)
                    g = f.clone()
                    b5_f, b5_t = b5.stepk(g, mask, tile=tile, **kw)
                    torch.cuda.synchronize()
                    err = float((b7_f - ref_f).abs().max() / ref_f.abs().max())
                    terr = float((b7_t - ref_t).abs().max() / ref_t.abs().max())
                    d6 = float((b7_f - b6_f).abs().max())
                    eq = bool(torch.equal(b5_f, b7_f) and torch.equal(b5_t, b7_t))
                    print(f"probe {shape} {dname} K={k} {label} tile {tile}: B7 vs plain "
                          f"{err:.3e} (Sum|u| {terr:.3e}), B7 - B6 max abs {d6:.3e}, "
                          f"B5 == B7: {eq}", flush=True)
                    ok = ok and err <= (1e-5 if dtype == torch.float32 else 1e-12) and eq
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--passes", type=int, default=50)
    ap.add_argument("--dtypes", nargs="+", default=list(DTYPES), choices=list(DTYPES))
    ap.add_argument("--ks", nargs="+", type=int, default=list(KS), choices=list(KS))
    ap.add_argument("--out", default=str(Path(__file__).with_name("results3d_blocked.csv")))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep3d_blocked: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    if args.probe:
        return probe()
    cells = NZ * NY * NX
    rows = []
    for dname in args.dtypes:
        dtype = DTYPES[dname]
        f, mask = make_case((NZ, NY, NX), dtype)
        kw = dict(accel_plane=NZ - 2, **KW)
        budget = b7.smem_per_block(f.device) - b7.STATIC_SMEM
        for k in args.ks:
            b6_f, _ = d3q19_kstep.stepk(f, mask, k_steps=k, **kw)
            b6_ms = time_run(d3q19_kstep, f, mask, k, args.passes, **kw)
            b4_ms = time_run(d3q19_kstep_inplace, f, mask, k, args.passes, **kw)
            tiles = [(tz, ty, tx) for tx in TX for tz in TZ for ty in TY
                     if b7.shared_bytes((tz, ty, tx), k, dtype) <= budget]
            best = min(b7.loaded_per_kept(t, k) for t in tiles)
            tiles = [t for t in tiles if b7.loaded_per_kept(t, k) <= LOAD_SLACK * best]
            for tile in tiles:
                for threads in sorted({256, b7.MAX_THREADS[dtype]}):
                    cfg = dict(tile=tile, threads=threads)
                    b7_f, b7_t = b7.stepk(f, mask, k_steps=k, **cfg, **kw)
                    b5_f, b5_t = b5.stepk(f.clone(), mask, k_steps=k, **cfg, **kw)
                    row = dict(
                        dtype=dname, k=k, tz=tile[0], ty=tile[1], tx=tile[2], threads=threads,
                        smem_bytes=b7.shared_bytes(tile, k, dtype),
                        loaded_per_kept=f"{b7.loaded_per_kept(tile, k):.3f}",
                        scratch_planes=sum(b7.scratch_planes(tile, k, NZ)),
                        b7_minus_b6=f"{float((b7_f - b6_f).abs().max()):.3e}",
                        b5_equals_b7=bool(torch.equal(b5_f, b7_f) and torch.equal(b5_t, b7_t)))
                    del b7_f, b5_f
                    for name, mod in (("b7", b7), ("b5", b5)):
                        ms = time_run(mod, f, mask, k, args.passes, **cfg, **kw)
                        row[f"{name}_ms_per_pass"] = f"{ms:.4f}"
                        row[f"{name}_mlups"] = f"{cells * k / ms / 1e3:.0f}"
                    row["b6_ms_per_pass"] = f"{b6_ms:.4f}"
                    row["b4_ms_per_pass"] = f"{b4_ms:.4f}"
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
