#!/usr/bin/env python3
"""Tile and K sweep of the port's pipelined CUDA D2Q9 kernel (B3,
d2q9_kstep_manual) beside B2 (d2q9_kstep) at the same tile and K, float32.

For every (tile_h, tile_w, K) that fits B3's shared memory on the path it
takes, at 1024^2 and 4096^2: whether B3 equals B2 bit for bit in one `stepk`
(state and Sum|u|), the path each took, B3's persistent grid (blocks, and
blocks per SM on this card) and shared memory a block, then the time
per pass of each inside `run` (CUDA events over `passes` passes, after a
warm-up run). One CSV row per configuration goes to results_manual.csv beside
this file (or --out).

`--probe` is the short first call after a change to the 2-D kernels: it
prints what `nvcc -Xptxas -v` says of csrc/d2q9_kstep.cu, csrc/d2q9_manual.cu
and csrc/copy_floor.cu (registers, spills) and the blocks an SM of B1, B2 and
B3 on each path at 16x32, K=4, then checks, on grids whose sides no tile
divides as on 1024^2 (K = 1..8 there, K = 1 and 4 elsewhere), in both types,
at B3's tile: B2 against `stepk_plain`, B1 and B3 against B2 bit for bit
(one pass and three passes of `run`; at 1024^2 also on a state 4 bytes off 16,
which takes the thread path), the stream_only mode of all three bit-equal to
the plain version's, the copy mode and B12 (copy_floor) equal to their
input; it prints the path each kernel took, and stops.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/sweep_manual.py [--probe] [--passes 300]
        [--grids 1024 4096] [--out FILE]
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
from lbm_tpu_torch.ops import (_build, copy_floor, d2q9_kstep, d2q9_kstep_inplace,  # noqa: E402
                               d2q9_kstep_manual)

TILES = ((8, 32), (8, 64), (16, 32), (16, 64), (32, 32), (8, 128), (16, 16))
KS = (1, 2, 4, 8)
KW = dict(omega=1.85, accel_w1=0.1 * 0.01 / 9, accel_w2=0.1 * 0.01 / 36)
BARS = {torch.float64: 1e-12, torch.float32: 1e-5}
PROBE_SHAPES = ((1024, 1024), (64, 1001), (72, 130), (12, 128), (1000, 1008), (33, 37), (16, 32),
                (32, 64))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def make_case(ny, nx, dtype, seed=3):
    rng = np.random.default_rng(seed)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None]
    f_np = 0.1 * w * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (9, ny, nx)))
    mask_np = rng.uniform(size=(ny, nx)) < 0.05
    return state.to_torch(f_np, mask_np, device="cuda", dtype=dtype)


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def ptxas_report() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / f"{name}.so"), str(_build.source_path(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name in ("d2q9_kstep", "d2q9_manual", "copy_floor")}
        for name, proc in procs.items():
            out, _ = proc.communicate()
            lines = [ln for ln in out.splitlines()
                     if "registers" in ln or "spill" in ln or "error" in ln.lower()
                     or "Compiling entry" in ln]
            print(f"== nvcc -Xptxas -v {name}.cu (rc {proc.returncode})")
            print("\n".join(lines))
            if proc.returncode:
                print(out)
                raise SystemExit(1)


def probe() -> int:
    ptxas_report()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for itemsize, dtype in ((4, torch.float32), (8, torch.float64)):
        for in_place, name in ((False, "B2"), (True, "B1")):
            print(f"{name} 16x32 K=4 itemsize {itemsize}: blocks an SM",
                  {path: d2q9_kstep.blocks_per_sm(in_place, path, (16, 32), 4, itemsize)
                   for path in d2q9_kstep.PATHS}, flush=True)
        f = torch.empty((9, 1024, 1024), dtype=dtype, device="cuda")
        print(f"B3 16x32 K=4 itemsize {itemsize}: blocks an SM",
              {path: d2q9_kstep_manual.grid_blocks(f, (16, 32), 4, path=path) / sms
               for path in d2q9_kstep_manual.PATHS}, "shared memory a block",
              {"thread": d2q9_kstep_manual.smem_bytes(16, 32, 4, itemsize),
               "box": d2q9_kstep_manual.box_smem_bytes(16, 32, 4, itemsize)}, flush=True)
    failures = []

    def check(cond, what):
        if not cond:
            failures.append(what)
            print("FAIL", what, flush=True)

    cases = [(shape, dtype, k, False) for shape in PROBE_SHAPES
             for dtype in (torch.float64, torch.float32)
             for k in (range(1, 9) if shape == (1024, 1024) else (1, 4))]
    cases += [((1024, 1024), dtype, 4, True) for dtype in (torch.float64, torch.float32)]
    for (ny, nx), dtype, k, offset in cases:
        f, mask = make_case(ny, nx, dtype)
        if offset:  # a state 4 bytes off 16: every kernel takes the thread path
            g = torch.empty(f.numel() + 1, dtype=dtype, device="cuda")[1:].view(f.shape)
            f = g.copy_(f)
        if min(ny, nx) < k:
            continue
        kw = dict(k_steps=k, accel_row=ny - 2, **KW)
        itemsize = f.element_size()
        tile = d2q9_kstep_manual.choose_tile(ny, nx, itemsize, k)
        what = f"{ny}x{nx} {str(dtype)[6:]} K={k} tile {tile}{' offset' if offset else ''}"
        ref = d2q9_kstep.stepk_plain(f, mask, **kw)
        b2 = d2q9_kstep.stepk(f, mask, tile=tile, **kw)
        b1 = d2q9_kstep_inplace.stepk(f.clone(), mask, tile=tile, **kw)
        b3 = d2q9_kstep_manual.stepk(f, mask, tile=tile, **kw)
        torch.cuda.synchronize()
        es, et = rel(b2[0], ref[0]), rel(b2[1], ref[1])
        eq1 = torch.equal(b1[0], b2[0]) and torch.equal(b1[1], b2[1])
        eq3 = torch.equal(b3[0], b2[0]) and torch.equal(b3[1], b2[1])
        print(f"probe {what}: paths B2 {d2q9_kstep.last_path}, B1 "
              f"{d2q9_kstep_inplace.last_path}, B3 {d2q9_kstep_manual.last_path}; "
              f"B2 vs plain state {es:.3e} Sum|u| {et:.3e}; "
              f"B1 == B2 {eq1}; B3 == B2 {eq3}; B3 - B2 max abs "
              f"{float((b3[0] - b2[0]).abs().max()):.3e}", flush=True)
        check(es <= BARS[dtype] and et <= BARS[dtype], f"{what}: B2 vs plain")
        check(eq1, f"{what}: B1 != B2")
        check(eq3, f"{what}: B3 != B2")
        run_kw = dict(num_steps=3 * k, k_steps=k, accel_row=ny - 2, tile=tile, **KW)
        r2 = d2q9_kstep.run(f, mask, **run_kw)
        r1 = d2q9_kstep_inplace.run(f.clone(), mask, **run_kw)
        r3 = d2q9_kstep_manual.run(f, mask, **run_kw)
        r3_path = d2q9_kstep_manual.last_path
        torch.cuda.synchronize()
        check(torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1]),
              f"{what}: B1 run != B2 run")
        check(torch.equal(r3[0], r2[0]) and torch.equal(r3[1], r2[1]),
              f"{what}: B3 run != B2 run")
        for mode in ("stream_only", "copy"):
            ref_m = d2q9_kstep.stepk_plain(f, mask, mode=mode, **kw)
            for name, mod in (("B2", d2q9_kstep), ("B1", d2q9_kstep_inplace),
                              ("B3", d2q9_kstep_manual)):
                g = f.clone() if mod is d2q9_kstep_inplace else f
                out = mod.stepk(g, mask, tile=tile, mode=mode, **kw)
                torch.cuda.synchronize()
                ok = torch.equal(out[0], ref_m[0])
                if mode == "stream_only":
                    eu = rel(out[1], ref_m[1])
                    ok = ok and eu <= BARS[dtype]
                check(ok, f"{what}: {name} {mode} differs from the plain version")
        print(f"probe {what}: runs B1 == B2 == B3 (B3 run on the {r3_path} path); "
              "modes stream_only and copy checked", flush=True)
    for ny, nx in PROBE_SHAPES:
        g = make_case(ny, nx, torch.float32)[0]
        out = copy_floor.run_copy(g, 3, 16, 32)
        torch.cuda.synchronize()
        check(torch.equal(out, g), f"{ny}x{nx}: B12 differs from its input")
    f, _ = make_case(1024, 1024, torch.float32)
    print("B3 grid at 1024^2 f32 16x32 K=4:",
          d2q9_kstep_manual.grid_blocks(f, (16, 32), 4), "blocks")
    for by, bx in ((16, 32), (16, 1024), (64, 1024), (5, 7)):
        out = copy_floor.run_copy(f, 2, by, bx)
        torch.cuda.synchronize()
        check(torch.equal(out, f), f"B12 ({by}, {bx}) differs from its input")
    print("probe:", "FAILED " + "; ".join(failures) if failures else "all checks passed")
    return 1 if failures else 0


def time_run(mod, f, mask, k, tile, passes, **kw):
    g = f.clone()
    run_kw = dict(num_steps=k * passes, k_steps=k, tile=tile, accel_row=f.shape[1] - 2, **KW)
    mod.run(g, mask, **run_kw)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    mod.run(g, mask, **run_kw)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / passes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--passes", type=int, default=300)
    ap.add_argument("--grids", type=int, nargs="*", default=[1024, 4096])
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_manual.csv")))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_manual: CUDA is not available", file=sys.stderr)
        return 1
    name = card()
    print(name)
    if args.probe:
        return probe()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for n in args.grids:
        f, mask = make_case(n, n, torch.float32)
        passes = max(20, args.passes * 1024 * 1024 // (n * n))
        for k in KS:
            for tile in TILES:
                smem = d2q9_kstep_manual.launch_smem(n, n)(*tile, k, 4)
                if smem > d2q9_kstep.SMEM_PER_BLOCK or min(tile) < k:
                    continue
                kw = dict(k_steps=k, accel_row=n - 2, tile=tile, **KW)
                b2 = d2q9_kstep.stepk(f, mask, **kw)
                b3 = d2q9_kstep_manual.stepk(f, mask, **kw)
                equal = bool(torch.equal(b2[0], b3[0]) and torch.equal(b2[1], b3[1]))
                blocks = d2q9_kstep_manual.grid_blocks(f, tile, k)
                b2_ms = time_run(d2q9_kstep, f, mask, k, tile, passes)
                b3_ms = time_run(d2q9_kstep_manual, f, mask, k, tile, passes)
                row = dict(grid=n, tile_h=tile[0], tile_w=tile[1], k=k, b3_equals_b2=equal,
                           b3_path=d2q9_kstep_manual.last_path, b2_path=d2q9_kstep.last_path,
                           b3_blocks=blocks, b3_blocks_per_sm=round(blocks / sms, 3),
                           b3_smem_bytes=smem,
                           b2_ms_per_pass=round(b2_ms, 5), b3_ms_per_pass=round(b3_ms, 5),
                           b2_mlups=round(n * n * k / b2_ms / 1e3, 1),
                           b3_mlups=round(n * n * k / b3_ms / 1e3, 1))
                rows.append(row)
                print(row, flush=True)
        del f, mask
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {name}; float32; experiments/cuda-kstep-tiles/sweep_manual.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    for n in args.grids:
        best = max((r for r in rows if r["grid"] == n), key=lambda r: r["b3_mlups"])
        print(f"best B3 at {n}^2:", best)
    return 0


if __name__ == "__main__":
    sys.exit(main())
