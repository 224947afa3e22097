#!/usr/bin/env python3
"""Tile, thread-count and K sweep of the port's blocked CUDA D3Q19 kernels (B7
d3q19_kstep_blocked, B5 d3q19_kstep_inplace_blocked) at 32x256x256, the shape
of the reference's `d3q19_blocked_only` benchmark, in float32 and float64.

For every K of KS it first times the one-step kernels B6 and B4 at that K
(K launches per pass). Then, for every tile (tz, ty, tx) that fits the
device's shared memory and loads at most LOAD_SLACK times the cells per cell
kept of the best tile (small tiles load more but several fit an SM), and for
every thread count: the path `choose_path` gives it (box or thread), the
largest difference of B7's state from B6's (0 when they are bit-equal),
whether B5 equals B7 bit for bit in one `stepk` (state and Sum|u|), then the
time per pass of each inside `run` (CUDA events over `passes` passes, after
warm-up; B5 only where its ring and snapshot keep to its `choose_config`'s
limit). One CSV row per configuration goes to results3d_blocked.csv beside
this file (or --out).

`--slab` times only the one-step kernels B6 and B4, on each of their paths
(d3q19_kstep.PATHS: the wave path, one launch a pass, and the step path, a
launch a step) at each K and type, the median of `--repeats` timings (the
repeats in turn, every case once in each), into results3d_slab.csv beside
this file (or --out): the rows of d3q19_kstep.PATH_MS. `--dtypes bfloat16`
takes the passes the wave path has in bfloat16 (`d3q19_kstep.wave_takes`:
B4's at K > 1) and the step path's of both (results3d_slab_bf16.csv, with --out).

`--probe` is the short first call after a change to the kernels: it prints
what `nvcc -Xptxas -v` says of csrc/d3q19_blocked.cu (registers, spills),
checks B7 and B5 against `stepk_plain` and B6 at K = 1..4 in both types at
B5's tile on PROBE_SHAPES (and a tile of the box path where B5's takes the
thread path), each on its chosen path against the thread path (where its
block fits),
and B5's modes against their plain versions (`check_paths`), times one K=2
pass of each on either path, and stops.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/sweep3d_blocked.py [--probe | --slab]
        [--passes 50] [--repeats 5] [--dtypes float32 float64] [--ks 1 2 3 4]
        [--out FILE]
"""

from __future__ import annotations

import argparse
import csv
import statistics
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
# the probe's shapes: the benchmark's, one that wraps in every axis with
# edge tiles (box path), one whose rows are not whole 16-byte pieces (thread)
PROBE_SHAPES = ((NZ, NY, NX), (12, 16, 32), (13, 50, 70))
# tiles of the box path that the probe takes where B5's own tile is not one
BOX_TILES = ((4, 6, 16), (2, 4, 8), (2, 2, 4), (1, 2, 2))
DTYPES = {"float32": torch.float32, "float64": torch.float64}
SLAB_DTYPES = {**DTYPES, "bfloat16": torch.bfloat16}  # --slab only
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


def ptxas_report() -> int:
    """What nvcc -Xptxas -v says of csrc/d3q19_blocked.cu; its return code."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(Path(tmp) / "probe.so"), str(_build.source_path("d3q19_blocked"))]
        res = subprocess.run(cmd, capture_output=True, text=True)
    lines = [ln for ln in res.stderr.splitlines()
             if "blocked_kernel" in ln or "registers" in ln or "spill" in ln or "error" in ln]
    print("\n".join(lines))
    if res.returncode:
        print(res.stderr)
    return res.returncode


def probe_tiles(shape, k, dtype, device="cuda") -> list:
    """B5's tile, and a tile of the box path (the first of BOX_TILES that
    takes it) where B5's does not, and the grid's rows allow one."""
    tiles = [b5.choose_config(*shape, k, dtype, device)]
    if b7.choose_path(*shape, tiles[0], k, dtype, device=device) != "box":
        tiles += [t for t in BOX_TILES
                  if b7.choose_path(*shape, t, k, dtype, device=device) == "box"][:1]
    return tiles


def check_paths(shapes=PROBE_SHAPES, ks=KS, dtypes=DTYPES, log=print, seen=None) -> list:
    """B7 and B5 on each shape, type, K and window: against `stepk_plain`
    (1e-5 in float32, 1e-12 in float64), B7's state against B6's bit for bit,
    B5 against B7 bit for bit, each on its chosen path against the thread
    path bit for bit, and B5's `stream_only` and `copy` modes against their
    plain versions (the state bit for bit; stream_only's Sum|u| within the
    type's bar, copy's zeros). Returns the failures, each a line; `seen`, a
    dict, gets the paths each type's launches took."""
    bad = []
    for shape in shapes:
        nz = shape[0]
        windows = {"full": dict(accel_plane=nz - 2),
                   "window": dict(plane_offset=5, valid_planes=(2, nz - 3),
                                  valid_rows=(3, shape[1] - 2), global_nz=nz + 20,
                                  accel_plane=nz // 2 + 5)}
        for dname in dtypes:
            dtype = DTYPES[dname]
            bar = 1e-5 if dtype == torch.float32 else 1e-12
            f, mask = make_case(shape, dtype)
            for k, tile in ((k, t) for k in ks for t in probe_tiles(shape, k, dtype)):
                # the thread path to compare with, where its block fits
                thread = "thread" if b7.thread_fits(tile, k, dtype, f.device) else None
                for label, win in windows.items():
                    kw = dict(k_steps=k, **KW, **win)
                    ref_f, ref_t = d3q19_kstep.stepk_plain(f, mask, **kw)
                    b6_f, _ = d3q19_kstep.stepk(f, mask, **kw)
                    b7_f, b7_t = b7.stepk(f, mask, tile=tile, **kw)
                    path7 = b7.last_path
                    if seen is not None:
                        seen.setdefault(dname, set()).add(path7)
                    th7_f, th7_t = b7.stepk(f, mask, tile=tile, path=thread, **kw)
                    g = f.clone()
                    b5_f, b5_t = b5.stepk(g, mask, tile=tile, **kw)
                    path5 = b5.last_path
                    h = f.clone()
                    th5_f, th5_t = b5.stepk(h, mask, tile=tile, path=thread, **kw)
                    torch.cuda.synchronize()
                    err = float((b7_f - ref_f).abs().max() / ref_f.abs().max())
                    terr = float((b7_t - ref_t).abs().max() / ref_t.abs().max())
                    d6 = float((b7_f - b6_f).abs().max())
                    same = {"B5 == B7": torch.equal(b5_f, b7_f) and torch.equal(b5_t, b7_t),
                            "B7 == thread": torch.equal(b7_f, th7_f) and torch.equal(b7_t, th7_t),
                            "B5 == thread": torch.equal(b5_f, th5_f) and torch.equal(b5_t, th5_t)}
                    what = f"{shape} {dname} K={k} {label} tile {tile}"
                    log(f"probe {what}: paths B7 {path7}, B5 {path5}"
                        + ("" if thread else " (the thread path's block does not fit)")
                        + f"; B7 vs plain {err:.3e} "
                        f"(Sum|u| {terr:.3e}), B7 - B6 max abs {d6:.3e}, "
                        + ", ".join(f"{key}: {val}" for key, val in same.items()))
                    if err > bar or terr > bar or d6 != 0.0 or not all(same.values()):
                        bad.append(what)
                    del ref_f, b6_f, b7_f, th7_f, b5_f, th5_f, g, h
                # the modes, at the plain window
                kw = dict(k_steps=k, **KW, **windows["full"])
                for mode in ("stream_only", "copy"):
                    ref_f, ref_t = d3q19_kstep.stepk_plain(f, mask, mode=mode, **kw)
                    for path in dict.fromkeys((None, thread)):
                        g = f.clone()
                        got_f, got_t = b5.stepk(g, mask, tile=tile, mode=mode, path=path, **kw)
                        torch.cuda.synchronize()
                        terr = float((got_t - ref_t).abs().max() / max(float(ref_t.abs().max()),
                                                                        1e-300))
                        ok = torch.equal(got_f, ref_f) and (
                            not got_t.any() if mode == "copy" else terr <= bar)
                        log(f"probe {shape} {dname} K={k} B5 {mode} ({b5.last_path} path): "
                            f"state {'bit-equal' if torch.equal(got_f, ref_f) else 'DIFFERS'}, "
                            f"Sum|u| {'zeros' if not got_t.any() else f'{terr:.3e}'}")
                        if not ok:
                            bad.append(f"{shape} {dname} K={k} B5 {mode} {b5.last_path}")
                        del g, got_f
            del f, mask
    return bad


def probe() -> int:
    if ptxas_report():
        return 1
    bad = check_paths()
    # one K=2 pass at 32x256x256 float32 on each path, beside B4 and B6
    f, mask = make_case((NZ, NY, NX), torch.float32)
    kw = dict(accel_plane=NZ - 2, **KW)
    for name, mod in (("B7", b7), ("B5", b5)):
        for path in (None, "thread"):
            ms = time_run(mod, f, mask, 2, 20, path=path, **kw)
            print(f"probe timing {name} K=2 ({mod.last_path} path, tile "
                  f"{mod.choose_config(NZ, NY, NX, 2)}): {ms:.4f} ms a pass", flush=True)
    for name, mod in (("B6", d3q19_kstep), ("B4", d3q19_kstep_inplace)):
        print(f"probe timing {name} K=2: {time_run(mod, f, mask, 2, 20, **kw):.4f} ms a pass")
    if bad:
        print("FAILED:", *bad, sep="\n  ")
    return 1 if bad else 0


def slab(dtypes, ks, passes: int, repeats: int, out: str, card: str) -> int:
    """B6 and B4 on each path at each K and type (the module doc's --slab)."""
    rows = []
    for dname in dtypes:
        dtype = SLAB_DTYPES[dname]
        f, mask = make_case((NZ, NY, NX), dtype)
        kw = dict(accel_plane=NZ - 2, **KW)
        cases = [(k, name, mod, path) for k in ks
                 for name, mod in (("b6", d3q19_kstep), ("b4", d3q19_kstep_inplace))
                 for path in d3q19_kstep.PATHS
                 if path == "step" or d3q19_kstep.wave_takes(dtype, name, k)]
        times = {case[:2] + case[3:]: [] for case in cases}
        for _ in range(repeats):
            for k, name, mod, path in cases:
                times[(k, name, path)].append(time_run(mod, f, mask, k, passes, path=path, **kw))
        for (k, name, path), ms in times.items():
            rows.append(dict(dtype=dname, k=k, kernel=name, path=path,
                             ms_per_pass=f"{statistics.median(ms):.4f}",
                             ms_min=f"{min(ms):.4f}", ms_max=f"{max(ms):.4f}", repeats=len(ms),
                             card=card.replace(",", "")))
            print(rows[-1], flush=True)
        del f, mask
    with open(out, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    for dname in dtypes:
        for name in ("b6", "b4"):
            for path in d3q19_kstep.PATHS:
                ms = [r["ms_per_pass"] for r in rows
                      if (r["dtype"], r["kernel"], r["path"]) == (dname, name, path)]
                print(f"{dname} {name} {path}: ({', '.join(ms)})")
    print(f"wrote {out}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--slab", action="store_true")
    ap.add_argument("--passes", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=5, help="timings a case (--slab)")
    ap.add_argument("--dtypes", nargs="+", default=list(DTYPES), choices=list(SLAB_DTYPES))
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
    if args.slab:
        out = (args.out if args.out != ap.get_default("out")
               else str(Path(__file__).with_name("results3d_slab.csv")))
        return slab(args.dtypes, args.ks, args.passes, args.repeats, out, card)
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
            scratch = b5.max_scratch_planes(NZ, k)
            for tile in tiles:
                for threads in sorted({256, b7.MAX_THREADS[dtype]}):
                    cfg = dict(tile=tile, threads=threads)
                    b7_f, b7_t = b7.stepk(f, mask, k_steps=k, **cfg, **kw)
                    b5_f, b5_t = b5.stepk(f.clone(), mask, k_steps=k, **cfg, **kw)
                    path = b7.choose_path(NZ, NY, NX, tile, k, dtype)
                    smem = (b7.box_shared_bytes if path == "box" else b7.shared_bytes)(tile, k,
                                                                                       dtype)
                    row = dict(
                        dtype=dname, k=k, tz=tile[0], ty=tile[1], tx=tile[2], threads=threads,
                        path=path, smem_bytes=smem,
                        loaded_per_kept=f"{b7.loaded_per_kept(tile, k):.3f}",
                        scratch_planes=sum(b7.scratch_planes(tile, k, NZ)),
                        b7_minus_b6=f"{float((b7_f - b6_f).abs().max()):.3e}",
                        b5_equals_b7=bool(torch.equal(b5_f, b7_f) and torch.equal(b5_t, b7_t)))
                    del b7_f, b5_f
                    # B5 only where its ring and snapshot keep to choose_config's limit
                    for name, mod in (("b7", b7), ("b5", b5)):
                        if name == "b5" and row["scratch_planes"] > scratch:
                            row["b5_ms_per_pass"] = row["b5_mlups"] = ""
                            continue
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
