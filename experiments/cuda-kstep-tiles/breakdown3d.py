#!/usr/bin/env python3
"""Attribute the port's 3-D K-step time: memory movement against arithmetic.

The 3-D counterpart of breakdown2d.py. The in-place blocked D3Q19 kernel B5
(d3q19_kstep_inplace_blocked) runs in its three modes, at each K:

  full        - the production pass;
  stream_only - the same load, store and ring, K pull-streams in shared
                memory, no bounce-back and no collision;
  copy        - the same load, store and ring, no step at all.

So copy is what B5's memory movement costs (the load of the extended tile,
the store into the ring, the flush and the snapshot), stream_only - copy
what its K steps cost without the collision, and full - stream_only the
collisions. The two-stream kernel B6 (d3q19_kstep) runs its four modes on
its wave path (one launch a pass, the middle steps through L2): copy (every
stage loads and stores its cells in place, no pull), collide_no_roll (the
pull along z and the collision), stream_only (the full pull, no collision)
and full; so B6 copy is a wave pass's load and store, stream_only - copy
its streaming, full - stream_only its collisions. Beside them, for scale:
B7 full (d3q19_kstep_blocked, the same kernel as B5 in one launch, out of
place), B4 (d3q19_kstep_inplace, on the path its `run` takes) and `copy_`
of the lattice (Tensor.copy_ between two lattices: a pass's bytes at the
library's rate).

The time of a pass is CUDA events around `passes` passes of the wrapper's
`run` (after a warm-up run), on a state seeded on the card with 5% obstacles,
float32, at B5's tile (`choose_config`) for B5 and B7. Each (grid, K) takes
its cases `repeats` times, in rounds that take them in a rotating order, so
that a drift of the card's clock or temperature falls on every case alike.
`--path thread` forces B5 and B7 onto the thread path (the split before the
box path); by default each takes `choose_path`'s. Writes
results_breakdown3d.csv beside this file (or --out): per (grid, K, case)
the path, the tile, the median, least and greatest ms a pass over the
repeats, and the bytes of a pass (153 a cell: 19 values in and out and the
mask byte) over its median time.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/breakdown3d.py [--grids 32x256x256 64x128x256]
        [--ks 1 2 3] [--passes 100] [--repeats 5] [--path thread]
        [--tiles 8x6x16 4x4x32 ...] [--out FILE]
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

from lbm_tpu_torch.ops import (d3q19_kstep as b6,  # noqa: E402
                               d3q19_kstep_blocked as b7, d3q19_kstep_inplace as b4,
                               d3q19_kstep_inplace_blocked as b5, d3q19_lattice)

KW = dict(omega=1.85, density=0.1, accel=0.005)
BYTES_PER_CELL = 153  # 19 float32 values in and out, and the mask byte
CASES = ("B5 copy", "B5 stream_only", "B5 full", "B7 full", "B6 copy", "B6 collide_no_roll",
         "B6 stream_only", "B6 full", "B4 full", "copy_")


def seeded_case(shape, seed: int = 5):
    """Weights at rest, each perturbed by up to 20%, and 5% obstacles, made
    on the card from a seeded generator."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.tensor(d3q19_lattice.W, dtype=torch.float32, device="cuda")[:, None, None, None]
    u = torch.rand((19, *shape), generator=gen, device="cuda")
    f = 0.1 * w * (1.0 + 0.2 * (2.0 * u - 1.0))
    mask = torch.rand(shape, generator=gen, device="cuda") < 0.05
    return f.contiguous(), mask


def ms_per_pass(case: str, f, mask, *, k: int, tile, path, passes: int, warm_up: bool):
    """(device ms of one pass inside `run`, by CUDA events; the path)."""
    name, mode = case.split() if " " in case else (case, None)
    g = f.clone()
    other = torch.empty_like(f) if name == "copy_" else None
    kw = dict(num_steps=k * passes, k_steps=k, accel_plane=f.shape[1] - 2, **KW)
    if name == "B5":
        def run():
            b5.run(g, mask, tile=tile, mode=mode, path=path, **kw)
    elif name == "B7":
        def run():
            b7.run(g, mask, tile=tile, path=path, **kw)
    elif name == "B6":
        def run():
            b6.run(g, mask, mode=mode, path="wave", **kw)
    elif name == "B4":
        def run():
            b4.run(g, mask, **kw)
    else:
        def run():
            for _ in range(passes):
                other.copy_(g)
    if warm_up:
        run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    used = {"B5": b5, "B7": b7, "B6": b6, "B4": b4}.get(name)
    return start.elapsed_time(end) / passes, used.last_path if used else ""


def breakdown(grids, ks, passes=100, repeats=5, path=None, tiles=None):
    """One row per (grid, K, tile, case): B5's tile (`choose_config`) or each
    of `tiles`; passes scaled down with the cells from `passes` at
    32x256x256 (at least 20)."""
    rows = []
    for shape in grids:
        f, mask = seeded_case(shape)
        cells = shape[0] * shape[1] * shape[2]
        n_passes = max(20, passes * 32 * 256 * 256 // cells)
        for k, tile in ((k, t) for k in ks
                        for t in tiles or [b5.choose_config(*shape, k, torch.float32, f.device)]):
            times = {case: [] for case in CASES}
            paths = {}
            for rep in range(repeats):
                for i in range(len(CASES)):
                    case = CASES[(rep + i) % len(CASES)]
                    ms, paths[case] = ms_per_pass(case, f, mask, k=k, tile=tile, path=path,
                                                  passes=n_passes, warm_up=rep == 0)
                    times[case].append(ms)
            for case in CASES:
                ms = statistics.median(times[case])
                rows.append(dict(
                    case=case, grid="x".join(map(str, shape)), k=k,
                    tile="x".join(map(str, tile)) if case[:2] in ("B5", "B7") else "",
                    path=paths[case], passes=n_passes, repeats=repeats, ms_per_pass=round(ms, 5),
                    ms_min=round(min(times[case]), 5), ms_max=round(max(times[case]), 5),
                    gbps_of_153_b_per_cell=round(BYTES_PER_CELL * cells / ms / 1e6, 1)))
                print(rows[-1], flush=True)
        del f, mask
        torch.cuda.empty_cache()
    return rows


def summary(rows):
    """Lines of B5's load and store, streaming and collision a pass."""
    by_key = {}
    for r in rows:
        by_key.setdefault((r["grid"], r["k"], r["tile"] or None), {})[r["case"]] = r
        if r["case"][:2] in ("B4", "B6", "co"):  # no tile: beside every tile of its (grid, K)
            for key in [key for key in by_key if key[:2] == (r["grid"], r["k"])]:
                by_key[key][r["case"]] = r
    lines = []
    for (grid, k, _), t in by_key.items():
        if "B5 full" not in t:
            continue
        ms = {case: r["ms_per_pass"] for case, r in t.items()}
        lines.append(
            f"{grid} K={k} ({t['B5 full']['path']} path, tile {t['B5 full']['tile']}): B5 copy "
            f"{ms['B5 copy']:.4f} ms, streaming {ms['B5 stream_only'] - ms['B5 copy']:+.4f}, "
            f"collision {ms['B5 full'] - ms['B5 stream_only']:+.4f}, full {ms['B5 full']:.4f} "
            f"(load and store {100 * ms['B5 copy'] / ms['B5 full']:.0f}% of it); B7 "
            f"{ms['B7 full']:.4f}, B4 {ms['B4 full']:.4f}, copy_ {ms['copy_']:.4f}; B6 on the "
            f"wave path: copy {ms['B6 copy']:.4f} ms, streaming "
            f"{ms['B6 stream_only'] - ms['B6 copy']:+.4f}, collision "
            f"{ms['B6 full'] - ms['B6 stream_only']:+.4f}, full {ms['B6 full']:.4f} (load and "
            f"store {100 * ms['B6 copy'] / ms['B6 full']:.0f}%), collide_no_roll "
            f"{ms['B6 collide_no_roll']:.4f}")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grids", nargs="*", default=["32x256x256", "64x128x256"])
    ap.add_argument("--ks", type=int, nargs="*", default=[1, 2, 3])
    ap.add_argument("--passes", type=int, default=100, help="passes at 32x256x256")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--path", choices=b7.PATHS, default=None,
                    help="force B5's and B7's path (default: choose_path's)")
    ap.add_argument("--tiles", nargs="*", default=None,
                    help="tiles TZxTYxTX of B5 and B7 (default: B5's choose_config)")
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_breakdown3d.csv")))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("breakdown3d: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    grids = [tuple(int(v) for v in g.split("x")) for g in args.grids]
    tiles = [tuple(int(v) for v in t.split("x")) for t in args.tiles] if args.tiles else None
    rows = breakdown(grids, args.ks, args.passes, args.repeats, args.path, tiles)
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; float32; experiments/cuda-kstep-tiles/breakdown3d.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    print("\n".join(summary(rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
