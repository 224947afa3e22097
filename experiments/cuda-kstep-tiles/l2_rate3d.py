#!/usr/bin/env python3
"""How fast the one-step D3Q19 kernels run when the lattice lives in L2.

A wave pass (csrc/d3q19_kstep.cu `wave_kernel`) reads its middle steps from
L2, so it can gain over K trips through device memory only as far as a step
from L2 is faster than a step from device memory. This times, float32, at
planes of 128x256 cells and nz = 3 .. 64 planes (a lattice of 2.5 MB a
plane: from a few planes, which L2 holds, to 64, which it does not), one
step of B6 and a K=2 pass of B4 (steps A and B) on the step path, a K=4
pass of each on the wave path, and `copy_` of the lattice. Each is captured `--passes` times in a CUDA
graph and replayed once, so that the host's enqueue does not pace the card;
the time is CUDA events around the replay. Prints and writes to
results_l2_rate3d.csv beside this file (or --out) the ms of a step (a pass
over K for the wave path) and the cells a second.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/l2_rate3d.py [--nz 3 4 8 16 32 64]
        [--passes 200] [--out FILE]
"""

from __future__ import annotations

import argparse
import csv
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from lbm_tpu_torch.ops import d3q19_kstep as b6, d3q19_kstep_inplace as b4  # noqa: E402
from lbm_tpu_torch.ops import d3q19_lattice  # noqa: E402

KW = dict(omega=1.85, density=0.1, accel=0.005)
NY, NX = 128, 256


def graph_ms(fn, passes: int) -> float:
    """Device ms of one call of fn: `passes` calls captured in a graph."""
    fn()  # warm up (and build) outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(passes):
            fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / passes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nz", type=int, nargs="+", default=[3, 4, 8, 16, 32, 64])
    ap.add_argument("--passes", type=int, default=200)
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_l2_rate3d.csv")))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("l2_rate3d: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    rows = []
    for nz in args.nz:
        gen = torch.Generator(device="cuda").manual_seed(nz)
        w = torch.tensor(d3q19_lattice.W, dtype=torch.float32, device="cuda")[:, None, None, None]
        f = (0.1 * w * (1.0 + 0.2 * (2.0 * torch.rand((19, nz, NY, NX), generator=gen,
                                                      device="cuda") - 1.0))).contiguous()
        mask = torch.rand((nz, NY, NX), generator=gen, device="cuda") < 0.05
        kw = dict(accel_plane=nz - 2, **KW)
        other = torch.empty_like(f)
        g = f.clone()
        cases = {
            "copy_": (lambda: other.copy_(g), 1),
            "B6 step": (lambda: b6.stepk(g, mask, k_steps=1, path="step", **kw), 1),
            "B4 step K=2": (lambda: b4.stepk(g, mask, k_steps=2, path="step", **kw), 2),
            "B6 wave K=4": (lambda: b6.stepk(g, mask, k_steps=4, path="wave", **kw), 4),
            "B4 wave K=4": (lambda: b4.stepk(g, mask, k_steps=4, path="wave", **kw), 4),
        }
        for case, (fn, k) in cases.items():
            ms = graph_ms(fn, args.passes) / k
            cells = nz * NY * NX
            rows.append(dict(nz=nz, lattice_mb=round(19 * 4 * cells / 1e6, 1), case=case,
                             ms_per_step=round(ms, 6), gcells_per_s=round(cells / ms / 1e6, 2)))
            print(rows[-1], flush=True)
        del f, g, other, mask
        torch.cuda.empty_cache()
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; float32, planes {NY}x{NX}; "
                 "experiments/cuda-kstep-tiles/l2_rate3d.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
