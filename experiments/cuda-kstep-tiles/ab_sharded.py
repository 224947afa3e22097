#!/usr/bin/env python3
"""Time the 2-D multi-device paths of two copies of the port on one card.

Each copy (a directory that holds a `lbm_tpu_torch/` package, e.g. the parent
commit unpacked by `git archive`) runs in a process of its own, which imports
that copy's package, joins a NCCL process group of itself alone (world size
1, as chip_smoke.py's sharded phase) and builds its kernels into that copy's
`build/`. The processes run in the order A, B, B, A, so that a drift of the
card or of its host falls on both copies alike. Each runs, on a 1024x1024
grid with a seeded mask (the flagship's physics): every halo strategy of
`--engine sharded` and the plain `torch` engine for `--steps` steps, and
`--engine sharded-cuda` (B1 on the ghost-extended block) for 10x as many,
through `models.lbm.run_simulation_sharded` / `run_simulation` (a warm-up
run, then the timed one). Writes one CSV row per run to
results_ab_sharded.csv beside this file (or --out) and prints each run's
MLUPS by copy, B's median against A's.

Run on a machine with the card, from the repository root:

    git archive PARENT lbm_tpu_torch | tar -x -C build/parent
    python3 experiments/cuda-kstep-tiles/ab_sharded.py --a build/parent --b . \\
        [--steps 1000] [--out FILE]
"""

from __future__ import annotations

import argparse
import csv
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
# this directory holds a profile.py, which would shadow the standard library's
# module that torch.distributed's imports reach
if sys.path and Path(sys.path[0] or ".").resolve() == HERE.parent:
    del sys.path[0]
N = 1024
PHYSICS = dict(reynolds_dim=10, density=0.1, accel=0.01, omega=1.85)
STRATEGIES = ("implicit", "ppermute", "manytensors", "allgather", "naive")


def side(copy: Path, steps: int) -> dict:
    """The runs of one copy, in this process. Returns {run: MLUPS}."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(copy.resolve()))
    from lbm_tpu_torch.core.params import Obstacles, Params
    from lbm_tpu_torch.models import lbm as lbm_model

    mask = np.random.default_rng(20261018).uniform(size=(N, N)) < 0.05
    mask[0] = mask[-1] = True
    obstacles = Obstacles(mask)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", world_size=1,
                                rank=0, device_id=torch.device("cuda", 0))
        try:
            p = Params(nx=N, ny=N, max_iters=steps, **PHYSICS)
            for strategy in STRATEGIES:
                res = lbm_model.run_simulation_sharded(p, obstacles, engine="sharded",
                                                       strategy=strategy, num_devices=1,
                                                       device="cuda")
                out[f"sharded {strategy}"] = N * N * steps / res.compute_seconds / 1e6
            res = lbm_model.run_simulation(p, obstacles, engine="torch", device="cuda")
            out["torch"] = N * N * steps / res.compute_seconds / 1e6
            long = Params(nx=N, ny=N, max_iters=10 * steps, **PHYSICS)
            res = lbm_model.run_simulation_sharded(long, obstacles, engine="sharded-cuda",
                                                   num_devices=1, device="cuda")
            out["sharded-cuda"] = N * N * 10 * steps / res.compute_seconds / 1e6
        finally:
            dist.destroy_process_group()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--a", type=Path, help="the first copy (e.g. build/parent)")
    parser.add_argument("--b", type=Path, help="the second copy (e.g. .)")
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--out", type=Path, default=HERE.parent / "results_ab_sharded.csv")
    parser.add_argument("--side", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.side is not None:
        print(json.dumps(side(args.side, args.steps)))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    rows = []
    for order, (label, copy) in enumerate((("A", args.a), ("B", args.b), ("B", args.b),
                                           ("A", args.a))):
        res = subprocess.run([sys.executable, str(HERE), "--side", str(copy), "--steps",
                              str(args.steps)], capture_output=True, text=True)
        if res.returncode:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return 1
        for run, mlups in json.loads(res.stdout.strip().splitlines()[-1]).items():
            rows.append(dict(order=order, copy=label, dir=str(copy), run=run, mlups=mlups,
                             card=card.strip()))
    with open(args.out, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    for run in dict.fromkeys(r["run"] for r in rows):
        a = [r["mlups"] for r in rows if r["run"] == run and r["copy"] == "A"]
        b = [r["mlups"] for r in rows if r["run"] == run and r["copy"] == "B"]
        print(f"{run}: A {' '.join(f'{x:.1f}' for x in a)}, B {' '.join(f'{x:.1f}' for x in b)}"
              f" MLUPS; B/A {statistics.median(b) / statistics.median(a):.4f}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
