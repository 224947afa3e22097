"""Whole 2-D jobs through `run_simulation`, on the inputs of the benchmark's
`d2q9-cavity.f32` cell for a seed, reduced to sha256 digests of the final
state and of av_vels: two checkouts run on one card give the same digests
when their results are bit-equal.

    python3 experiments/runner-warm-up/digests.py --root <checkout> --seed N

`--root` is the checkout whose program and benchmark run (default: this
one). Each case runs the cell's grid and mask on one engine and storage
type; the plain `torch` engine runs 200 steps, the others the cell's
20,000. One JSON object a case on standard output.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

# (engine, storage type, steps; None: the cell's)
CASES = [(e, d, None) for d in ("float32", "bfloat16", "float64")
         for e in ("auto", "cuda", "cuda-inplace", "cuda-manual")] + [
    ("torch", "float32", 200), ("auto", "float32", 7), ("auto", "float32", 6)]


def digest(a) -> str:
    import torch

    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy()
    return hashlib.sha256(a.tobytes()).hexdigest()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2])
    parser.add_argument("--seed", type=int, required=True)
    args = parser.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    sys.pycache_prefix = str(root / "build" / "pycache")

    import torch

    from benchmark import harness
    from lbm_tpu_torch.models.lbm import run_simulation

    if Path(harness.__file__).resolve().parents[1] != root:
        raise SystemExit(f"the benchmark was imported from {harness.__file__}, not {root}")
    device = harness.require_devices(1)
    c = harness.cell(harness.load_spec(root), "d2q9-cavity.f32", root)
    job = harness.driver(c.bench, c.config["driver"]).Job(c.config, c.config_dir, c.traffic,
                                                          args.seed, device)
    for engine, dtype, steps in CASES:
        r = run_simulation(job.params, job.obstacles, dtype=getattr(torch, dtype),
                           engine=engine, num_steps=steps, device=device)
        print(json.dumps({"engine": engine, "ran": r.engine, "dtype": dtype,
                          "steps": len(r.av_vels), "state": digest(r.f_final),
                          "av_vels": digest(r.av_vels),
                          "compute_seconds": r.compute_seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
