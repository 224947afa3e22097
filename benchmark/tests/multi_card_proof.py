"""The proof runs of the harness at sizes a CPU test cannot hold: cells in a
copied root, not cells of BENCHMARK.json.

    python3 benchmark/tests/multi_card_proof.py --proof cards4 --out <dir> \
        --seeds <n> ... [--traced-seeds <n> ...] [--idle-seed <n>] [--raise-seed <n>]
    python3 benchmark/tests/multi_card_proof.py --proof card-filling --out <dir> \
        --seeds <n> ... [--altered-seed <n>]

It copies BENCHMARK.json, benchmark/ and lbm_tpu_torch/ into
`<repo>/_proof/root` and adds there, with `conftest.ranks_cell` (the test
driver `drivers/d3q19_ranks_job.py`, d3q19-channel.f32's limits), its cells.

`cards4`, on four cards, SIZE^3 and STEPS steps:
  * `proof-d3q19.4chip`: `ops.d3q19.simulate(engine="sharded-cuda",
    num_devices=4)` over the four ranks of the harness's group, each rank
    returning and replaying its own z-slab; each rank's first answer is
    saved, and after the run the slabs put together are compared here with
    one replay of the whole domain (`reference.d3q19.solve`): its gaps are
    printed beside the run's;
  * `proof-d3q19.idle`: the same job on each card alone (`cuda-inplace`,
    replicas), rank 3's answer made in set-up and its card left idle in the
    window: the run has to be refused;
  * `proof-d3q19.raise`: `proof-d3q19.4chip` with rank 2 raising in its
    first job: the run has to end, with no result.
`card-filling`, on one card, FILL_SHAPE (the z-slab of a card of a
2048x1024x1024 grid on four cards, 40.8 GB in float32) and FILL_STEPS
steps, a job through `ops.d3q19.advance(engine="cuda-inplace")` from a
start state built on the card, judged by the last-state-only rule:
  * `proof-d3q19-fill.1chip`: for each seed;
  * `proof-d3q19-fill.first`, `.last`: for the altered seed, a value altered
    in the first, and in the second, of the FILL_SECONDS window's two jobs:
    both runs have to be not correct.
Each run is `benchmark/run.py` in that root, one at a time, and prints one
JSON line: its exit code, seconds, and its result's line (or none). Each
run's standard output and error are kept under --out.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

from conftest import REPO, ranks_cell

SIZE, STEPS, SECONDS = 256, 800, 10
FILL_SHAPE, FILL_STEPS = (512, 1024, 1024), 400
# a window that holds two jobs of card-filling: a job is 12.6 s on an H100, and
# two jobs start where one takes 9.5-19 s
FILL_SECONDS = 19


def make_root(proof: str) -> Path:
    root = REPO / "_proof" / "root"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copytree(REPO / "lbm_tpu_torch", root / "lbm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root)
    if proof == "cards4":
        size = dict(nz=SIZE, ny=SIZE, nx=SIZE, steps=STEPS)
        ranks_cell(root, "proof-d3q19.4chip", 4, engine="sharded-cuda",
                   dump=str(root / "dump"), **size)
        ranks_cell(root, "proof-d3q19.idle", 4, engine="cuda-inplace",
                   fault={"kind": "idle", "rank": 3}, **size)
        ranks_cell(root, "proof-d3q19.raise", 4, engine="sharded-cuda",
                   fault={"kind": "raise", "rank": 2}, **size)
    else:
        nz, ny, nx = FILL_SHAPE
        fill = dict(engine="cuda-inplace", nz=nz, ny=ny, nx=nx, steps=FILL_STEPS,
                    last_state_only=True)
        ranks_cell(root, "proof-d3q19-fill.1chip", 1, **fill)
        for name, job in (("first", 0), ("last", 1)):
            ranks_cell(root, f"proof-d3q19-fill.{name}", 1,
                       fault={"kind": "alter", "rank": 0, "job": job}, **fill)
    return root


def whole_replay_gaps(root: Path, cell: str, seed: int) -> dict:
    """The gaps of the slabs that the ranks saved, put together, against one
    replay of the whole domain on the first card."""
    import numpy as np
    import torch

    sys.path.insert(0, str(root))
    from benchmark import harness
    from benchmark.reference import compare, d3q19

    c = harness.cell(harness.load_spec(root), cell, root)
    drv = harness.driver(c.bench, c.config["driver"])
    job = drv.Job(c.config, c.config_dir, c.traffic, seed, torch.device("cuda", 0))
    parts = [np.load(root / "dump" / f"rank{r}.npz") for r in range(4)]
    f0 = drv.rest_state((19, *job.shape), job.kw["density"], job.dtype, job.device)
    ref_f, ref_av = d3q19.solve(f0, job.mask, steps=job.steps, storage=job.dtype,
                                store_every=job.store_every, device=job.device, **job.kw)
    gaps = compare.gaps(np.concatenate([p["f"] for p in parts], axis=1), parts[0]["av"],
                        ref_f, ref_av, job.speed, job.obstacle())
    del ref_f, ref_av, f0, job
    torch.cuda.empty_cache()
    return gaps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--proof", choices=("cards4", "card-filling"), required=True)
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--traced-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--idle-seed", type=int)
    parser.add_argument("--raise-seed", type=int)
    parser.add_argument("--altered-seed", type=int)
    args = parser.parse_args()
    out = args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    root = make_root(args.proof)
    if args.proof == "cards4":
        runs = ([("proof-d3q19.4chip", s, 0, SECONDS) for s in args.seeds]
                + [("proof-d3q19.4chip", s, 1, SECONDS) for s in args.traced_seeds]
                + [(cell, s, 0, SECONDS) for cell, s in (("proof-d3q19.idle", args.idle_seed),
                                                         ("proof-d3q19.raise", args.raise_seed))
                   if s is not None])
    else:
        runs = ([("proof-d3q19-fill.1chip", s, 0, FILL_SECONDS) for s in args.seeds]
                + [(f"proof-d3q19-fill.{name}", args.altered_seed, 0, FILL_SECONDS)
                   for name in ("first", "last") if args.altered_seed is not None])
    for cell, seed, trace, seconds in runs:
        shutil.rmtree(root / "dump", ignore_errors=True)
        (root / "dump").mkdir()
        t0 = time.monotonic()
        proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                               str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                              cwd=root, capture_output=True, text=True, timeout=1500)
        stem = f"{cell}.{seed}.trace{trace}"
        (out / f"{stem}.out").write_text(proc.stdout)
        (out / f"{stem}.err").write_text(proc.stderr)
        lines = proc.stdout.strip().splitlines()
        result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
        line = {"cell": cell, "seed": seed, "trace": trace, "rc": proc.returncode,
                "seconds": time.monotonic() - t0, "result": result}
        if cell == "proof-d3q19.4chip" and result is not None:
            line["whole_replay_gaps"] = whole_replay_gaps(root, cell, seed)
        print(json.dumps(line), flush=True)
        if result is None:
            print("\n".join(proc.stderr.splitlines()[-12:]), file=sys.stderr, flush=True)
    shutil.rmtree(root / "dump", ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
