"""The first runs of the harness across cards: a proof cell on four cards in
a copied root, not a cell of BENCHMARK.json (a domain that one card holds is
no ground for a four-card cell).

    python3 benchmark/tests/multi_card_proof.py --out <dir> \
        --seeds <n> <n> [--traced-seeds <n> ...] [--idle-seed <n>] [--raise-seed <n>]

It copies BENCHMARK.json, benchmark/ and lbm_tpu_torch/ into
`<repo>/_proof/root` and adds there, with `conftest.ranks_cell` (the test
driver `drivers/d3q19_ranks_job.py`, d3q19-channel.f32's limits), three cells
of SIZE^3 and STEPS steps on four ranks:
  * `proof-d3q19.4chip`: `ops.d3q19.simulate(engine="sharded-cuda",
    num_devices=4)` over the four ranks of the harness's group, each rank
    returning its z-slab;
  * `proof-d3q19.idle`: the same job on each card alone (`cuda-inplace`,
    replicas), rank 3's answer made in set-up and its card left idle in the
    window: the run has to be refused;
  * `proof-d3q19.raise`: `proof-d3q19.4chip` with rank 2 raising in its
    first job: the run has to end, with no result.
Then it runs `benchmark/run.py` there for SECONDS for each seed (untraced),
each traced seed and the idle and raise seeds, one run at a time, and prints
one JSON line a run: its exit code, seconds, and its result's line (or
none). Each run's standard output and error are kept under --out.
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


def make_root() -> Path:
    root = REPO / "_proof" / "root"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copytree(REPO / "lbm_tpu_torch", root / "lbm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root)
    size = dict(nz=SIZE, ny=SIZE, nx=SIZE, steps=STEPS)
    ranks_cell(root, "proof-d3q19.4chip", 4, engine="sharded-cuda", **size)
    ranks_cell(root, "proof-d3q19.idle", 4, engine="cuda-inplace",
               fault={"kind": "idle", "rank": 3}, **size)
    ranks_cell(root, "proof-d3q19.raise", 4, engine="sharded-cuda",
               fault={"kind": "raise", "rank": 2}, **size)
    return root


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--traced-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--idle-seed", type=int)
    parser.add_argument("--raise-seed", type=int)
    args = parser.parse_args()
    out = args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    root = make_root()
    runs = ([("proof-d3q19.4chip", s, 0) for s in args.seeds]
            + [("proof-d3q19.4chip", s, 1) for s in args.traced_seeds]
            + ([("proof-d3q19.idle", args.idle_seed, 0)] if args.idle_seed is not None else [])
            + ([("proof-d3q19.raise", args.raise_seed, 0)] if args.raise_seed is not None else []))
    for cell, seed, trace in runs:
        t0 = time.monotonic()
        proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                               str(seed), "--seconds", str(SECONDS), "--trace", str(trace)],
                              cwd=root, capture_output=True, text=True, timeout=1500)
        stem = f"{cell}.{seed}.trace{trace}"
        (out / f"{stem}.out").write_text(proc.stdout)
        (out / f"{stem}.err").write_text(proc.stderr)
        lines = proc.stdout.strip().splitlines()
        result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
        print(json.dumps({"cell": cell, "seed": seed, "trace": trace, "rc": proc.returncode,
                          "seconds": time.monotonic() - t0, "result": result}), flush=True)
        if result is None:
            print("\n".join(proc.stderr.splitlines()[-12:]), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
