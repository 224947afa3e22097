"""CLI: CSV sampler of partition quality over random grid sizes.

The counterpart of `python -m lbm_tpu.cli.partition_stats`, on the port's
`parallel/partition.py` and `parallel/mesh.best_factorisation`; for the same
seed and device counts its output is byte-identical to it. The analogue of
the reference's tile_mapping_stats (main/TileMappingStats.cpp:50-101):
samples random grid shapes, partitions each over the requested device
counts, and emits one CSV row per sample with load-balance metrics. Runs on
the host alone (numpy; no process group).

Usage:
    python -m lbm_tpu_torch.cli.partition_stats --samples 100 --devices 1,4,8 \
        [--seed 0] [-o stats.csv]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..parallel import mesh as mesh_lib, partition


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="partition quality sampler")
    parser.add_argument("--samples", type=int, default=100)
    parser.add_argument("--devices", default="1,2,4,8",
                        help="comma-separated device counts")
    parser.add_argument("--min-size", type=int, default=64)
    parser.add_argument("--max-size", type=int, default=4096)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("-o", "--output", default="-")
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    device_counts = [int(d) for d in args.devices.split(",")]

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    out.write("ny,nx,num_devices,mesh_rows,mesh_cols,targets,"
              "load_balance,max_speedup,halo_cells_per_interior,"
              "wasted_targets,wasted_lane_cells,lane_utilisation\n")
    for _ in range(args.samples):
        ny = int(rng.integers(args.min_size, args.max_size))
        nx = int(rng.integers(args.min_size, args.max_size))
        for n in device_counts:
            try:
                r, c = mesh_lib.best_factorisation(n, ny, nx, require_even=False)
            except ValueError:
                continue
            part = partition.partition_for_devices(ny, nx, n)
            st = partition.stats(part)
            halo_ratio = (1.0 / (ny / r) + 1.0 / (nx / c))
            out.write(f"{ny},{nx},{n},{r},{c},{st.num_targets},"
                      f"{st.load_balance:.4f},{st.max_speedup:.3f},"
                      f"{halo_ratio:.6f},{st.wasted_targets},"
                      f"{st.wasted_lane_cells},{st.lane_utilisation:.4f}\n")
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
