"""CLI: benchmark the halo-exchange strategies over a mesh of ranks.

The counterpart of `python -m lbm_tpu.cli.halo_bench` (the analogue of the
reference's halo_regions micro-benchmark, main/HaloRegionApproaches.cpp),
on `parallel/halo.py`: each strategy runs the full simulation through
`halo.simulate_sharded` once to warm up, then once timed, on --num-devices
ranks of torch.distributed that the CLI starts itself (NCCL on CUDA, rank r
on GPU r; gloo on the CPU), or on those of the process group it runs in.
The timed run follows a barrier and is timed on rank 0: by CUDA events on
the card, by the host's clock on the CPU. Strategies:

  implicit    — the global step on a DTensor state (PyTorch's collectives)
  ppermute    — explicit two-wave neighbour exchange
  manytensors — ghost-extended blocks updated by 8 per-direction sends
  allgather   — boundary rows/cols all-gathered (the deliberately heavy one)
  naive       — every edge and corner its own serialised collective

Emits CSV rows: strategy,platform,devices,mesh,grid,iters,seconds,mlups
(platform: cuda or cpu).

Usage:
    python -m lbm_tpu_torch.cli.halo_bench --ny 1024 --nx 1024 -n 200 \
        [--strategies implicit,ppermute,manytensors,allgather,naive]
        [--num-devices N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

HEADER = "strategy,platform,devices,mesh,grid,iters,seconds,mlups"


def bench_rank(ny: int, nx: int, num_iters: int, strategies: list[str]) -> list[str]:
    """The body of the bench on each rank: one warm-up and one timed run a
    strategy. Returns the CSV rows (rank 0's timings)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..core import state
    from ..core.params import Params
    from ..parallel import halo, launch, mesh as mesh_lib

    n = dist.get_world_size()
    mesh = mesh_lib.make_mesh(n, ny, nx)
    r, c = mesh.shape
    p = Params(nx=nx, ny=ny, max_iters=num_iters, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    f0 = state.initial_distributions(p, np.float32)
    mask = np.zeros((ny, nx), bool)
    mask[0, :] = True
    platform = mesh_lib.device_type()
    rows = []
    for strategy in strategies:
        halo.simulate_sharded(p, f0, mask, mesh, strategy=strategy)[1].cpu()  # warm-up
        dist.barrier()
        if platform == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            halo.simulate_sharded(p, f0, mask, mesh, strategy=strategy)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            halo.simulate_sharded(p, f0, mask, mesh, strategy=strategy)[1].cpu()
            seconds = time.perf_counter() - t0
        mlups = num_iters * nx * ny / seconds / 1e6
        rows.append(f"{strategy},{platform},{n},{r}x{c},{ny}x{nx},{num_iters},"
                    f"{seconds:.4f},{mlups:.1f}")
    return rows if launch.is_rank0() else []


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="halo-exchange strategy bench")
    parser.add_argument("--ny", type=int, default=1024)
    parser.add_argument("--nx", type=int, default=1024)
    parser.add_argument("-n", "--num-iters", type=int, default=200)
    parser.add_argument("--num-devices", type=int, default=None,
                        help="ranks (default: every GPU on CUDA, 1 on the CPU)")
    parser.add_argument("--strategies", default="implicit,ppermute,manytensors,allgather,naive")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from ..models import lbm as lbm_model
    from ..parallel import launch
    from . import halo_bench  # the rank body by its import path, also when run as __main__

    strategies = args.strategies.split(",")
    unknown = sorted(set(strategies) - set(lbm_model.STRATEGIES))
    if unknown:
        parser.error(f"unknown strategies {unknown}; choose from {lbm_model.STRATEGIES}")
    device = lbm_model.resolve_device(args.device)
    n = args.num_devices or lbm_model.default_num_devices(device)
    rows = launch.run(halo_bench.bench_rank, n, args.ny, args.nx, args.num_iters, strategies,
                      device_type=device.type)
    if launch.is_rank0():
        sys.stdout.write("\n".join([HEADER, *rows]) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
