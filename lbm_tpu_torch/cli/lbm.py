"""CLI: run a D2Q9 lattice-Boltzmann simulation with the PyTorch/CUDA port.

Usage:
    python -m lbm_tpu_torch.cli.lbm --params input_1024x1024.params \
        --obstacles obstacles_1024x1024.dat
        [--engine auto|cuda-inplace|cuda|cuda-manual|torch|sharded|sharded-cuda]
        [--dtype float32|float64] [--device cuda|cpu] [--num-steps N] [--out-dir .]
        [--num-devices N] [--strategy implicit|ppermute|manytensors|allgather|naive]
        [--overlap] [--partition-json FILE]
        [--checkpoint-every N] [--checkpoint FILE] [--resume]

The counterpart of `python -m lbm_tpu.cli.lbm` for the main path. Runs on the
CUDA device unless `--device cpu` is given. `--engine auto` takes the fastest
kernel engine whose run fits in the card's free memory: `cuda` (kernel B2),
else `cuda-inplace` (kernel B1, which holds half a lattice less). Writes
av_vels.dat and final_state.dat and prints the `==done==` block. With
--checkpoint-every or --resume the run goes in chunks and writes an atomic
checkpoint after each; a resumed run equals an uninterrupted one bit for bit.

The multi-device engines run on --num-devices ranks of torch.distributed
(default: every GPU on CUDA, 1 on the CPU), which the CLI starts itself (NCCL
on CUDA, gloo on the CPU) unless it runs inside a process group already
(torchrun): `sharded` takes a halo strategy each step, `sharded-cuda` ghost
bands every K steps around kernel B1 (`--overlap`: the row exchange under the
interior kernel). `--partition-json` writes the device partitioning as JSON.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from ..models import lbm as lbm_model

    parser = argparse.ArgumentParser(description="D2Q9 LBM on PyTorch/CUDA")
    parser.add_argument("--params", required=True, help="7-line .params file")
    parser.add_argument("--obstacles", required=True, help="obstacle .dat file")
    parser.add_argument("--engine", default="auto",
                        choices=list(lbm_model.ENGINES + lbm_model.SHARDED_ENGINES),
                        help="compute path: 'cuda' (kernel B2), 'cuda-inplace' (kernel "
                             "B1, in place: half a lattice less memory), 'cuda-manual' "
                             "(kernel B3, B2 through an explicit copy pipeline), 'torch' "
                             "(plain PyTorch) or 'auto' (d2q9_kstep.choose_engine: the "
                             "fastest kernel engine whose run fits in free device memory, "
                             "'cuda' then 'cuda-inplace'; 'torch' on a grid with a side "
                             "under 4); 'sharded' (a halo strategy each step on a mesh of "
                             "ranks) or 'sharded-cuda' (ghost bands every K steps around B1, "
                             "over a row mesh)")
    parser.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--num-steps", type=int, default=None,
                        help="override max_iters from the params file")
    parser.add_argument("--out-dir", default=".")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="ranks of the sharded engines and --partition-json (default: "
                             "every GPU on CUDA, 1 on the CPU)")
    parser.add_argument("--strategy", default=None, choices=list(lbm_model.STRATEGIES),
                        help="halo-exchange strategy of --engine sharded (default ppermute; "
                             "rejected by --engine sharded-cuda unless ppermute)")
    parser.add_argument("--overlap", action="store_true",
                        help="sharded-cuda only: overlap the row-ghost exchange with the "
                             "interior kernel (even row sharding, >= 24 rows a block)")
    parser.add_argument("--partition-json", default=None, metavar="FILE",
                        help="dump the device partitioning as JSON")
    parser.add_argument("--checkpoint-every", type=int, default=None, metavar="N",
                        help="write an atomic state checkpoint every N steps (chunking "
                             "is bit-identical to an uninterrupted run of the same engine)")
    parser.add_argument("--checkpoint", default=None, metavar="FILE",
                        help="checkpoint file (default: <out-dir>/checkpoint.npz)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the checkpoint file if it exists")
    args = parser.parse_args(argv)
    sharded = args.engine in lbm_model.SHARDED_ENGINES
    if args.overlap and args.engine != "sharded-cuda":
        parser.error("--overlap applies to --engine sharded-cuda only")
    if args.overlap and (args.checkpoint_every or args.resume):
        parser.error("--overlap is not supported with checkpointed runs")
    if args.strategy is not None and not sharded:
        parser.error("--strategy applies to --engine sharded only")
    if args.num_devices is not None and not (sharded or args.partition_json):
        parser.error("--num-devices applies to the sharded engines and --partition-json")

    from pathlib import Path

    import torch

    from ..core.params import Obstacles, Params
    from ..parallel import launch

    params = Params.from_file(args.params)
    obstacles = Obstacles.from_file(args.obstacles, params)
    dtype = {"float32": torch.float32, "float64": torch.float64}[args.dtype]
    if args.partition_json:
        from ..parallel import partition

        n = args.num_devices or lbm_model.default_num_devices(
            lbm_model.resolve_device(args.device))
        if launch.is_rank0():
            partition.serialize_to_json(
                partition.partition_for_devices(params.ny, params.nx, n), args.partition_json)
            print(f"wrote {args.partition_json}")
    if args.checkpoint_every or args.resume:
        ck = Path(args.checkpoint or Path(args.out_dir) / "checkpoint.npz")
        lbm_model.resolve_device(args.device)  # before any directory is made
        ck.parent.mkdir(parents=True, exist_ok=True)
        result = lbm_model.run_simulation_with_checkpoints(
            params, obstacles, dtype=dtype, engine=args.engine, checkpoint_path=ck,
            checkpoint_every=args.checkpoint_every or args.num_steps or params.max_iters,
            resume=args.resume, num_steps=args.num_steps, device=args.device,
            strategy=args.strategy, num_devices=args.num_devices)
    elif sharded:
        result = lbm_model.run_simulation_sharded(
            params, obstacles, dtype=dtype, strategy=args.strategy, engine=args.engine,
            num_devices=args.num_devices, num_steps=args.num_steps, overlap=args.overlap,
            device=args.device)
    else:
        result = lbm_model.run_simulation(params, obstacles, dtype=dtype, engine=args.engine,
                                          num_steps=args.num_steps, device=args.device)
    if not launch.is_rank0():
        return 0  # inside a process group (torchrun), rank 0 reports
    print(f"engine:\t\t\t\t{result.engine}")
    lbm_model.print_summary(result)
    av_path, fs_path = lbm_model.write_outputs(result, params, obstacles, args.out_dir)
    print(f"wrote {av_path} and {fs_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
