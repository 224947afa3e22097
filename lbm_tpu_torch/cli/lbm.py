"""CLI: run a D2Q9 lattice-Boltzmann simulation with the PyTorch/CUDA port.

Usage:
    python -m lbm_tpu_torch.cli.lbm --params input_1024x1024.params \
        --obstacles obstacles_1024x1024.dat
        [--engine auto|cuda-inplace|cuda|cuda-manual|torch|native|sharded|sharded-cuda]
        [--dtype float32|float64|bfloat16] [--device cuda|cpu] [--num-steps N] [--out-dir .]
        [--num-devices N] [--strategy implicit|ppermute|manytensors|allgather|naive]
        [--overlap] [--partition-json FILE]
        [--checkpoint-every N] [--checkpoint FILE] [--resume]
        [--compile-only [--export FILE]] [--trace-dir DIR] [--cache-dir DIR]
        [--debug-nans]

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

`--dtype bfloat16` stores the lattice in bfloat16, as the JAX package does:
the kernel engines (`sharded-cuda` too, with and without --overlap) step in
float32 and round the state once a K-step pass, the `torch` and `sharded`
engines round every operation. `native` and --compile-only take float32 and
float64 only.

`--engine native` is the serial C++ engine on the host (native/*.cpp, built
with g++ at first use); it never asks CUDA. The tooling flags, after the
reference's: `--compile-only` exports the plain step (`ops.d2q9.Step`, the
obstacle mask an input) with torch.export on the device and prints its
operation count (no --obstacles needed), `--export FILE` saves it for
`cli.lbm_runner`; `--trace-dir` writes a torch.profiler trace of the run
(DIR/trace.json; on the card it names the kernels), `--cache-dir` builds
the kernels and the native library under DIR/host-<fingerprint>, and
`--debug-nans` checks the state after every launch, step or chunk and raises
FloatingPointError at the first NaN (a synchronisation each time).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from ..models import lbm as lbm_model

    parser = argparse.ArgumentParser(description="D2Q9 LBM on PyTorch/CUDA")
    parser.add_argument("--params", required=True, help="7-line .params file")
    parser.add_argument("--obstacles", default=None,
                        help="obstacle .dat file (not needed with --compile-only: the "
                             "exported step takes the obstacle mask as an input)")
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
                             "over a row mesh); 'native' (the serial C++ engine on the "
                             "host, built with g++ at first use)")
    parser.add_argument("--dtype", default="float32", choices=["float32", "float64", "bfloat16"])
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
    parser.add_argument("--compile-only", action="store_true",
                        help="export the plain step with torch.export on the device and exit "
                             "(no simulation); prints the graph's operation count")
    parser.add_argument("--export", default=None, metavar="FILE",
                        help="with --compile-only: save the exported step for "
                             "lbm_tpu_torch.cli.lbm_runner")
    parser.add_argument("--trace-dir", default=None, metavar="DIR",
                        help="write a torch.profiler trace of the run to DIR/trace.json")
    parser.add_argument("--cache-dir", default=None, metavar="DIR",
                        help="build the CUDA kernels and the native library under "
                             "DIR/host-<fingerprint>")
    parser.add_argument("--debug-nans", action="store_true",
                        help="check the state for NaN after every launch, step or chunk and "
                             "raise FloatingPointError at the first")
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
    if args.export and not args.compile_only:
        parser.error("--export applies to --compile-only")
    if args.obstacles is None and not args.compile_only:
        parser.error("--obstacles is required unless --compile-only")
    if args.dtype == "bfloat16" and args.engine == "native":
        parser.error("--engine native takes float32 or float64")
    if args.dtype == "bfloat16" and args.compile_only:
        parser.error("--compile-only exports a float32 or float64 step")

    import torch

    from ..core.params import Obstacles, Params
    from ..utils import profiling

    params = Params.from_file(args.params)
    dtype = {"float32": torch.float32, "float64": torch.float64,
             "bfloat16": torch.bfloat16}[args.dtype]
    if args.cache_dir:
        print(f"build directory: {profiling.set_build_dir(args.cache_dir)}")
    if args.compile_only:
        return _compile_only(params, dtype, lbm_model.resolve_device(args.device), args.export)
    obstacles = Obstacles.from_file(args.obstacles, params)
    previous = profiling.enable_nan_debugging(True) if args.debug_nans else None
    try:
        return _run(args, params, obstacles, dtype, sharded)
    finally:
        if previous is not None:
            profiling.enable_nan_debugging(previous)


def _compile_only(params, dtype, device, export_path) -> int:
    """--compile-only: export the plain step on `device`; print its
    operation count, and save it to export_path when given."""
    import numpy as np

    from ..core import state
    from ..models import lbm as lbm_model
    from ..ops import d2q9
    from ..utils import profiling

    step = d2q9.Step(params, dtype=dtype, device=device)
    f0, mask = state.to_torch(state.initial_distributions(params, lbm_model.numpy_dtype(dtype)),
                              np.zeros((params.ny, params.nx), bool), device=device)
    with profiling.timed("export"):
        if export_path:
            program, nbytes = profiling.export_step(step, f0, mask, path=export_path)
        else:
            program = profiling.export(step, f0, mask)
    print(f"exported step: ops.d2q9.Step on {device.type}, (9, {params.ny}, {params.nx}) "
          f"{str(dtype).replace('torch.', '')}, {profiling.operation_count(program)} operations")
    if export_path:
        print(f"exported {nbytes} bytes to {export_path}")
    return 0


def _run(args, params, obstacles, dtype, sharded) -> int:
    import contextlib
    from pathlib import Path

    from ..models import lbm as lbm_model
    from ..parallel import launch
    from ..utils import profiling

    # the native engine runs on the host: it never asks CUDA
    device = None if args.engine == "native" else lbm_model.resolve_device(args.device)
    if args.partition_json:
        from ..parallel import partition

        n = args.num_devices or (lbm_model.default_num_devices(device) if device else 1)
        if launch.is_rank0():
            partition.serialize_to_json(
                partition.partition_for_devices(params.ny, params.nx, n), args.partition_json)
            print(f"wrote {args.partition_json}")
    on_card = device is not None and device.type == "cuda"
    trace = (profiling.trace(args.trace_dir, cuda=on_card) if args.trace_dir
             else contextlib.nullcontext())
    with trace:
        if args.checkpoint_every or args.resume:
            ck = Path(args.checkpoint or Path(args.out_dir) / "checkpoint.npz")
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
    if args.trace_dir:
        print(f"wrote {Path(args.trace_dir) / profiling.TRACE_FILE}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
