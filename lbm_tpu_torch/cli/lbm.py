"""CLI: run a D2Q9 lattice-Boltzmann simulation with the PyTorch/CUDA port.

Usage:
    python -m lbm_tpu_torch.cli.lbm --params input_1024x1024.params \
        --obstacles obstacles_1024x1024.dat
        [--engine auto|cuda-inplace|cuda|cuda-manual|torch] [--dtype float32|float64]
        [--device cuda|cpu] [--num-steps N] [--out-dir .]
        [--checkpoint-every N] [--checkpoint FILE] [--resume]

The counterpart of `python -m lbm_tpu.cli.lbm` for the main path. Runs on the
CUDA device unless `--device cpu` is given. `--engine auto` takes the fastest
kernel engine whose run fits in the card's free memory: `cuda` (kernel B2),
else `cuda-inplace` (kernel B1, which holds half a lattice less). Writes
av_vels.dat and final_state.dat and prints the `==done==` block. With
--checkpoint-every or --resume the run goes in chunks and writes an atomic
checkpoint after each; a resumed run equals an uninterrupted one bit for bit.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from ..models import lbm as lbm_model

    parser = argparse.ArgumentParser(description="D2Q9 LBM on PyTorch/CUDA")
    parser.add_argument("--params", required=True, help="7-line .params file")
    parser.add_argument("--obstacles", required=True, help="obstacle .dat file")
    parser.add_argument("--engine", default="auto", choices=list(lbm_model.ENGINES),
                        help="compute path: 'cuda' (kernel B2), 'cuda-inplace' (kernel "
                             "B1, in place: half a lattice less memory), 'cuda-manual' "
                             "(kernel B3, B2 through an explicit copy pipeline), 'torch' "
                             "(plain PyTorch) or 'auto' (d2q9_kstep.choose_engine: the "
                             "fastest kernel engine whose run fits in free device memory, "
                             "'cuda' then 'cuda-inplace'; 'torch' on a grid with a side "
                             "under 4)")
    parser.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--num-steps", type=int, default=None,
                        help="override max_iters from the params file")
    parser.add_argument("--out-dir", default=".")
    parser.add_argument("--checkpoint-every", type=int, default=None, metavar="N",
                        help="write an atomic state checkpoint every N steps (chunking "
                             "is bit-identical to an uninterrupted run of the same engine)")
    parser.add_argument("--checkpoint", default=None, metavar="FILE",
                        help="checkpoint file (default: <out-dir>/checkpoint.npz)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the checkpoint file if it exists")
    args = parser.parse_args(argv)

    from pathlib import Path

    import torch

    from ..core.params import Obstacles, Params

    params = Params.from_file(args.params)
    obstacles = Obstacles.from_file(args.obstacles, params)
    dtype = {"float32": torch.float32, "float64": torch.float64}[args.dtype]
    if args.checkpoint_every or args.resume:
        ck = Path(args.checkpoint or Path(args.out_dir) / "checkpoint.npz")
        lbm_model.resolve_device(args.device)  # before any directory is made
        ck.parent.mkdir(parents=True, exist_ok=True)
        result = lbm_model.run_simulation_with_checkpoints(
            params, obstacles, dtype=dtype, engine=args.engine, checkpoint_path=ck,
            checkpoint_every=args.checkpoint_every or args.num_steps or params.max_iters,
            resume=args.resume, num_steps=args.num_steps, device=args.device)
    else:
        result = lbm_model.run_simulation(params, obstacles, dtype=dtype, engine=args.engine,
                                          num_steps=args.num_steps, device=args.device)
    print(f"engine:\t\t\t\t{result.engine}")
    lbm_model.print_summary(result)
    av_path, fs_path = lbm_model.write_outputs(result, params, obstacles, args.out_dir)
    print(f"wrote {av_path} and {fs_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
