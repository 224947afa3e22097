"""CLI: run a D2Q9 lattice-Boltzmann simulation with the PyTorch/CUDA port.

Usage:
    python -m lbm_tpu_torch.cli.lbm --params input_1024x1024.params \
        --obstacles obstacles_1024x1024.dat
        [--engine auto|cuda-inplace|cuda|torch] [--dtype float32|float64]
        [--device cuda|cpu] [--num-steps N] [--out-dir .]

The counterpart of `python -m lbm_tpu.cli.lbm` for the main path. Runs on the
CUDA device unless `--device cpu` is given; writes av_vels.dat and
final_state.dat and prints the `==done==` block.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from ..models import lbm as lbm_model

    parser = argparse.ArgumentParser(description="D2Q9 LBM on PyTorch/CUDA")
    parser.add_argument("--params", required=True, help="7-line .params file")
    parser.add_argument("--obstacles", required=True, help="obstacle .dat file")
    parser.add_argument("--engine", default="auto", choices=list(lbm_model.ENGINES),
                        help="compute path: 'cuda-inplace' (kernel B1), 'cuda' "
                             "(kernel B2), 'torch' (plain PyTorch) or 'auto' "
                             "(d2q9_kstep.choose_engine)")
    parser.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--num-steps", type=int, default=None,
                        help="override max_iters from the params file")
    parser.add_argument("--out-dir", default=".")
    args = parser.parse_args(argv)

    import torch

    from ..core.params import Obstacles, Params

    params = Params.from_file(args.params)
    obstacles = Obstacles.from_file(args.obstacles, params)
    dtype = {"float32": torch.float32, "float64": torch.float64}[args.dtype]
    result = lbm_model.run_simulation(params, obstacles, dtype=dtype, engine=args.engine,
                                      num_steps=args.num_steps, device=args.device)
    print(f"engine:\t\t\t\t{result.engine}")
    lbm_model.print_summary(result)
    av_path, fs_path = lbm_model.write_outputs(result, params, obstacles, args.out_dir)
    print(f"wrote {av_path} and {fs_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
