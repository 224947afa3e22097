"""CLI: run a D2Q9 step exported by `cli.lbm --compile-only --export`.

The counterpart of `python -m lbm_tpu.cli.lbm_runner`: the second half of the
compile-then-run split (the reference's lbm_poplibs serialises an executable
and lbm_runner runs it, main/LbmRunner.cpp). The exported step is the plain
step, `ops.d2q9.Step`, with the obstacle mask as an input, so one file
serves any obstacle file of its grid. The runner first-accelerates the
state as every engine does, runs num_steps steps of the loaded program in a
loop on the device, timed by CUDA events (the host's clock on the CPU) after
a warm-up run, and writes av_vels.dat and final_state.dat.

An exported program is specialised to its grid, type and device: a params
file of another grid, or a device other than the one it was exported on, is
refused. Its results equal `cli.lbm --engine torch` on the same device bit
for bit.

Usage:
    python -m lbm_tpu_torch.cli.lbm_runner --exe step.pt2 \
        --params input.params --obstacles obstacles.dat
        [--num-steps N] [--device cuda|cpu] [--out-dir .]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="run an exported D2Q9 step")
    parser.add_argument("--exe", required=True, help="exported step (cli.lbm --export)")
    parser.add_argument("--params", required=True)
    parser.add_argument("--obstacles", required=True)
    parser.add_argument("--num-steps", type=int, default=None,
                        help="override max_iters from the params file")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--out-dir", default=".")
    args = parser.parse_args(argv)

    import dataclasses
    import time

    import numpy as np
    import torch

    from ..core import state
    from ..core.params import Obstacles, Params, reynolds_number
    from ..models import lbm as lbm_model
    from ..ops import d2q9
    from ..utils import profiling

    device = lbm_model.resolve_device(args.device)
    params = Params.from_file(args.params)
    if args.num_steps is not None:
        params = dataclasses.replace(params, max_iters=args.num_steps)
    program = profiling.load_step(args.exe)
    specs = list(profiling.input_specs(program).values())
    if len(specs) != 2:
        parser.error(f"{args.exe} takes {len(specs)} inputs, not (f, mask): not an exported step")
    (shape, dtype, exe_device), _ = specs
    if shape != (9, params.ny, params.nx):
        parser.error(f"{args.exe} was exported for a (9, ny, nx) = {shape} state, and "
                     f"{args.params} is a {params.ny}x{params.nx} grid: export the step for "
                     "this grid")
    if exe_device.type != device.type:
        parser.error(f"{args.exe} was exported on {exe_device.type} and this run is on "
                     f"{device.type}: export it with --device {device.type}")
    obstacles = Obstacles.from_file(args.obstacles, params)

    step = program.module()
    f0, mask = state.to_torch(state.initial_distributions(params, lbm_model.numpy_dtype(dtype)),
                              obstacles.mask, device=device)
    aw = d2q9.AccelWeights.from_params(params)
    f0 = d2q9.first_accelerate(f0, mask, accel_row=params.ny - 2, accel_w1=aw.w1,
                               accel_w2=aw.w2)

    def run():
        f, tots = f0, []
        for _ in range(params.max_iters):
            f, tot = step(f, mask)
            tots.append(tot)
        return f, torch.stack(tots) if tots else f.new_zeros(0)

    run()[1].cpu()  # warm-up
    with profiling.timed_run():
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f_final, tot = run()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            f_final, tot = run()
            seconds = time.perf_counter() - t0

    # divided in the state's type, as every engine's simulate does
    av = (tot / (~mask).sum().to(tot.dtype)).cpu().numpy().astype(np.float64)
    f_np = f_final.cpu().numpy()
    result = lbm_model.LbmResult(
        f_final=f_np, av_vels=av, compute_seconds=seconds,
        reynolds=reynolds_number(params, float(av[-1])) if av.size else float("nan"),
        total_density=state.total_density(f_np), engine="exported step")
    print(f"engine:\t\t\t\texported step ({args.exe})")
    lbm_model.print_summary(result)
    av_path, fs_path = lbm_model.write_outputs(result, params, obstacles, args.out_dir)
    print(f"wrote {av_path} and {fs_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
