"""CLI: run a D3Q19 3-D lattice-Boltzmann simulation with the PyTorch/CUDA
port.

Lid-driven-style cavity with an accelerated plane at z = nz-2 and wall planes
at z = 0 and z = nz-1.

Usage:
    python -m lbm_tpu_torch.cli.lbm3d --nz 64 --ny 128 --nx 256 -n 1200
        [--omega 1.85] [--density 0.1] [--accel 0.005]
        [--engine cuda-inplace|cuda|cuda-inplace-blocked|cuda-blocked|torch]
        [--dtype float32|float64]
        [--device cuda|cpu] [--out-dir .]
        [--checkpoint-every N] [--checkpoint FILE] [--resume]
        [--final-state-slice Z|mid]

The counterpart of `python -m lbm_tpu.cli.lbm3d` on one device. Runs on the
CUDA device unless `--device cpu` is given. The default engine is
'cuda-inplace', the counterpart of the reference's fastest single-chip engine
('pallas-inplace'): one lattice in memory, through kernel B4 (one launch per
step, the 'slab' kind) or B5 (K steps of every tile per trip, the 'blocked'
kind), whichever `pick_engine` names for the shape. 'cuda' is the two-stream
pair B6 / B7 chosen the same way; 'cuda-inplace-blocked' and 'cuda-blocked'
run B5 and B7 whatever the rule says, as passing `by=` does in the
reference; 'torch' is the plain PyTorch engine. Writes av_vels_3d.dat and
prints the engine, the kind of kernel and its K, then the `==done==` block.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="D3Q19 LBM on PyTorch/CUDA")
    parser.add_argument("--nz", type=int, default=32)
    parser.add_argument("--ny", type=int, default=64)
    parser.add_argument("--nx", type=int, default=128)
    parser.add_argument("-n", "--num-steps", type=int, default=1000)
    parser.add_argument("--omega", type=float, default=1.85)
    parser.add_argument("--density", type=float, default=0.1)
    parser.add_argument("--accel", type=float, default=0.005)
    parser.add_argument("--engine", default="cuda-inplace",
                        choices=["torch", "cuda", "cuda-inplace", "cuda-blocked",
                                 "cuda-inplace-blocked"],
                        help="compute path: 'cuda-inplace' (one lattice in memory: kernel "
                             "B4 or B5 as pick_engine names), 'cuda' (two-stream: B6 or "
                             "B7), 'cuda-inplace-blocked' (B5), 'cuda-blocked' (B7) or "
                             "'torch' (plain PyTorch)")
    parser.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--out-dir", default=".")
    parser.add_argument("--checkpoint-every", type=int, default=None, metavar="N",
                        help="write an atomic state checkpoint every N steps (chunking "
                             "is bit-identical to an uninterrupted run)")
    parser.add_argument("--checkpoint", default=None, metavar="FILE",
                        help="checkpoint file (default: <out-dir>/checkpoint_3d.npz)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the checkpoint file if it exists")
    parser.add_argument("--final-state-slice", default=None, metavar="Z",
                        help="also write plane z=Z (or 'mid') in the exact 2-D "
                             "final_state.dat format")
    args = parser.parse_args(argv)

    import time
    from pathlib import Path

    import numpy as np
    import torch

    from ..core import io
    from ..models import lbm3d as lbm3d_model
    from ..models.lbm import resolve_device
    from ..ops import d3q19

    device = resolve_device(args.device)
    dtype = {"float32": torch.float32, "float64": torch.float64}[args.dtype]
    cells = args.nz * args.ny * args.nx
    out = Path(args.out_dir)
    chunk = args.checkpoint_every or args.num_steps
    kernel_line = None
    if args.engine != "torch":
        _, kind, k_steps, _ = d3q19.resolve_engine(
            args.engine, args.nz, args.ny, args.nx, (args.num_steps, chunk), dtype=dtype,
            device=device)
        kernel_line = f"{kind}, {k_steps} step{'s' if k_steps > 1 else ''} per pass"
    if args.checkpoint_every or args.resume:
        ck = Path(args.checkpoint or out / "checkpoint_3d.npz")
        ck.parent.mkdir(parents=True, exist_ok=True)
        f_final, av_np, dt, steps_run = lbm3d_model.run_simulation_with_checkpoints(
            args.nz, args.ny, args.nx, num_steps=args.num_steps, checkpoint_path=ck,
            checkpoint_every=chunk,
            omega=args.omega, density=args.density, accel=args.accel, dtype=dtype,
            engine=args.engine, resume=args.resume, device=device)
        # dt covers the steps executed by this invocation, the checkpoint
        # writes and (on the card) the kernels' build and load
        time_label = "Time (this run, incl. checkpoints)"
        mlups = steps_run * cells / dt / 1e6 if steps_run else 0.0
        if not steps_run:
            print(f"checkpoint already at step {args.num_steps}: nothing to run")
    else:
        f0, mask = d3q19.initial_state(args.nz, args.ny, args.nx, density=args.density,
                                       dtype=dtype, device=device)
        kw = dict(num_steps=args.num_steps, omega=args.omega, density=args.density,
                  accel=args.accel, engine=args.engine)
        # warm-up run (kernel build and load) outside the timed one; each run
        # gets its own copy of the state, which cuda-inplace overwrites
        _, av = d3q19.advance(f0.clone(), mask, **kw)
        av.cpu()
        f = f0.clone()
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            f_final, av = d3q19.advance(f, mask, **kw)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            f_final, av = d3q19.advance(f, mask, **kw)
            dt = time.perf_counter() - t0
        av_np = av.cpu().numpy().astype(np.float64)
        f_final = f_final.cpu().numpy()
        time_label = "Total compute time"
        mlups = args.num_steps * cells / dt / 1e6

    print(f"engine:\t\t\t{args.engine}")
    if kernel_line:
        print(f"kernel:\t\t\t{kernel_line}")
    print("==done==")
    print(f"Final mean |u|:\t\t{av_np[-1]:.12E}")
    print(f"{time_label}:\t{dt:.6f} (s)")
    print(f"Total density:\t\t{float(f_final.sum(dtype=np.float64)):.6E}")
    print(f"MLUPS:\t\t\t{mlups:.1f}")

    out.mkdir(parents=True, exist_ok=True)
    io.write_av_vels(out / "av_vels_3d.dat", av_np)
    print(f"wrote {out / 'av_vels_3d.dat'}")
    if args.final_state_slice is not None:
        z = args.nz // 2 if args.final_state_slice == "mid" else int(args.final_state_slice)
        mask = d3q19.default_obstacle_mask(args.nz, args.ny, args.nx)
        fs = out / f"final_state_3d_z{z}.dat"
        lbm3d_model.write_final_state_slice(fs, f_final, mask, z, args.density)
        print(f"wrote {fs}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
