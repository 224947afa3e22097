"""CLI: run a D3Q19 3-D lattice-Boltzmann simulation with the PyTorch/CUDA
port.

Lid-driven-style cavity with an accelerated plane at z = nz-2 and wall planes
at z = 0 and z = nz-1.

Usage:
    python -m lbm_tpu_torch.cli.lbm3d --nz 64 --ny 128 --nx 256 -n 1200
        [--omega 1.85] [--density 0.1] [--accel 0.005]
        [--engine cuda-inplace|cuda|cuda-inplace-blocked|cuda-blocked|torch
                  |native|sharded-cuda|sharded-cuda-zy|sharded]
        [--num-devices N] [--overlap] [--mesh-shape NZ NY]
        [--dtype float32|float64]
        [--device cuda|cpu] [--out-dir .]
        [--checkpoint-every N] [--checkpoint FILE] [--resume]
        [--final-state-slice Z|mid]

The counterpart of `python -m lbm_tpu.cli.lbm3d` on one device. Runs on the
CUDA device unless `--device cpu` is given. The default engine is
'cuda-inplace', the counterpart of the reference's fastest single-chip engine
('pallas-inplace'): one lattice in memory, through kernel B4 (K steps a
pass, the 'slab' kind). 'cuda' is its two-stream twin B6;
'cuda-inplace-blocked' and 'cuda-blocked' run the blocked kernels B5 and B7
(K steps of every tile per trip, the 'blocked' kind), which run only when
named, as passing `by=` does in the reference (`ops.d3q19.resolve_engine`);
'torch' is the plain PyTorch engine; 'native' the serial C++
engine on the host (built with g++ at first use; it never asks CUDA, so it
runs without --device cpu). Writes av_vels_3d.dat and
prints the engine, the kind of kernel and its K, then the `==done==` block.

The multi-device engines run on --num-devices ranks of torch.distributed
(default: every GPU on CUDA, 1 on the CPU), which the CLI starts itself (NCCL
on CUDA, gloo on the CPU) unless it runs inside a process group already
(torchrun), where rank 0 alone reports: 'sharded-cuda' exchanges K ghost
planes every K steps around kernel B4 over a z-mesh (`--overlap`: the
exchange under an interior kernel; even z sharding, >= 3K planes a shard),
'sharded-cuda-zy' ghost planes and rows on a (z, y) mesh (`--mesh-shape NZ
NY`, uneven nz and ny by pad-and-mask), 'sharded' the plain step on a
DTensor sharded over z and y (even splits only). Checkpointing takes
'sharded-cuda' (fused exchange) among them, as the reference does.
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
                                 "cuda-inplace-blocked", "native", "sharded", "sharded-cuda",
                                 "sharded-cuda-zy"],
                        help="compute path: 'cuda-inplace' (one lattice in memory: kernel "
                             "B4), 'cuda' (two-stream: B6), 'cuda-inplace-blocked' (B5), "
                             "'cuda-blocked' (B7), "
                             "'torch' (plain PyTorch), 'native' (the serial C++ engine on "
                             "the host); on a mesh of ranks 'sharded-cuda' "
                             "(ghost planes around B4 over z), 'sharded-cuda-zy' (a (z, y) "
                             "mesh, see --mesh-shape) or 'sharded' (the plain step on a "
                             "DTensor)")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="ranks of the multi-device engines (default: every GPU on "
                             "CUDA, 1 on the CPU)")
    parser.add_argument("--overlap", action="store_true",
                        help="sharded-cuda only: overlap the ghost-plane exchange with the "
                             "interior kernel (even z sharding, >= 3K planes a shard)")
    parser.add_argument("--mesh-shape", type=int, nargs=2, default=None, metavar=("NZ", "NY"),
                        help="sharded-cuda-zy only: ranks along the z and y mesh axes "
                             "(default: factorised over all ranks)")
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
    sharded = args.engine in ("sharded", "sharded-cuda", "sharded-cuda-zy")
    checkpointed = args.checkpoint_every or args.resume
    if args.overlap and args.engine != "sharded-cuda":
        parser.error("--overlap applies to --engine sharded-cuda only")
    if args.mesh_shape is not None and args.engine != "sharded-cuda-zy":
        parser.error("--mesh-shape applies to --engine sharded-cuda-zy only")
    if args.num_devices is not None and not sharded:
        parser.error("--num-devices applies to the multi-device engines only")
    if checkpointed and args.engine == "sharded-cuda-zy":
        parser.error("--checkpoint-every/--resume support the single-device engines and "
                     "sharded-cuda (use the z-mesh sharded-cuda engine for checkpointed runs)")
    if checkpointed and args.engine == "sharded":
        parser.error("--checkpoint-every/--resume support the single-device engines and "
                     "sharded-cuda (the implicit 'sharded' engine has no chunked runner: "
                     "use sharded-cuda)")
    if checkpointed and args.overlap:
        parser.error("--overlap is not supported with checkpointed runs (the chunked "
                     "runner uses the fused exchange path)")

    import time
    from pathlib import Path

    import numpy as np
    import torch

    from ..core import io
    from ..models import lbm3d as lbm3d_model
    from ..models.lbm import default_num_devices, numpy_dtype, resolve_device
    from ..ops import d3q19
    from ..parallel import launch

    native = args.engine == "native"
    # the native engine runs on the host: it never asks CUDA
    device = None if native else resolve_device(args.device)
    dtype = {"float32": torch.float32, "float64": torch.float64}[args.dtype]
    cells = args.nz * args.ny * args.nx
    out = Path(args.out_dir)
    chunk = args.checkpoint_every or args.num_steps
    kernel_line = mesh_line = None
    if sharded and not checkpointed:
        run = lbm3d_model.run_simulation_sharded(
            args.nz, args.ny, args.nx, num_steps=args.num_steps, engine=args.engine,
            omega=args.omega, density=args.density, accel=args.accel, dtype=dtype,
            num_devices=args.num_devices, overlap=args.overlap,
            mesh_shape=None if args.mesh_shape is None else tuple(args.mesh_shape),
            device=device)
        if not launch.is_rank0():
            return 0  # inside a process group (torchrun), rank 0 reports
        f_final, av_np, dt = run.f_final, run.av_vels, run.compute_seconds
        time_label = "Total compute time"
        mlups = args.num_steps * cells / dt / 1e6
        mesh_line = "x".join(str(n) for n in run.mesh_shape)
        if run.k_steps is not None:
            kernel_line = (f"{run.kernel} on {'x'.join(str(n) for n in run.block)}, "
                           f"{run.k_steps} step{'s' if run.k_steps > 1 else ''} per pass"
                           f"{', overlapped exchange' if args.overlap else ''}")
    elif args.engine == "sharded-cuda":  # checkpointed
        n = args.num_devices or default_num_devices(device)
        k_steps = lbm3d_model.select_k_steps(args.engine, args.num_steps, chunk,
                                             (args.nz, args.ny, args.nx), n)
        kernel_line = f"ghost planes, {k_steps} step{'s' if k_steps > 1 else ''} per pass"
        mesh_line = str(n)
    elif args.engine not in ("torch", "native"):
        _, kind, k_steps, _ = d3q19.resolve_engine(args.engine, (args.num_steps, chunk))
        kernel_line = f"{kind}, {k_steps} step{'s' if k_steps > 1 else ''} per pass"
    if checkpointed:
        ck = Path(args.checkpoint or out / "checkpoint_3d.npz")
        ck.parent.mkdir(parents=True, exist_ok=True)
        f_final, av_np, dt, steps_run = lbm3d_model.run_simulation_with_checkpoints(
            args.nz, args.ny, args.nx, num_steps=args.num_steps, checkpoint_path=ck,
            checkpoint_every=chunk,
            omega=args.omega, density=args.density, accel=args.accel, dtype=dtype,
            engine=args.engine, resume=args.resume, device=device,
            num_devices=args.num_devices)
        if not launch.is_rank0():
            return 0
        # dt covers the steps executed by this invocation, the checkpoint
        # writes and (on the card) the kernels' build and load
        time_label = "Time (this run, incl. checkpoints)"
        mlups = steps_run * cells / dt / 1e6 if steps_run else 0.0
        if not steps_run:
            print(f"checkpoint already at step {args.num_steps}: nothing to run")
    elif native:
        from ..ops import d3q19_native

        d3q19_native.require()  # built and loaded outside the timed run
        t0 = time.perf_counter()
        f_final, av_np = d3q19_native.simulate(
            args.nz, args.ny, args.nx, num_steps=args.num_steps, omega=args.omega,
            density=args.density, accel=args.accel, dtype=numpy_dtype(dtype))
        dt = time.perf_counter() - t0
        time_label = "Total compute time"
        mlups = args.num_steps * cells / dt / 1e6
    elif not sharded:
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
    if mesh_line:
        print(f"mesh:\t\t\t{mesh_line}")
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
