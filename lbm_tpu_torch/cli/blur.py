"""CLI: iterated 3x3 Gaussian blur over a PNG with the PyTorch/CUDA port.

Usage:
    python -m lbm_tpu_torch.cli.blur -i in.png -o out.png [-n 100]
        [--engine conv|cuda|resident|conv-sharded|auto] [--num-devices N]
        [--data-type float|half] [--band ROWS] [--k-passes K] [--device cuda|cpu]
        [--blur-alpha] [--compile-only [--export FILE]]

The counterpart of `python -m lbm_tpu.cli.blur`, with the same flags; the
engine 'cuda' takes the place of 'pallas'. Runs on the CUDA device unless
`--device cpu` is given, where the kernel engines run their kernels' plain
PyTorch version. `--data-type half` is bfloat16 storage with float32
arithmetic. `--engine conv-sharded` runs the conv engine on --num-devices
ranks of torch.distributed (default: every GPU on CUDA, 1 on the CPU).
`--compile-only` exports one pass of the conv engine
(`ops.stencil.blur_step_conv`) with torch.export at the padded shape the run
would blur, on the device, prints its operation count and exits; `--export
FILE` saves it (the reference's stencil executable).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Gaussian blur on PyTorch/CUDA")
    parser.add_argument("-i", "--image", required=True)
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("-n", "--num-iters", type=int, default=100,
                        help="number of iteration pairs (each = 2 blur passes)")
    parser.add_argument("--engine", default="conv",
                        choices=["conv", "cuda", "resident", "conv-sharded", "auto"],
                        help="'conv' (depthwise conv2d), 'cuda' (kernel B10; B9 with "
                             "--k-passes), 'resident' (kernel B8: one launch, the image "
                             "in the SMs' shared memory), 'conv-sharded' (conv on a mesh of "
                             "ranks); auto = resident when the image fits there, else cuda "
                             "with k-passes 4 or 2")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="ranks of --engine conv-sharded (default: every GPU on CUDA, "
                             "1 on the CPU)")
    parser.add_argument("--data-type", default="float",
                        choices=["float", "half", "float32", "bfloat16"])
    parser.add_argument("--band", type=int, default=None,
                        help="--engine cuda with --k-passes: the rows a thread "
                             "block writes (the reference's row-band height; the "
                             "result does not depend on it)")
    parser.add_argument("--k-passes", type=int, default=None,
                        help="--engine cuda: fuse this many blur passes per trip "
                             "through device memory (temporal blocking, <=8; must "
                             "divide 2*num_iters), for images too large for the "
                             "resident engine")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--blur-alpha", action="store_true")
    parser.add_argument("--compile-only", action="store_true",
                        help="export one blur pass of the conv engine with torch.export at "
                             "this image's padded shape and exit (no blur)")
    parser.add_argument("--export", default=None, metavar="FILE",
                        help="with --compile-only: save the exported pass")
    args = parser.parse_args(argv)

    if args.num_devices is not None and args.engine != "conv-sharded":
        parser.error("--num-devices applies to --engine conv-sharded only")
    if args.export and not args.compile_only:
        parser.error("--export applies to --compile-only")
    if not args.output and not args.compile_only:
        parser.error("-o/--output is required unless --compile-only")

    import torch

    from ..models import blur

    dtype = torch.bfloat16 if args.data_type in ("half", "bfloat16") else torch.float32
    if args.compile_only:
        return _compile_only(args.image, dtype, blur.resolve_device(args.device), args.export)
    run = blur.blur_file(
        args.image, args.output, num_iters=args.num_iters, engine=args.engine,
        dtype=dtype, blur_alpha=args.blur_alpha, band=args.band,
        k_passes=args.k_passes, device=args.device, num_devices=args.num_devices)
    fused = f" (k_passes {run.k_passes})" if run.engine == "cuda" and run.k_passes else ""
    print(f"engine:\t{run.engine}{fused}")
    seconds = run.compute_seconds
    print(f"{args.num_iters}(x2) iterations took {seconds:.6f}s "
          f"({seconds * 1e6:.0f} us)")
    return 0


def _compile_only(image, dtype, device, export_path) -> int:
    """--compile-only: export `blur_step_conv` on `device` at the padded
    shape of the runtime path (`models.blur.run_blur`); print its operation
    count, and save it to export_path when given."""
    import torch

    from ..ops import stencil
    from ..utils import image as img_lib, profiling

    fimg = img_lib.to_float_image(img_lib.load_png(image))
    padded, interior, _ = img_lib.pad_to_tile(fimg.intensities, row_mult=32)
    x = torch.from_numpy(padded).to(device=device, dtype=dtype)
    inter = torch.from_numpy(interior).to(device=device, dtype=dtype)
    with profiling.timed("export"):
        if export_path:
            program, nbytes = profiling.export_step(stencil.blur_step_conv, x, inter,
                                                    path=export_path)
        else:
            program = profiling.export(stencil.blur_step_conv, x, inter)
    print(f"exported pass: ops.stencil.blur_step_conv on {device.type}, {tuple(x.shape)} "
          f"{str(dtype).replace('torch.', '')}, {profiling.operation_count(program)} operations")
    if export_path:
        print(f"exported {nbytes} bytes to {export_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
