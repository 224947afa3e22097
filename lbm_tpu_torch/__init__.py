"""lbm_tpu_torch — the PyTorch/CUDA port of lbm_tpu for NVIDIA Hopper.

A second package beside `lbm_tpu` (the JAX/Pallas reference, which it never
imports). Same layout and numbering as the reference: the D2Q9 state is a
(9, ny, nx) tensor, speeds are numbered as in `core/state.py`, rows are axis
-2 and columns axis -1, so the tests compare like with like.

Layering:
  core/      host data model and exact-format I/O (numpy; copies of
             lbm_tpu.core), with the native writers and obstacle reader
  ops/       the plain PyTorch engines (D2Q9, D3Q19, the blur), the wrappers
             of the hand-written CUDA kernels (csrc/, built with nvcc at first
             use by ops/_build.py) and the serial C++ engines of native/
             (d2q9_native.py, d3q19_native.py)
  parallel/  the multi-device paths on torch.distributed: ranks (launch.py),
             meshes, the partition planner, halo strategies and the ghost-band
             and ghost-plane engines
  models/    the end-to-end drivers (2-D, 3-D, blur): timed runs, checkpoints
  utils/     images (PNG), the native library's loader and build
             (native_io.py), profiling, traces, torch.export and NaN checks
             (profiling.py), the torus-roll region map (roll_slices.py)
  cli/       entry points: lbm, lbm3d, blur; lbm_runner (runs an exported
             step), halo_bench, partition_stats, viz_partition, flow_viz
  dryrun.py  every multi-device path once on N ranks

Entry points run on the CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
