"""lbm_tpu_torch — the PyTorch/CUDA port of lbm_tpu for NVIDIA Hopper.

A second package beside `lbm_tpu` (the JAX/Pallas reference, which it never
imports). Same layout and numbering as the reference: the D2Q9 state is a
(9, ny, nx) tensor, speeds are numbered as in `core/state.py`, rows are axis
-2 and columns axis -1, so the tests compare like with like.

Layering:
  core/    host data model and exact-format I/O (numpy; copies of lbm_tpu.core)
  ops/     the plain PyTorch engine and the wrappers of the hand-written CUDA
           K-step kernels (csrc/), built with nvcc at first use
  models/  the end-to-end D2Q9 driver
  cli/     command-line entry point

Entry points run on the CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
