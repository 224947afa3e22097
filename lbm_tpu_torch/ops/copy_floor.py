"""The copy floor of a 2-D pass: the wrapper of CUDA kernel B12.

The counterpart of `run_copy` in experiments/d2q9-blocked-floor/run.py (the
Pallas kernel `_copy_kernel`): n passes of out = in over a (9, ny, nx) state
in (9, by, bx) blocks, ping-ponging between two buffers. A pass moves 2 x 9
values per cell and computes nothing, so its time bounds from below any
K-step pass that reads and writes the lattice once (csrc/copy_floor.cu).

On a CUDA tensor the kernel runs or the call raises; on a CPU tensor the
plain version `run_copy_plain` runs. The library call that computes the same
function is `Tensor.copy_`; the port never calls it for this.
"""

from __future__ import annotations

import torch

# Launches of kernel B12 (one per pass); callers may reset it.
launches = 0


def run_copy_plain(f: torch.Tensor, n: int, by: int, bx: int) -> torch.Tensor:
    """The plain version: n clones of f (the blocks do not change a value)."""
    check_args(f, n, by, bx)
    for _ in range(n):
        f = f.clone()
    return f


def check_args(f: torch.Tensor, n: int, by: int, bx: int) -> None:
    if f.dim() != 3 or f.shape[0] != 9:
        raise ValueError(f"state must have shape (9, ny, nx), got {tuple(f.shape)}")
    if n < 1 or by < 1 or bx < 1:
        raise ValueError(f"n, by and bx must be positive, got {n}, {by}, {bx}")


def run_copy(f: torch.Tensor, n: int, by: int, bx: int) -> torch.Tensor:
    """n passes of out = in over (9, by, bx) blocks of f, ping-ponging two
    buffers (kernel B12 on CUDA, `run_copy_plain` on the CPU). Returns the
    last pass's output; f is unchanged."""
    global launches
    check_args(f, n, by, bx)
    if f.device.type == "cpu":
        return run_copy_plain(f, n, by, bx)
    if f.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on {f.device}")
    if f.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, got {f.dtype}")
    if not f.is_contiguous():
        raise ValueError("state must be contiguous")
    from . import _build

    entry = getattr(_build.load("copy_floor"),
                    "copy_floor_f32" if f.dtype == torch.float32 else "copy_floor_f64")
    _, ny, nx = f.shape
    stream = torch.cuda.current_stream(f.device).cuda_stream
    bufs = (torch.empty_like(f), torch.empty_like(f))
    for i in range(n):
        out = bufs[i % 2]
        launches += 1
        rc = entry(f.data_ptr(), out.data_ptr(), ny, nx, int(by), int(bx), stream)
        if rc != 0:
            raise RuntimeError(f"copy_floor: CUDA error {rc} at launch")
        f = out
    return f
