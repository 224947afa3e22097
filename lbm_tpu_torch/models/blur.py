"""End-to-end Gaussian blur of an RGBA image.

The counterpart of `lbm_tpu.models.blur`: normalise, pad, run 2 x num_iters
blur passes through one engine of `ops.stencil`, strip the ring, restore
alpha, denormalise. Engines: 'conv' (depthwise `conv2d`), 'cuda' (kernel B10,
or B9 with k_passes), 'resident' (kernel B8), 'auto', and 'conv-sharded': the
conv engine on the image sharded over a mesh of `num_devices` ranks
(`parallel.launch`), each block taking a one-cell ring from its neighbours
every pass.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..ops import stencil
from ..utils import image as img_lib
from .lbm import resolve_device

ENGINES = ("conv", "cuda", "resident", "auto", "conv-sharded")


@dataclasses.dataclass
class BlurRun:
    rgba: np.ndarray  # (H, W, 4) uint8, blurred
    compute_seconds: float
    engine: str  # the engine that ran ('auto' resolved)
    k_passes: int | None
    state: np.ndarray  # (C, Hp, Wp) float32: the padded state after the run


def choose_engine(x: torch.Tensor, num_iters: int,
                  k_passes: int | None) -> tuple[str, int | None]:
    """What 'auto' runs: the resident kernel when the image fits the
    device's shared memory (`stencil.resident_fits`), else the 'cuda' engine
    with k_passes the first of 4, 2 that divides 2 * num_iters."""
    if stencil.resident_fits(x):
        return "resident", k_passes
    if k_passes is None:
        k_passes = next((k for k in (4, 2) if (2 * num_iters) % k == 0), None)
    return "cuda", k_passes


def run_blur(
    rgba: np.ndarray,
    *,
    num_iters: int = 100,
    engine: str = "conv",
    dtype=torch.float32,
    blur_alpha: bool = False,
    band: int | None = None,
    k_passes: int | None = None,
    device=None,
    num_devices: int | None = None,
) -> BlurRun:
    """`blur_image` with the resolved engine and the final state beside the
    result. Runs on `device` (default: CUDA; raises when CUDA is absent
    unless 'cpu' is asked for).

    compute_seconds is the time of one run of `stencil.blur_many`, taken
    after a warm-up run (kernel build and load): on CUDA by events around
    the run on the device, with the copy back to the host OUTSIDE the window
    (the reference package has it inside); on the CPU by the host's clock.
    'conv-sharded' runs on `num_devices` ranks (default: every GPU on CUDA, 1
    on the CPU), over `mesh.make_mesh(..., require_even=True)` of the padded
    image, and is timed on rank 0."""
    if num_devices is not None and engine != "conv-sharded":
        raise ValueError("num_devices applies to engine 'conv-sharded' only")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    if dtype not in stencil.DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
    device = resolve_device(device)
    fimg = img_lib.to_float_image(rgba)
    # row_mult 32 as in the reference, so that both packages blur one shape
    padded, interior, (h, w) = img_lib.pad_to_tile(fimg.intensities, row_mult=32)
    if engine == "conv-sharded":
        from ..parallel import launch

        n = num_devices or (torch.cuda.device_count() if device.type == "cuda" else 1)
        state, compute_seconds = launch.run(_sharded_rank, n, padded, interior, dtype,
                                            num_iters, device_type=device.type)
    else:
        x = torch.from_numpy(padded).to(device=device, dtype=dtype)
        inter = torch.from_numpy(interior).to(device=device, dtype=dtype)
        if engine == "auto":
            engine, k_passes = choose_engine(x, num_iters, k_passes)
        state, compute_seconds = _timed(x, inter, device, num_iters=num_iters, engine=engine,
                                        band=band, k_passes=k_passes)

    blurred = state[:, 1:1 + h, 1:1 + w].copy()
    if not blur_alpha:
        blurred[3] = fimg.intensities[3]
    result = img_lib.to_char_image(
        img_lib.FloatImage(blurred, fimg.orig_chan_min, fimg.orig_chan_max))
    return BlurRun(result, compute_seconds, engine, k_passes, state)


def _timed(x, inter, device, **kw):
    """A warm-up run of `stencil.blur_many`, then the timed run. Returns
    (the state as float32 numpy, seconds)."""
    stencil.blur_many(x, inter, **kw).float()  # warm-up
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = stencil.blur_many(x, inter, **kw)
        end.record()
        end.synchronize()
        compute_seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        out = stencil.blur_many(x, inter, **kw)
        compute_seconds = time.perf_counter() - t0
    if isinstance(out, DTensor):
        out = out.full_tensor()
    return out.float().cpu().numpy(), compute_seconds


def _sharded_rank(padded, interior, dtype, num_iters):
    """The body of conv-sharded on each rank: the conv engine on this rank's
    block of the image."""
    from ..parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(None, padded.shape[1], padded.shape[2], require_even=True)
    device = mesh_lib.local_device()
    x = mesh_lib.shard(torch.from_numpy(padded).to(dtype), mesh, mesh_lib.grid_placements())
    inter = mesh_lib.shard(torch.from_numpy(interior).to(dtype), mesh, mesh_lib.mask_placements())
    return _timed(x, inter, device, num_iters=num_iters, engine="conv")


def blur_image(rgba: np.ndarray, **kw) -> tuple[np.ndarray, float]:
    """Normalise, pad, run num_iters x2 blur passes, denormalise. Returns
    (blurred RGBA uint8, compute_seconds). By default the alpha channel is
    left untouched. Takes the keywords of `run_blur`."""
    run = run_blur(rgba, **kw)
    return run.rgba, run.compute_seconds


def blur_file(in_path: str | Path, out_path: str | Path, **kw) -> BlurRun:
    """Blur the PNG at in_path into out_path; returns the run (its
    `compute_seconds` is what the reference's `blur_file` returns)."""
    run = run_blur(img_lib.load_png(in_path), **kw)
    img_lib.save_png(out_path, run.rgba)
    return run
