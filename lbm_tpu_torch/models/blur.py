"""End-to-end Gaussian blur of an RGBA image.

The counterpart of `lbm_tpu.models.blur` on one device: normalise, pad, run
2 x num_iters blur passes through one engine of `ops.stencil`, strip the
ring, restore alpha, denormalise. Engines: 'conv' (depthwise `conv2d`),
'cuda' (kernel B10, or B9 with k_passes), 'resident' (kernel B8) and 'auto'.
The multi-device engine 'conv-sharded' of the reference is not ported yet
(ROADMAP.md A7).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import stencil
from ..utils import image as img_lib
from .lbm import resolve_device

ENGINES = ("conv", "cuda", "resident", "auto")


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
) -> BlurRun:
    """`blur_image` with the resolved engine and the final state beside the
    result. Runs on `device` (default: CUDA; raises when CUDA is absent
    unless 'cpu' is asked for).

    compute_seconds is the time of one run of `stencil.blur_many`, taken
    after a warm-up run (kernel build and load): on CUDA by events around
    the run on the device, with the copy back to the host OUTSIDE the window
    (the reference package has it inside); on the CPU by the host's clock."""
    if engine == "conv-sharded":
        raise ValueError("engine 'conv-sharded' (the multi-device blur) is not ported "
                         "yet: ROADMAP.md A7")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    if dtype not in stencil.DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
    device = resolve_device(device)
    fimg = img_lib.to_float_image(rgba)
    # row_mult 32 as in the reference, so that both packages blur one shape
    padded, interior, (h, w) = img_lib.pad_to_tile(fimg.intensities, row_mult=32)
    x = torch.from_numpy(padded).to(device=device, dtype=dtype)
    inter = torch.from_numpy(interior).to(device=device, dtype=dtype)

    if engine == "auto":
        engine, k_passes = choose_engine(x, num_iters, k_passes)
    kw = dict(num_iters=num_iters, engine=engine, band=band, k_passes=k_passes)

    stencil.blur_many(x, inter, **kw).float().cpu()  # warm-up
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
    state = out.float().cpu().numpy()

    blurred = state[:, 1:1 + h, 1:1 + w].copy()
    if not blur_alpha:
        blurred[3] = fimg.intensities[3]
    result = img_lib.to_char_image(
        img_lib.FloatImage(blurred, fimg.orig_chan_min, fimg.orig_chan_max))
    return BlurRun(result, compute_seconds, engine, k_passes, state)


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
