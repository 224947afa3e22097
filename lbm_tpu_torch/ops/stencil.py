"""3x3 Gaussian-blur stencil: the conv engine and the wrappers of CUDA
kernels B10, B9 and B8.

The counterpart of `lbm_tpu.ops.stencil`. Kernel = (1 2 1; 2 4 2; 1 2 1)/16
per channel. State layout: (C, Hp, Wp) channels-first, zero-padded by
`utils.image.pad_to_tile`, with an interior {0,1} mask (Hp, Wp) in the
image's type; float32 or bfloat16 in memory, float32 arithmetic in both.

  * `blur_step_conv`  one pass as a depthwise `conv2d` (zero outside);
  * `blur_step`       one pass, kernel B10 (for `blur_step_pallas`);
  * `blur_k`          k passes per trip through device memory, kernel B9
                      (for `blur_k_pallas`);
  * `blur_resident`   a whole run in one launch with the image on chip,
                      kernel B8;
  * `blur_many`       2 x num_iters passes of one engine.

The kernels are in `csrc/stencil.cu`; the note at its top has their design
and their bound on the card. Beside each wrapper stands its plain PyTorch
version (`blur_step_plain`, `blur_k_plain`, `blur_resident_plain`): the
same arithmetic in the same order, on the whole array with periodic edges
(`torch.roll`), rounding to the storage type where the kernel does: B10
after every pass, B9 once per k passes, B8 once per run. A wrapper runs its
plain version only for a CPU tensor; a CUDA tensor goes to the kernel, and
anything else raises. `launches` counts the kernel launches.

The kernels and their plain versions wrap around at the edges, as the TPU
kernels do; `blur_step_conv` sees zeros outside. The two agree on any image
whose ring is zero, which `pad_to_tile` provides.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# (1 2 1; 2 4 2; 1 2 1)/16
KERNEL = np.array([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]) / 16.0

# Launches of each kernel, by wrapper; callers may reset the counts.
launches = {"blur_step": 0, "blur_k": 0, "blur_resident": 0}

MAX_PASSES_PER_SWEEP = 8  # the k of the TPU kernel's 8-row halo blocks, kept
# Shared memory a block may use on Hopper (H100/H200), in bytes, and the
# SMs of an H100: the figures `resident_fits` takes for a CPU tensor, so
# that 'auto' chooses on the CPU what it would choose on that card.
SMEM_PER_BLOCK = 232448
H100_SMS = 132
# B9's tile (rows, columns) and threads a block when the caller names none.
# Measured at 4096x4096 RGBA float32 on an H100 over 11 tiles, k = 1, 2, 4, 8
# and 256 or 512 threads (experiments/cuda-kstep-tiles/results_blur.csv):
# 32x64 with 256 threads is the fastest at k=4, the k that 'auto' picks, and
# at k=2; 64x64 is 10% faster at k=8, 32x128 5% at k=1; 512 threads never win.
DEFAULT_TILE = (32, 64)
K_THREADS = 256
# B8: threads of a block, and the widest tile its index arithmetic takes
# (blur_resident_opt.MAX_ROW less the halo)
RESIDENT_THREADS = 512
RESIDENT_MAX_TILE_W = 1021

DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=8)
def _conv_weights(c: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(KERNEL, dtype=dtype, device=device).expand(c, 1, 3, 3).contiguous()


def blur_step_conv(img: torch.Tensor, interior: torch.Tensor) -> torch.Tensor:
    """One blur via depthwise conv. img: (C, H, W); interior: (H, W) {0,1}.
    float32 in means float32 arithmetic: TF32 is switched off around this
    call (cuDNN's default for float32 convolutions would keep about three
    digits); bfloat16 keeps the library's default."""
    c = img.shape[0]
    kern = _conv_weights(c, img.dtype, img.device)
    if img.device.type == "cuda" and img.dtype == torch.float32:
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            out = torch.nn.functional.conv2d(img[None], kern, padding=1, groups=c)[0]
        finally:
            torch.backends.cudnn.allow_tf32 = before
    else:
        out = torch.nn.functional.conv2d(img[None], kern, padding=1, groups=c)[0]
    return out * interior


def _up(x):  # the row above: out[y] = x[y - 1], periodic
    return torch.roll(x, 1, dims=-2)


def _down(x):
    return torch.roll(x, -1, dims=-2)


def _left(x):  # the column to the left: out[x] = x[x - 1], periodic
    return torch.roll(x, 1, dims=-1)


def _right(x):
    return torch.roll(x, -1, dims=-1)


def blur_step_plain(img: torch.Tensor, interior: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of kernel B10: the direct 9-point sum in
    the grouping of `lbm_tpu.ops.stencil._blur_kernel`, in float32."""
    m = img.float()
    n, s = _up(m), _down(m)
    acc = 4.0 * m
    acc = acc + 2.0 * (n + s + _left(m) + _right(m))
    acc = acc + (_left(n) + _right(n) + _left(s) + _right(s))
    return (acc * (1.0 / 16.0) * interior.float()[None]).to(img.dtype)


def _separable_pass(x, mask, first, last):
    """rows = (first(x) + 2x) + last(x); acc = (right + 2 rows) + left."""
    rows = first(x) + 2.0 * x + last(x)
    acc = _right(rows) + 2.0 * rows + _left(rows)
    return acc * (1.0 / 16.0) * mask


def blur_k_plain(img: torch.Tensor, interior: torch.Tensor, *, k_passes: int) -> torch.Tensor:
    """The plain PyTorch version of kernel B9: k separable passes in float32
    in the order of `_blur_kernel_k` (the row above first), the mask applied
    at every pass, one rounding to the storage type at the end."""
    x, mask = img.float(), interior.float()[None]
    for _ in range(k_passes):
        x = _separable_pass(x, mask, _up, _down)
    return x.to(img.dtype)


def blur_resident_plain(img: torch.Tensor, interior: torch.Tensor, *,
                        num_passes: int) -> torch.Tensor:
    """The plain PyTorch version of kernel B8: `num_passes` separable passes
    on a float32 state in the order of `_resident_kernel` (the row below
    first), one rounding to the storage type at the end."""
    x, mask = img.float(), interior.float()[None]
    for _ in range(num_passes):
        x = _separable_pass(x, mask, _down, _up)
    return x.to(img.dtype)


def _check(img: torch.Tensor, interior: torch.Tensor) -> tuple[int, int, int]:
    """Checks a CUDA call of any of the three kernels; returns (c, h, w)."""
    if img.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on {img.device}")
    if img.dim() != 3:
        raise ValueError(f"image must have shape (C, H, W), got {tuple(img.shape)}")
    if img.dtype not in DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, got {img.dtype}")
    c, h, w = img.shape
    if (interior.shape != (h, w) or interior.dtype != img.dtype
            or interior.device != img.device):
        raise ValueError(f"interior must be ({h}, {w}) {img.dtype} on {img.device}")
    if not img.is_contiguous() or not interior.is_contiguous():
        raise ValueError("image and interior must be contiguous")
    return c, h, w


def _entry(img: torch.Tensor, name: str):
    from . import _build

    suffix = "f32" if img.dtype == torch.float32 else "bf16"
    return getattr(_build.load("stencil"), f"{name}_{suffix}")


REFUSALS = {-1: "the blocks of the grid cannot all be resident at once",
            -2: "the device has no cooperative launch",
            -3: "a tile or thread count the kernel does not take"}


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: " + (REFUSALS.get(rc) or f"CUDA error {rc} at launch"))


def _stream(img: torch.Tensor) -> int:
    return torch.cuda.current_stream(img.device).cuda_stream


def blur_step(img: torch.Tensor, interior: torch.Tensor) -> torch.Tensor:
    """One fused blur pass (kernel B10 on CUDA, `blur_step_plain` on the
    CPU). The periodic wraparound only ever reads the zero pad ring of a
    padded image, so it is exact for the zero-boundary stencil."""
    if img.device.type == "cpu":
        return blur_step_plain(img, interior)
    c, h, w = _check(img, interior)
    out = torch.empty_like(img)
    launches["blur_step"] += 1
    rc = _entry(img, "stencil_step")(img.data_ptr(), interior.data_ptr(), out.data_ptr(),
                                     c, h, w, _stream(img))
    _check_rc(rc, "stencil_step")
    return out


def blur_k_smem_bytes(tile_h: int, tile_w: int, k_passes: int) -> int:
    """Dynamic shared memory of one block of B9: two float32 buffers and the
    mask over the tile plus its k halo (mirrors blur_k_smem_bytes in
    csrc/stencil.cu)."""
    return 3 * (tile_h + 2 * k_passes) * (tile_w + 2 * k_passes) * 4


def check_k_passes(k_passes: int, h: int) -> None:
    if not 1 <= k_passes <= MAX_PASSES_PER_SWEEP:
        raise ValueError(f"k_passes must be in 1..{MAX_PASSES_PER_SWEEP}")
    if k_passes > 1 and h < 16:
        raise ValueError("k_passes > 1 needs at least two 8-row blocks")


def blur_k(img: torch.Tensor, interior: torch.Tensor, *, k_passes: int,
           band: int | None = None) -> torch.Tensor:
    """`k_passes` fused blur passes in ONE trip through device memory
    (k_passes <= 8; kernel B9 on CUDA, `blur_k_plain` on the CPU). `band` is
    the row extent of a block's tile (DEFAULT_TILE's when None); the tile
    does not have to divide the image, and the result does not depend on it.
    Mathematically identical to k_passes calls of `blur_step`; differs at
    float32 rounding, since this kernel accumulates rows then columns and
    the single-pass kernel the direct 9-point sum."""
    k_passes = int(k_passes)
    check_k_passes(k_passes, img.shape[-2])
    th, tw = DEFAULT_TILE[0] if band is None else int(band), DEFAULT_TILE[1]
    if th < 1:
        raise ValueError(f"bad band {th}")
    if img.device.type == "cpu":
        return blur_k_plain(img, interior, k_passes=k_passes)
    c, h, w = _check(img, interior)
    if blur_k_smem_bytes(th, tw, k_passes) > SMEM_PER_BLOCK or tw + 2 * k_passes >= 1024:
        raise ValueError(f"tile {th}x{tw} at k_passes={k_passes} needs more than "
                         f"{SMEM_PER_BLOCK} B of shared memory or is wider than 1023 "
                         "with its halo")
    out = torch.empty_like(img)
    launches["blur_k"] += 1
    rc = _entry(img, "stencil_k")(img.data_ptr(), interior.data_ptr(), out.data_ptr(),
                                  c, h, w, th, tw, k_passes, K_THREADS, _stream(img))
    _check_rc(rc, "stencil_k")
    return out


def resident_smem_bytes(tile_h: int, tile_w: int, depth: int = 1) -> int:
    """Dynamic shared memory of one block of B8: two float32 buffers of the
    tile plus a `depth`-cell halo, and the mask over a halo one cell less
    deep (at depth 1, the tile's). B8 is the v0 instance of the resident
    template (csrc/blur_resident.cuh), so this is
    `blur_resident_opt.resident_bytes` of v0."""
    from .blur_resident_opt import resident_bytes

    return resident_bytes("v0-roll", (tile_h, tile_w), 1, depth)


def resident_tiling(c: int, h: int, w: int, sms: int = H100_SMS,
                    smem: int = SMEM_PER_BLOCK) -> tuple[int, int] | None:
    """The tile (rows, columns) of kernel B8 for a (c, h, w) image on a
    device of `sms` SMs with `smem` bytes of shared memory per block: at
    most one block per SM, so that the grid is co-resident whatever else
    limits occupancy; among the tilings that fit, the one with the fewest
    cells per block, then the shortest edges. None when none fits. The
    rule is `blur_resident_opt.tiling`'s for v0, whose instance B8 is."""
    from .blur_resident_opt import tiling

    return tiling("v0-roll", c, h, w, sms, smem)


def device_limits(device: torch.device) -> tuple[int, int]:
    """(SMs, shared memory a block may opt in to) of a CUDA device; the
    H100's figures for any other."""
    if device.type != "cuda":
        return H100_SMS, SMEM_PER_BLOCK
    props = torch.cuda.get_device_properties(device)
    return (props.multi_processor_count,
            int(getattr(props, "shared_memory_per_block_optin", SMEM_PER_BLOCK)))


def resident_fits(img: torch.Tensor) -> bool:
    """Whether kernel B8 can hold this image: a tiling exists that gives
    each SM of the image's device one tile within its shared memory
    (12 bytes per pixel and channel, about 2.4 M values on an H100)."""
    c, h, w = img.shape
    return resident_tiling(c, h, w, *device_limits(img.device)) is not None


def blur_resident(img: torch.Tensor, interior: torch.Tensor, *,
                  num_passes: int) -> torch.Tensor:
    """`num_passes` blur applications in one launch, the image resident in
    the SMs' shared memory throughout (kernel B8 on CUDA,
    `blur_resident_plain` on the CPU). Needs 12 bytes of shared memory per
    value across the device; use the 'cuda' engine beyond that."""
    c, h, w = img.shape
    sms, smem = device_limits(img.device)
    tile = resident_tiling(c, h, w, sms, smem)
    if tile is None:
        raise ValueError(
            f"image {c}x{h}x{w} needs ~{12 * c * h * w >> 20}MB of shared memory for "
            f"the resident engine (this device offers {sms} x {smem >> 10}KB, one tile "
            "per SM); use engine='cuda' (ideally with k_passes) or 'conv' for images "
            "this large")
    if num_passes % 2:
        raise ValueError("resident blur runs passes in pairs (even num_passes)")
    if img.device.type == "cpu":
        return blur_resident_plain(img, interior, num_passes=num_passes)
    _check(img, interior)
    from .blur_resident_opt import choose_depth, exchange, exchange_words, exchanges

    th, tw = tile
    k = choose_depth("v0-roll", c, h, w, tile, smem)
    stream = _stream(img)
    xrow, xcol, tag0 = exchange(img.device, stream,
                                *exchange_words("v0-roll", c, h, w, tile, k),
                                exchanges(num_passes, k))
    out = torch.empty_like(img)
    launches["blur_resident"] += 1
    rc = _entry(img, "stencil_resident")(
        img.data_ptr(), interior.data_ptr(), out.data_ptr(), xrow.data_ptr(),
        xcol.data_ptr(), c, h, w, th, tw, int(num_passes), k, tag0,
        RESIDENT_THREADS, stream)
    _check_rc(rc, "stencil_resident")
    return out


ENGINES = ("conv", "cuda", "resident")


def blur_many(img: torch.Tensor, interior: torch.Tensor, *, num_iters: int,
              engine: str = "conv", band: int | None = None,
              k_passes: int | None = None) -> torch.Tensor:
    """num_iters x2 blur passes (the reference runs pairs). engine='resident'
    executes the whole run inside one launch of kernel B8; 'conv' and 'cuda'
    loop over per-pass calls (`blur_step_conv`, kernel B10). k_passes ('cuda'
    engine only) fuses that many passes per trip through device memory
    (kernel B9), for images too large for the resident engine; it must
    divide 2*num_iters. `band` is the row extent of B9's tiles."""
    if engine == "resident":
        return blur_resident(img, interior, num_passes=2 * num_iters)
    if engine == "cuda" and k_passes is not None and k_passes > 1:
        if (2 * num_iters) % k_passes:
            raise ValueError(f"k_passes {k_passes} must divide 2*num_iters {2 * num_iters}")
        for _ in range(2 * num_iters // k_passes):
            img = blur_k(img, interior, k_passes=k_passes, band=band)
        return img
    step = {"conv": blur_step_conv, "cuda": blur_step}.get(engine)
    if step is None:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    for _ in range(2 * num_iters):
        img = step(img, interior)
    return img
