"""K fused D2Q9 steps per pass through an explicit copy pipeline: the wrapper
of CUDA kernel B3.

The counterpart of `lbm_tpu.ops.d2q9_pallas_manual` (kernel `_kernel`), the
engine `pallas-manual`: B2's function (`d2q9_kstep`), with the traffic
between device memory and the kernel's fast memory made explicit. On the
card (csrc/d2q9_manual.cu) a persistent grid of blocks walks the tiles in
order, and each block brings its next tile's region into shared memory
while it steps the current one. The `stepk` / `run` /
`simulate` contract and the modes are `d2q9_kstep`'s; at the same tile and K
the state and Sum|u| equal B2's bit for bit.

As B1 and B2, B3 moves a region in one of two ways (`PATHS`), which
`choose_path` picks per launch from the shape and the buffers' alignment:
"box", B2's rule with B3's shared memory, where the region arrives as one TMA
box into a free one of three rotating buffers, on that buffer's mbarrier,
and the tile leaves by one box store that is waited on only before its
buffer is written again, or "thread", every value
by the threads' `cp.async` (edge tiles, K = 1..3 in float32, misaligned
buffers). The launch reports it in `last_path`; a box launch whose tensor
maps do not encode raises.

Unlike the TPU kernel, which needs at least two bands of a height that is a
multiple of 8, B3 takes any grid that B1 and B2 take.
"""

from __future__ import annotations

import torch

from ..core.params import Params
from ..utils import profiling
from . import d2q9_kstep

# Launches of kernel B3 (one per K-step pass); callers may reset it.
launches = 0
# The path of the last launch of B3 ("box" or "thread").
last_path = None
PATHS = d2q9_kstep.PATHS

# On the thread path the region of a tile, (tile_h + 2K)(tile_w + 2K) cells,
# may hold at most this many: a thread carries the next tile's mask in 8
# registers (kMaskRegs x kThreads in csrc/d2q9_manual.cu).
MAX_REGION_CELLS = 8 * 256
# B3 takes B1/B2's tiles and K (d2q9_kstep.TILE_CANDIDATES, PREFERRED_K). Its
# own sweep on an H100 (experiments/cuda-kstep-tiles/sweep_manual.py,
# results_manual.csv) agrees: 16x32 at K=4 gives the most cell updates a
# second of 24 (tile, K) pairs at 1024^2 and at 4096^2 float32 (0.1074 and
# 1.4402 ms a pass), and is slower than B2 at the same tile (0.0928 and
# 1.2391).


def smem_bytes(tile_h: int, tile_w: int, k_steps: int, itemsize: int) -> int:
    """Dynamic shared memory of one block on the thread path: two stages and
    a work buffer of nine planes of the tile plus its K halo (each rounded up
    to 16 bytes), the reduction scratch, two mask stages and the row and
    column flags (mirrors smem_bytes in csrc/d2q9_manual.cu). A region too
    large for the mask registers counts as not fitting."""
    rh, rw = tile_h + 2 * k_steps, tile_w + 2 * k_steps
    if rh * rw > MAX_REGION_CELLS:
        return d2q9_kstep.SMEM_PER_BLOCK + 1
    per_16 = 16 // itemsize
    buffer = -(-9 * rh * rw // per_16) * per_16 * itemsize
    return 3 * buffer + 2 * d2q9_kstep.WARPS_PER_BLOCK * itemsize + 2 * rh * rw + rh + rw


def _round128(x: int) -> int:
    return -(-x // 128) * 128


def box_smem_layout(tile_h: int, tile_w: int, k_steps: int, itemsize: int) -> dict:
    """Byte offsets of the box path's shared memory from its 128-byte aligned
    base (mirrors box_smem in csrc/d2q9_manual.cu), each on 128 bytes:
    "buffers", the three rotating buffers of nine planes of the region;
    "masks", the mask planes of the even and the odd rounds; "bars", the
    three mbarriers (one a buffer); "red", the reduction scratch; "flags",
    the row flags and then the column flags; "total", with 128 bytes of slack
    to align the base."""
    rh, rw = tile_h + 2 * k_steps, tile_w + 2 * k_steps
    buf, mask = _round128(9 * rh * rw * itemsize), _round128(rh * rw)
    bars = 3 * buf + 2 * mask
    red = bars + 128
    flags = red + _round128(2 * d2q9_kstep.WARPS_PER_BLOCK * itemsize)
    return dict(buffers=(0, buf, 2 * buf), masks=(3 * buf, 3 * buf + mask), bars=bars, red=red,
                flags=flags, total=128 + flags + _round128(rh + rw))


def box_smem_bytes(tile_h: int, tile_w: int, k_steps: int, itemsize: int) -> int:
    """Dynamic shared memory of one block on the box path."""
    return box_smem_layout(tile_h, tile_w, k_steps, itemsize)["total"]


def choose_path(ny: int, nx: int, tile, k_steps: int, itemsize: int,
                aligned: bool = True, compute_itemsize: int | None = None) -> str:
    """"box" where TMA can move B3's regions and tiles (B2's rule,
    `d2q9_kstep.choose_path`, with B3's shared memory; mirrors box_fits in
    csrc/d2q9_manual.cu), else "thread" (always for bfloat16)."""
    return d2q9_kstep.choose_path(ny, nx, tile, k_steps, itemsize, False, aligned,
                                  box_smem=box_smem_bytes, compute_itemsize=compute_itemsize)


def launch_smem(ny: int, nx: int, aligned: bool = True, dtype=None):
    """smem(tile_h, tile_w, K, itemsize) of a launch on an (ny, nx) grid,
    `itemsize` the compute type's: the shared memory of the path it takes
    (on the box path the mask registers do not bound the region). `dtype`,
    the state's type, is needed where storage and compute differ
    (bfloat16); by default they are one."""
    storage = None if dtype is None else d2q9_kstep.itemsizes(dtype)[0]

    def smem(tile_h, tile_w, k_steps, itemsize):
        box = choose_path(ny, nx, (tile_h, tile_w), k_steps, storage or itemsize, aligned,
                          compute_itemsize=itemsize) == "box"
        return (box_smem_bytes if box else smem_bytes)(tile_h, tile_w, k_steps, itemsize)
    return smem


def choose_tile(h: int, w: int, itemsize: int, k_steps: int) -> tuple[int, int] | None:
    """As `d2q9_kstep.choose_tile`, with B3's shared memory."""
    return d2q9_kstep.choose_tile(h, w, itemsize, k_steps, smem_bytes)


def choose_config(h: int, w: int, dtype=torch.float32) -> tuple[int, int, int]:
    """(tile_h, tile_w, k_steps) for kernel B3 on this grid."""
    k = d2q9_kstep.PREFERRED_K
    return (*choose_tile(h, w, d2q9_kstep.itemsizes(dtype)[1], k), k)


def stepk_plain(f, mask, **kw):
    """The plain version of B3: `d2q9_kstep.stepk_plain`, B2's."""
    return d2q9_kstep.stepk_plain(f, mask, **kw)


def grid_blocks(f: torch.Tensor, tile: tuple[int, int], k_steps: int, mode: str = "full",
                path: str | None = None) -> int:
    """Blocks of B3's persistent grid on f's card for this tile, K and path
    (default: choose_path's for f): the blocks resident at once, at most one
    per tile."""
    from . import _build

    path = path or _path(f, tile, k_steps)
    _, ny, nx = f.shape
    blocks = _build.load("d2q9_manual").d2q9_manual_blocks(
        ny, nx, *tile, k_steps, f.element_size(), d2q9_kstep.check_mode(mode),
        PATHS.index(path))
    if blocks <= 0:
        raise RuntimeError(f"d2q9_manual: no block of tile {tile} at K={k_steps} fits the card")
    return blocks


def _args(f, mask, *, k_steps, tile, mode, **kw):
    """(mask as bytes, tile, ntiles, the scalars of the C entry point)."""
    mask_u8 = d2q9_kstep.obstacle_u8(mask)
    _, ny, nx = f.shape
    tile, ntiles, scalars = d2q9_kstep.kernel_args(
        f, mask_u8, k_steps=k_steps, tile=tile, mode=mode,
        smem=launch_smem(ny, nx, d2q9_kstep.aligned16(f), f.dtype), **kw)
    return mask_u8, tile, ntiles, scalars


def _path(f, tile, k_steps, *outs) -> str:
    _, ny, nx = f.shape
    itemsize, compute = d2q9_kstep.itemsizes(f.dtype)
    return choose_path(ny, nx, tile, k_steps, itemsize, d2q9_kstep.aligned16(f, *outs),
                       compute_itemsize=compute)


def _launch(f, mask_u8, out, partials, tot, path, scalars):
    global launches, last_path
    launches += 1
    last_path = path
    rc = d2q9_kstep._entry(f, "d2q9_manual", "d2q9_manual")(
        f.data_ptr(), mask_u8.data_ptr(), out.data_ptr(), partials.data_ptr(), tot.data_ptr(),
        PATHS.index(path), *scalars)
    d2q9_kstep.check_rc(rc, f"d2q9_manual ({path} path)")


def stepk(
    f: torch.Tensor,
    mask: torch.Tensor,
    *,
    k_steps: int,
    omega: float,
    accel_w1: float,
    accel_w2: float,
    accel_row: int,
    row_offset: int = 0,
    valid_rows: tuple | None = None,
    valid_cols: tuple | None = None,
    global_ny: int | None = None,
    tile: tuple[int, int] | None = None,
    mode: str = "full",
):
    """K fused timesteps in one pipelined pass (kernel B3 on CUDA,
    `stepk_plain` on the CPU). Returns (f_after_K_steps, tot_u per step
    (K,)); f is unchanged."""
    kw = dict(k_steps=k_steps, omega=omega, accel_w1=accel_w1, accel_w2=accel_w2,
              accel_row=accel_row, row_offset=row_offset, valid_rows=valid_rows,
              valid_cols=valid_cols, global_ny=global_ny, mode=mode)
    if f.device.type == "cpu":
        return stepk_plain(f, mask, **kw)
    mask_u8, tile, ntiles, scalars = _args(f, mask, tile=tile, **kw)
    out = torch.empty_like(f)
    partials, tot = d2q9_kstep.sums(f, k_steps * ntiles), d2q9_kstep.sums(f, k_steps)
    _launch(f, mask_u8, out, partials, tot, _path(f, tile, k_steps, out), scalars)
    return out, tot


def step(f, mask, **kw):
    """One fused timestep. Returns (f', tot_u scalar)."""
    f_new, tots = stepk(f, mask, k_steps=1, **kw)
    return f_new, tots[0]


def run(
    f: torch.Tensor,
    mask: torch.Tensor,
    *,
    num_steps: int,
    omega: float,
    accel_w1: float,
    accel_w2: float,
    accel_row: int,
    k_steps: int = 1,
    tile: tuple[int, int] | None = None,
    mode: str = "full",
):
    """`num_steps` timesteps, `k_steps` per pass, ping-ponging between two
    lattices. Returns (f_final, tot_u (num_steps,)); f is unchanged."""
    kw = dict(omega=omega, accel_w1=accel_w1, accel_w2=accel_w2, accel_row=accel_row)
    if f.device.type == "cpu":
        return d2q9_kstep.run_plain(f, mask, num_steps=num_steps, k_steps=k_steps, mode=mode,
                                    kernel="B3", **kw)
    if num_steps % k_steps:
        raise ValueError(f"num_steps {num_steps} not a multiple of k_steps {k_steps}")
    tots = d2q9_kstep.sums(f, num_steps)
    mask_u8, tile, ntiles, scalars = _args(f, mask, k_steps=k_steps, tile=tile, mode=mode, **kw)
    bufs = (torch.empty_like(f), torch.empty_like(f))
    path = _path(f, tile, k_steps, *bufs)
    partials = d2q9_kstep.sums(f, k_steps * ntiles)
    for i in profiling.passes(num_steps // k_steps, "B3", path, k_steps):
        out = bufs[i % 2]
        _launch(f, mask_u8, out, partials, tots[i * k_steps:(i + 1) * k_steps], path, scalars)
        f = out
        if profiling.NAN_DEBUG:
            profiling.check_nans(f, (i + 1) * k_steps, "kernel B3 (d2q9_kstep_manual)", k_steps)
    return f, tots


def simulate(params: Params, f: torch.Tensor, obstacle_mask: torch.Tensor):
    """Full simulation on kernel B3. Same contract as `d2q9.simulate`."""
    return d2q9_kstep.simulate_with(run, params, f, obstacle_mask)
