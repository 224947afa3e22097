"""The copy floor of a 2-D pass: the wrapper of CUDA kernel B12.

The counterpart of `run_copy` in experiments/d2q9-blocked-floor/run.py (the
Pallas kernel `_copy_kernel`): n passes of out = in over a (9, ny, nx) state
in (9, by, bx) tiles, ping-ponging between two buffers. A pass moves 2 x 9
values per cell and computes nothing, so its time bounds from below any
K-step pass that reads and writes the lattice once (csrc/copy_floor.cu).

The kernel takes one of two paths (`PATHS`), which `choose_path` picks
from the layout: `tma` where TMA can move the tile (rows and tile rows of a
multiple of 16 bytes, 16-byte aligned buffers), in chunks of the tile
through a ring of stages (`ring_of`, from the blocks an SM that the card
reports for each ring); `scalar`, one value at a time, for any other width
or alignment.

On a CUDA tensor the kernel runs or the call raises; on a CPU tensor the
plain version `run_copy_plain` runs. The library call that computes the same
function is `Tensor.copy_`; the port never calls it for this.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# Launches of kernel B12 (one per pass); callers may reset it.
launches = 0

PATHS = ("tma", "scalar")
MAX_BOX = 256  # TMA's longest side of a box, in values
# Bytes of a stage of the ring: a (9, 16, 32) float64 tile. The smaller
# (a float32 tile) where it holds a grid of few long tiles in fewer waves,
# e.g. a 16-row full-width band at 8192^2, 512 tiles: 3 blocks an SM of two
# large stages, 6 of two small ones.
MAX_CHUNK_BYTES = 36 * 1024
SMALL_CHUNK_BYTES = 18 * 1024
STAGES = 2  # stages of a tile of more than one chunk
DEEP_STAGES = 4  # ... where the grid has no more tiles than the card has SMs
ITEMSIZE = {torch.float32: 4, torch.float64: 8}


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


def tile_of(ny: int, nx: int, by: int, bx: int) -> tuple[int, int]:
    """The tile the kernel uses: a side longer than the grid's is the grid's."""
    return min(by, ny), min(bx, nx)


def choose_path(nx: int, bx: int, itemsize: int, aligned: bool) -> str:
    """`tma` where rows and tile rows are whole 16-byte pieces and both buffers
    start on 16 bytes (`aligned`); `scalar` otherwise. bx as `tile_of` gives."""
    v = 16 // itemsize
    return "tma" if aligned and nx % v == 0 and bx % v == 0 else "scalar"


def _divisors(n: int, limit: int) -> list[int]:
    return [d for d in range(1, min(n, limit) + 1) if n % d == 0]


def chunk_of(by: int, bx: int, itemsize: int,
             limit: int = MAX_CHUNK_BYTES) -> tuple[int, int, int]:
    """(cq, cy, cx): the box of one TMA load and store. It divides the (9, by,
    bx) tile, so the chunks of a tile never reach into another; cx is whole
    16-byte pieces; each side is at most MAX_BOX and the box at most `limit`
    bytes. Of those, the one with the most rows (cq x cy), whole planes
    first."""
    v = 16 // itemsize
    cx = max(d for d in _divisors(bx, MAX_BOX) if d % v == 0)
    best = None
    for cq in (9, 3, 1):
        cy = max((d for d in _divisors(by, MAX_BOX) if cq * d * cx * itemsize <= limit),
                 default=None)
        if cy is not None and (best is None or cq * cy > best[0] * best[1]):
            best = (cq, cy)
    return best[0], best[1], cx


def chunks_per_tile(by: int, bx: int, chunk: tuple[int, int, int]) -> int:
    cq, cy, cx = chunk
    return (9 // cq) * (by // cy) * (bx // cx)


def stages_of(by: int, bx: int, chunk: tuple[int, int, int], tiles: int, sms: int) -> int:
    """Stages of the ring: one for a tile of one chunk (any number works: the
    kernel refills a stage once its store has read it); for more, STAGES, or
    DEEP_STAGES where each SM holds at most one of the grid's `tiles` (a few
    full-width bands), so that its one block keeps more bytes in flight."""
    chunks = chunks_per_tile(by, bx, chunk)
    if chunks == 1:
        return 1
    return min(chunks, DEEP_STAGES if tiles <= sms else STAGES)


def waves(tiles: int, sms: int, per_sm: int) -> int:
    """Waves of one block a tile at `per_sm` blocks an SM."""
    return -(-tiles // (per_sm * sms))


def ring_of(by: int, bx: int, itemsize: int, tiles: int, sms: int, occupancy):
    """(chunk, stages) of the TMA path: chunks of MAX_CHUNK_BYTES, or of
    SMALL_CHUNK_BYTES where those take the grid in fewer waves and the large
    ones in two at most (the last wave of long tiles is the tail).
    `occupancy(chunk, stages)` is the blocks of such a ring resident on an SM
    (`blocks_per_sm` on the card)."""
    big = chunk_of(by, bx, itemsize)
    ring = (big, stages_of(by, bx, big, tiles, sms))
    small = chunk_of(by, bx, itemsize, SMALL_CHUNK_BYTES)
    if small != big:
        other = (small, stages_of(by, bx, small, tiles, sms))
        w_big = waves(tiles, sms, occupancy(*ring))
        if waves(tiles, sms, occupancy(*other)) < w_big <= 2:
            return other
    return ring


def plan(f: torch.Tensor, out: torch.Tensor, by: int, bx: int, sms: int | None = None,
         occupancy=None):
    """(path, chunk, stages) of a launch over f into out; chunk and stages are
    those of the TMA path. `sms` and `occupancy` (as `ring_of` takes it) are
    the current card's unless given. Raises on a type or layout the kernel
    does not take."""
    if f.dtype not in ITEMSIZE:
        raise ValueError(f"the kernel takes float32 or float64, got {f.dtype}")
    if not (f.is_contiguous() and out.is_contiguous()):
        raise ValueError("state must be contiguous")
    _, ny, nx = f.shape
    by, bx = tile_of(ny, nx, by, bx)
    itemsize = ITEMSIZE[f.dtype]
    aligned = f.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    path = choose_path(nx, bx, itemsize, aligned)
    if path != "tma":
        return path, (0, 0, 0), 0
    if sms is None:
        sms = torch.cuda.get_device_properties(f.device).multi_processor_count
    if occupancy is None:
        occupancy = functools.partial(blocks_per_sm, itemsize)
    tiles = -(-ny // by) * -(-nx // bx)
    return (path, *ring_of(by, bx, itemsize, tiles, sms, occupancy))


def run_copy(f: torch.Tensor, n: int, by: int, bx: int) -> torch.Tensor:
    """n passes of out = in over (9, by, bx) tiles of f, ping-ponging two
    buffers (kernel B12 on CUDA, `run_copy_plain` on the CPU), on the path
    that `plan` picks. Returns the last pass's output; f is unchanged."""
    global launches
    check_args(f, n, by, bx)
    if f.device.type == "cpu":
        return run_copy_plain(f, n, by, bx)
    if f.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on {f.device}")
    from . import _build

    lib = _build.load("copy_floor")
    _, ny, nx = f.shape
    stream = torch.cuda.current_stream(f.device).cuda_stream
    bufs = (torch.empty_like(f), torch.empty_like(f))
    # one plan for every pass: later passes read the fresh buffers, aligned
    # wherever f is
    chosen, chunk, stages = plan(f, bufs[0], by, bx)
    # the launch's ten ints, kept here for all passes: a pass crosses to C
    # in four arguments
    args = (ctypes.c_int * 10)(ITEMSIZE[f.dtype], ny, nx, int(by), int(bx),
                               PATHS.index(chosen), *chunk, stages)
    plan_at, run = ctypes.addressof(args), lib.copy_floor_run
    for i in range(n):
        out = bufs[i % 2]
        launches += 1
        rc = run(plan_at, f.data_ptr(), out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"copy_floor ({chosen} path): CUDA error {rc} at launch")
        f = out
    return f


def blocks_per_sm(itemsize: int, chunk: tuple[int, int, int], stages: int) -> int:
    """Blocks of the TMA path with this ring resident on one SM of the current
    card, as the kernel's occupancy query gives them."""
    from . import _build

    per_sm = _build.load("copy_floor").copy_floor_tma_blocks(itemsize, *chunk, stages)
    if per_sm < 1:
        raise RuntimeError(f"copy_floor: no block of chunk {chunk}, {stages} stages fits an SM")
    return per_sm
