"""K fused D2Q9 steps per pass: the wrapper of CUDA kernel B2 (two-stream).

The counterpart of `lbm_tpu.ops.d2q9_pallas` (kernel `_kernel`). One launch
of `csrc/d2q9_kstep.cu` advances the whole lattice K steps, in -> out, with
every intermediate step held in shared memory, and returns the per-step
Sum|u| over the valid window. See the note at the top of the source for the
design and its bound on the card.

Contract of `stepk` (shared with `d2q9_kstep_inplace.stepk` and
`d2q9_kstep_manual.stepk`):
  * f is (9, ny, nx) float32, float64 or bfloat16 and contiguous, any ny and
    nx of at least K; mask is the (ny, nx) obstacle mask (bool or uint8,
    nonzero = blocked). The tiles of the last row and column are cut to the
    grid;
  * a bfloat16 state is storage only, as in the TPU kernels: a pass steps in
    float32 and rounds the state to bfloat16 once, at its end; Sum|u| is
    float32 (`compute_dtype`);
  * row_offset / valid_rows / valid_cols / global_ny describe a
    ghost-extended block as in `lbm_tpu.ops.d2q9_pallas.stepk`: local row r
    is global row r + row_offset, the accelerated row is tested as
    (r + row_offset) mod global_ny == accel_row, and only cells inside
    [valid_rows) x [valid_cols) count towards Sum|u|;
  * `mode` is one of MODES, the TPU kernels' diagnostic modes: "full" (the
    production step), "stream_only" (K periodic pull-streams without
    bounce-back or collision; Sum|u| is the window sum of the rest-speed
    plane, as `u = state[0]` in the TPU kernels) or "copy" (out = in). The
    copy mode's Sum|u| is a token: zeros here, where the TPU kernels sum one
    128-wide row per band to keep their output alive; it is never compared;
  * on a CUDA tensor the kernel is launched, or the call raises; on a CPU
    tensor the plain version `stepk_plain` runs. There is no other route.

B1 and B2 move a tile's region in one of two ways (`PATHS`), which
`choose_path` picks per launch from the shape and the buffers' alignment:
"box", where the Tensor Memory Accelerator brings the region in and takes
the tile out in boxes and the threads patch only the strips no box can place,
or "thread",
every value by the threads, for the shapes TMA cannot take (edge tiles; K
values, rows or tile rows that are not whole 16-byte pieces, e.g. K = 1..3
in float32; box offsets off 128 bytes in place). The launch reports it in
`last_path`; a box launch whose tensor map does not encode raises.

B2's `stepk` and `run` also take `shared_reciprocal` (the TPU kernel's
switch): the collision takes 1/rho once and multiplies.

`stepk_plain` is the plain PyTorch version: K steps of `d2q9` on the whole
periodic array (a bfloat16 state upcast to float32 for the pass and rounded
at its end). It agrees with the kernel on every cell whenever
global_ny == ny, or the accelerated row lies more than K rows from the
array's top and bottom edges (the kernel tests halo rows at their unwrapped
index, as the TPU kernel does; the plain version at their wrapped one).
"""

from __future__ import annotations

import torch

from ..core.params import Params
from ..utils import profiling
from . import d2q9

# Launches of kernel B2 (one per K-step pass); callers may reset it.
launches = 0
# The path of the last launch of B2 ("box" or "thread").
last_path = None

MAX_STEPS_PER_PASS = 8
# Shared memory a block may use on Hopper (H100/H200), in bytes.
SMEM_PER_BLOCK = 232448
# Warps per block of the kernel (kThreads / 32); sizes the reduction scratch.
WARPS_PER_BLOCK = 8
# Tile shapes (rows, columns) in order of preference, and the steps per
# pass. Measured at 1024^2 float32 on an H100 (experiments/cuda-kstep-tiles/
# results.csv): 16x32 at K=4 is the fastest of 28 (tile, K) pairs for both
# kernels (B1 0.120 ms per pass, B2 0.093); K=2 and K=8 lose at every tile.
# 8x32 (B1 0.133 ms) serves grids whose height is a multiple of 8 only; the
# narrower tiles, not timed, serve widths that are not a multiple of 32. A
# grid that none divides takes the first that fits, with edge tiles. The
# kernels take any tile whose sides are at least K.
TILE_CANDIDATES = ((16, 32), (8, 32), (16, 16), (8, 16), (8, 8))
PREFERRED_K = 4


def choose_k(num_steps: int) -> int:
    """Steps per pass of a run of `num_steps`: the largest of PREFERRED_K,
    PREFERRED_K/2, ..., 1 that divides it."""
    k_steps = PREFERRED_K
    while num_steps % k_steps:
        k_steps //= 2
    return k_steps


# the diagnostic modes of the kernels, by their index in the C entry points
MODES = ("full", "stream_only", "copy")
# how a launch moves its regions, by index in the C entry points (Path)
PATHS = ("thread", "box")
MAX_BOX = 256  # TMA's longest side of a box, in values
# the state types the kernels take
DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def compute_dtype(dtype) -> torch.dtype:
    """The type a pass steps in and sums Sum|u| in: float32 for a bfloat16
    state (storage only), else the state's own."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def itemsizes(dtype) -> tuple[int, int]:
    """(storage, compute) bytes a value of a `dtype` state: the lattice in
    device memory holds the first, the region buffers in shared memory the
    second."""
    return (torch.empty((), dtype=dtype).element_size(),
            torch.empty((), dtype=compute_dtype(dtype)).element_size())


def smem_bytes(tile_h: int, tile_w: int, k_steps: int, itemsize: int) -> int:
    """Dynamic shared memory of one block: two state buffers of the tile
    plus its K halo, the reduction scratch, the mask and the row and column
    flags (mirrors smem_bytes in csrc/d2q9_kstep.cu). `itemsize` is the
    compute type's: the buffers of a bfloat16 state hold float32."""
    rh, rw = tile_h + 2 * k_steps, tile_w + 2 * k_steps
    return 2 * 9 * rh * rw * itemsize + 2 * WARPS_PER_BLOCK * itemsize + rh * rw + rh + rw


def _round_up(x: int, a: int) -> int:
    return -(-x // a) * a


def box_smem_bytes(tile_h: int, tile_w: int, k_steps: int, itemsize: int) -> int:
    """Dynamic shared memory of one block on the box path: `smem_bytes` with
    each state buffer on 128 bytes (TMA's boxes), the mbarrier, and 128 bytes
    of slack to align the base (mirrors box_smem in csrc/d2q9_kstep.cu)."""
    rh, rw = tile_h + 2 * k_steps, tile_w + 2 * k_steps
    state = 9 * rh * rw * itemsize
    return (128 + _round_up(state, 128) + _round_up(state, 16) + 16
            + 2 * WARPS_PER_BLOCK * itemsize + rh * rw + rh + rw)


def choose_path(ny: int, nx: int, tile, k_steps: int, itemsize: int, in_place: bool,
                aligned: bool = True, box_smem=box_smem_bytes,
                compute_itemsize: int | None = None) -> str:
    """"box" where TMA can move this launch's regions, else "thread"
    (mirrors box_fits in csrc/d2q9_kstep.cu): no edge tiles; the rows of the
    state (nx) and of the tile (tw), and K values, whole 16-byte pieces, so
    that a region (tw + 2K wide) starts on 16 bytes (an H100 traps on a box
    load at a column 8 bytes off); sides of at most MAX_BOX; every buffer on
    16 bytes (`aligned`); the block in shared memory (`box_smem(th, tw, K,
    itemsize)`: B3 passes its own). In place (B1) a region
    arrives in three boxes a plane and the ring leaves in two, so each of
    their offsets in shared memory must be a multiple of 128 bytes: a plane,
    K and th region rows, a tile plane and th - K tile rows. A state whose
    compute type differs from its storage (bfloat16, `compute_itemsize` 4)
    takes the thread path: a box lands the region as it is stored, where the
    steps need the compute type."""
    if compute_itemsize not in (None, itemsize):
        return "thread"
    th, tw = tile
    k, e = k_steps, itemsize
    rh, rw = th + 2 * k, tw + 2 * k
    fits = (ny % th == 0 and nx % tw == 0 and min(th, tw) >= k and max(rh, rw) <= MAX_BOX
            and (k * e) % 16 == 0 and (tw * e) % 16 == 0 and (nx * e) % 16 == 0 and aligned
            and box_smem(th, tw, k, e) <= SMEM_PER_BLOCK)
    if in_place:
        fits = fits and all(b % 128 == 0 for b in (rh * rw * e, k * rw * e, th * rw * e,
                                                   th * tw * e, (th - k) * tw * e))
    return "box" if fits else "thread"


def aligned16(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's data starts on 16 bytes (TMA's rule)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def blocks_per_sm(in_place: bool, path: str, tile, k_steps: int, itemsize: int) -> int:
    """Blocks of B1 (`in_place`) or B2 in full mode on `path` that one SM of
    the current card holds at this tile and K, for a state of `itemsize`
    bytes a value (2: bfloat16) (the card's occupancy calculator; 0 on an
    error)."""
    from . import _build

    return _build.load("d2q9_kstep").d2q9_kstep_blocks(itemsize, int(in_place),
                                                      PATHS.index(path), *tile, k_steps)


def choose_tile(h: int, w: int, itemsize: int, k_steps: int,
                smem=smem_bytes) -> tuple[int, int] | None:
    """The first of TILE_CANDIDATES that divides the grid and whose block
    fits in shared memory (`smem(th, tw, K, itemsize)`, `itemsize` the
    compute type's) at this K; else the first that fits, whose last row and
    column of tiles are cut to the grid. None only if no candidate fits."""
    fits = [(th, tw) for th, tw in TILE_CANDIDATES
            if smem(th, tw, k_steps, itemsize) <= SMEM_PER_BLOCK]
    return next(((th, tw) for th, tw in fits if h % th == 0 and w % tw == 0),
                fits[0] if fits else None)


def choose_config(h: int, w: int, dtype=torch.float32) -> tuple[int, int, int]:
    """(tile_h, tile_w, k_steps) for the kernels B1 and B2 on this grid."""
    return (*choose_tile(h, w, itemsizes(dtype)[1], PREFERRED_K), PREFERRED_K)


def snapshot_shapes(ny: int, nx: int, tile: tuple[int, int], k_steps: int):
    """Shapes of B1's boundary snapshot: rows around each of the ceil(ny /
    tile_h) horizontal boundaries and columns around each of the ceil(nx /
    tile_w) vertical ones (boundary 0 also closes the last, partial tile)."""
    th, tw = tile
    return (-(-ny // th), 9, 2 * k_steps, nx), (-(-nx // tw), 9, ny, 2 * k_steps)


def simulate_bytes(engine: str, h: int, w: int, dtype=torch.float32, num_steps: int = 0) -> int:
    """Device bytes that `simulate` of a kernel engine holds at its peak on
    an (h, w) grid at choose_config's tile and K: the caller's lattice, the
    first-accelerated copy that `simulate_with` makes, and what the
    wrapper's `run` allocates, with the mask (one byte a cell), the per-step
    sums and the partials. 'cuda' (B2) and 'cuda-manual' (B3) ping-pong two
    lattices: four in all. 'cuda-inplace' (B1) advances the copy in place
    and holds two boundary snapshots of (2K/th + 2K/tw) lattices each
    (`snapshot_shapes`): 3.5 lattices at 16x32, K=4. Lattices and snapshots
    take the storage size, the sums and partials the compute size."""
    itemsize, compute = itemsizes(dtype)
    th, tw, k = choose_config(h, w, dtype)
    lattice = 9 * h * w
    small = h * w + (num_steps + k * -(-h // th) * -(-w // tw)) * compute
    if engine in ("cuda", "cuda-manual"):
        return 4 * lattice * itemsize + small
    if engine == "cuda-inplace":
        snapshot = sum(a * b * c * d for a, b, c, d in snapshot_shapes(h, w, (th, tw), k))
        return (2 * lattice + 2 * snapshot) * itemsize + small
    raise ValueError(f"no kernel engine {engine!r}")


# The 2-D kernel engines that `auto` takes, fastest first, as chip_smoke.py
# measures them on an NVIDIA H100 80GB HBM3 at 700 W (the flagship's MLUPS,
# PERF.md section 6): B2, then B1, which holds half a lattice less. B3 is
# slower than B2 on this card (two blocks an SM against three).
AUTO_ENGINES = ("cuda", "cuda-inplace")


def free_device_bytes(device=None) -> int:
    """Bytes a run on CUDA `device` (default: the current card) may still
    allocate: the card's free memory (cudaMemGetInfo) and what PyTorch's
    caching allocator holds reserved but unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def choose_engine(h: int, w: int, dtype=torch.float32, free_bytes: int | None = None,
                  num_steps: int = 0) -> str:
    """The engine that run_simulation's 'auto' picks for an (h, w) grid.

    As `lbm_tpu.ops.d2q9_pallas.choose_engine`, the measured best engine for
    the grid: the first of AUTO_ENGINES whose run fits in `free_bytes` of
    device memory (`simulate_bytes`; None: `free_device_bytes()` of the
    current card). Every grid with both sides of at least PREFERRED_K goes to
    a kernel; a smaller one to the plain 'torch' engine. Raises
    torch.OutOfMemoryError when no kernel engine fits, as an allocation
    would."""
    if min(h, w) < PREFERRED_K:
        return "torch"
    if free_bytes is None:
        free_bytes = free_device_bytes()
    needs = {e: simulate_bytes(e, h, w, dtype, num_steps) for e in AUTO_ENGINES}
    for engine, need in needs.items():
        if need <= free_bytes:
            return engine
    raise torch.OutOfMemoryError(f"a {h}x{w} {dtype} run needs {needs} bytes of device memory "
                                 f"and {free_bytes} are free")


def obstacle_bool(mask: torch.Tensor) -> torch.Tensor:
    return mask if mask.dtype == torch.bool else mask != 0


def obstacle_u8(mask: torch.Tensor) -> torch.Tensor:
    """The mask as the kernels read it: one byte per cell, nonzero = blocked."""
    if mask.dtype == torch.uint8:
        return mask.contiguous()
    return obstacle_bool(mask).contiguous().view(torch.uint8)


def stepk_plain(
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
    mode: str = "full",
    shared_reciprocal: bool = False,
):
    """The plain PyTorch version of the K-step kernels: K steps of
    `d2q9.collide_fields` on `d2q9.stream_pull`, with per-step Sum|u| over
    the valid window only; in mode "stream_only" K pull-streams with the
    rest-speed plane as |u|, in mode "copy" f itself and a Sum|u| of zeros.
    A bfloat16 state steps in float32 and is rounded once, at the end, with
    a float32 Sum|u|, as the kernels do; its steps divide as the kernels do
    (`d2q9.collide_fields(tensor_scalars=True)`). Returns (f_after_K, tot
    (K,))."""
    check_mode(mode)
    _, ny, nx = f.shape
    if mode == "copy":
        return f.clone(), torch.zeros(k_steps, dtype=compute_dtype(f.dtype), device=f.device)
    rounded = f.dtype == torch.bfloat16
    if rounded:
        f = f.float()
    valid_rows = valid_rows or (0, ny)
    valid_cols = valid_cols or (0, nx)
    rows = torch.arange(ny, device=f.device) + int(row_offset)
    amask = (torch.remainder(rows, global_ny or ny) == accel_row).to(f.dtype)[:, None]
    cols = torch.arange(nx, device=f.device)
    window = (((rows - int(row_offset) >= valid_rows[0]) & (rows - int(row_offset) < valid_rows[1]))[:, None]
              & ((cols >= valid_cols[0]) & (cols < valid_cols[1]))[None, :])
    obstacle = obstacle_bool(mask)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    tots = []
    for _ in range(k_steps):
        if mode == "stream_only":
            f = torch.stack(d2q9.stream_pull(f))
            u = f[0]
        else:
            f, u = d2q9.collide_fields(d2q9.stream_pull(f), obstacle, amask, omega=omega,
                                       accel_w1=accel_w1, accel_w2=accel_w2,
                                       shared_reciprocal=shared_reciprocal,
                                       tensor_scalars=rounded)
        tots.append(torch.where(window, u, zero).sum())
    return (f.to(torch.bfloat16) if rounded else f), torch.stack(tots)


def check_mode(mode: str) -> int:
    """The index of `mode` in MODES, which the C entry points take."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return MODES.index(mode)


def kernel_args(f: torch.Tensor, mask_u8: torch.Tensor, *, k_steps: int, tile,
                omega: float, accel_w1: float, accel_w2: float, accel_row: int,
                row_offset: int = 0, valid_rows: tuple | None = None,
                valid_cols: tuple | None = None, global_ny: int | None = None,
                mode: str = "full", smem=smem_bytes):
    """Checks a CUDA call of a K-step kernel (B1, B2; B3 with its own `smem`)
    and returns (tile, ntiles, the trailing scalar arguments of its C entry
    point)."""
    mode_index = check_mode(mode)
    if f.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on {f.device}")
    if f.dim() != 3 or f.shape[0] != 9:
        raise ValueError(f"state must have shape (9, ny, nx), got {tuple(f.shape)}")
    if f.dtype not in DTYPES:
        raise ValueError(f"the kernel takes float32, float64 or bfloat16, got {f.dtype}")
    if not f.is_contiguous():
        raise ValueError("state must be contiguous")
    _, ny, nx = f.shape
    if mask_u8.shape != (ny, nx) or mask_u8.device != f.device or mask_u8.dtype != torch.uint8:
        raise ValueError(f"mask must be ({ny}, {nx}) uint8 on {f.device}")
    if not 1 <= k_steps <= MAX_STEPS_PER_PASS:
        raise ValueError(f"k_steps must be in 1..{MAX_STEPS_PER_PASS}, got {k_steps}")
    if min(ny, nx) < k_steps:
        # B1's snapshot windows of 2K rows and columns each wrap at most once
        raise ValueError(f"the {ny}x{nx} grid has a side shorter than k_steps={k_steps}")
    compute = itemsizes(f.dtype)[1]
    if tile is None:
        tile = choose_tile(ny, nx, compute, k_steps, smem)
        if tile is None:
            raise ValueError(f"no tile of {TILE_CANDIDATES} fits shared memory at K={k_steps}")
    th, tw = tile
    if min(th, tw) < k_steps:
        # B1 hands each pass the K-deep ring of every tile as the next
        # pass's halo snapshot; all kernels keep one rule
        raise ValueError(f"tile {tile} has a side shorter than k_steps={k_steps}")
    if smem(th, tw, k_steps, compute) > SMEM_PER_BLOCK:
        raise ValueError(f"tile {tile} at K={k_steps} needs more than {SMEM_PER_BLOCK} B "
                         "of shared memory")
    valid_rows = valid_rows or (0, ny)
    valid_cols = valid_cols or (0, nx)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    scalars = [ny, nx, th, tw, int(k_steps), int(row_offset), int(valid_rows[0]),
               int(valid_rows[1]), int(global_ny or ny), int(valid_cols[0]),
               int(valid_cols[1]), int(accel_row), mode_index, float(omega), float(accel_w1),
               float(accel_w2), stream]
    return (th, tw), -(-ny // th) * -(-nx // tw), scalars


def check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


TYPE_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}


def _entry(f: torch.Tensor, name: str, source: str = "d2q9_kstep"):
    from . import _build

    return getattr(_build.load(source), f"{name}_{TYPE_SUFFIX[f.dtype]}")


def launch_path(f: torch.Tensor, tile, k_steps: int, in_place: bool, *buffers) -> str:
    """The path of a CUDA launch on state f and `buffers` (choose_path)."""
    _, ny, nx = f.shape
    itemsize, compute = itemsizes(f.dtype)
    return choose_path(ny, nx, tile, k_steps, itemsize, in_place, aligned16(f, *buffers),
                       compute_itemsize=compute)


def sums(f: torch.Tensor, n: int) -> torch.Tensor:
    """n values of scratch for the per-step sums of a kernel on f (float32
    for a bfloat16 state)."""
    return torch.empty(n, dtype=compute_dtype(f.dtype), device=f.device)


def _launch(f, mask_u8, out, partials, tot, path, scalars, recip=False):
    global launches, last_path
    launches += 1
    last_path = path
    name = "d2q9_kstep_recip" if recip else "d2q9_kstep"
    rc = _entry(f, name)(f.data_ptr(), mask_u8.data_ptr(), out.data_ptr(),
                         partials.data_ptr(), tot.data_ptr(), PATHS.index(path), *scalars)
    check_rc(rc, f"{name} ({path} path)")


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
    shared_reciprocal: bool = False,
):
    """K fused timesteps in one pass (kernel B2 on CUDA, `stepk_plain` on
    the CPU). Returns (f_after_K_steps, tot_u per step (K,)); f is unchanged.
    shared_reciprocal: the collision takes 1/rho once and multiplies (full
    mode; the other modes do not collide)."""
    window = dict(row_offset=row_offset, valid_rows=valid_rows, valid_cols=valid_cols,
                  global_ny=global_ny, mode=mode)
    if f.device.type == "cpu":
        return stepk_plain(f, mask, k_steps=k_steps, omega=omega, accel_w1=accel_w1,
                           accel_w2=accel_w2, accel_row=accel_row,
                           shared_reciprocal=shared_reciprocal, **window)
    mask_u8 = obstacle_u8(mask)
    tile, ntiles, scalars = kernel_args(
        f, mask_u8, k_steps=k_steps, tile=tile, omega=omega, accel_w1=accel_w1,
        accel_w2=accel_w2, accel_row=accel_row, **window)
    out = torch.empty_like(f)
    partials, tot = sums(f, k_steps * ntiles), sums(f, k_steps)
    _launch(f, mask_u8, out, partials, tot, launch_path(f, tile, k_steps, False, out), scalars,
            recip=shared_reciprocal and mode == "full")
    return out, tot


def step(f, mask, **kw):
    """One fused timestep. Returns (f', tot_u scalar)."""
    f_new, tots = stepk(f, mask, k_steps=1, **kw)
    return f_new, tots[0]


def run_plain(f, mask, *, num_steps: int, k_steps: int, mode: str = "full", kernel: str = "B2",
              **kw):
    """`num_steps` timesteps in passes of `stepk_plain`, the CPU route of
    every wrapper's `run`; `kernel` names the wrapper's kernel in a trace.
    Returns (f_final, tot_u (num_steps,))."""
    if num_steps % k_steps:
        raise ValueError(f"num_steps {num_steps} not a multiple of k_steps {k_steps}")
    tots = sums(f, num_steps)
    for i in profiling.passes(num_steps // k_steps, kernel, "plain", k_steps):
        f, tots[i * k_steps:(i + 1) * k_steps] = stepk_plain(f, mask, k_steps=k_steps,
                                                             mode=mode, **kw)
        if profiling.NAN_DEBUG:
            profiling.check_nans(f, (i + 1) * k_steps, "a K-step pass (plain version)", k_steps)
    return f, tots


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
    shared_reciprocal: bool = False,
):
    """`num_steps` timesteps, `k_steps` per pass, ping-ponging between two
    lattices. Returns (f_final, tot_u (num_steps,)); f is unchanged.
    shared_reciprocal as in `stepk`."""
    kw = dict(omega=omega, accel_w1=accel_w1, accel_w2=accel_w2, accel_row=accel_row)
    if f.device.type == "cpu":
        return run_plain(f, mask, num_steps=num_steps, k_steps=k_steps, mode=mode,
                         shared_reciprocal=shared_reciprocal, **kw)
    if num_steps % k_steps:
        raise ValueError(f"num_steps {num_steps} not a multiple of k_steps {k_steps}")
    tots = sums(f, num_steps)
    mask_u8 = obstacle_u8(mask)
    tile, ntiles, scalars = kernel_args(f, mask_u8, k_steps=k_steps, tile=tile, mode=mode, **kw)
    bufs = (torch.empty_like(f), torch.empty_like(f))
    path = launch_path(f, tile, k_steps, False, *bufs)
    partials = sums(f, k_steps * ntiles)
    recip = shared_reciprocal and mode == "full"
    for i in profiling.passes(num_steps // k_steps, "B2", path, k_steps):
        out = bufs[i % 2]
        _launch(f, mask_u8, out, partials, tots[i * k_steps:(i + 1) * k_steps], path, scalars,
                recip)
        f = out
        if profiling.NAN_DEBUG:
            profiling.check_nans(f, (i + 1) * k_steps, "kernel B2 (d2q9_kstep)", k_steps)
    return f, tots


def simulate_with(run_fn, params: Params, f: torch.Tensor, obstacle_mask: torch.Tensor):
    """First-accelerate, then max_iters steps through `run_fn` (the `run`
    of a kernel's wrapper), at the K of `choose_k(max_iters)`. Returns
    (f_final, av_vels) as `d2q9.simulate` does."""
    aw = d2q9.AccelWeights.from_params(params)
    accel_row = params.ny - 2
    f = d2q9.first_accelerate(f, obstacle_mask, accel_row=accel_row,
                              accel_w1=aw.w1, accel_w2=aw.w2)
    f_final, tot_u = run_fn(f, obstacle_mask, num_steps=params.max_iters, omega=params.omega,
                            accel_w1=aw.w1, accel_w2=aw.w2, accel_row=accel_row,
                            k_steps=choose_k(params.max_iters))
    num_free = (~obstacle_bool(obstacle_mask)).sum().to(f.dtype)
    return f_final, tot_u / num_free


def simulate(params: Params, f: torch.Tensor, obstacle_mask: torch.Tensor):
    """Full simulation on kernel B2. Same contract as `d2q9.simulate`."""
    return simulate_with(run, params, f, obstacle_mask)
