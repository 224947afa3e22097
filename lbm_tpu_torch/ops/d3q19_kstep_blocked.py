"""K D3Q19 steps of every tile in one trip: the wrapper of CUDA kernel B7
(blocked, two-stream).

The counterpart of the `by=` half of `lbm_tpu.ops.d3q19_pallas` (kernel
`_blocked_kernel`, `choose_config`, `stepk(by=...)`, `run(by=...)`). One launch
of `blocked_kernel` in `csrc/d3q19_blocked.cu` advances the whole lattice K
steps: a thread block loads its (tz, ty, tx) tile with a K-cell halo on six
sides into shared memory, steps K times there and writes its tile once. See
the note at the top of the source for the design and its bound on the card.

The contract of `stepk` is that of `d3q19_kstep.stepk`, with `tile` and
`threads` in place of `block`. The force is tested on a halo plane at its
wrapped index, ((p mod nz) + plane_offset) mod global_nz, so
`d3q19_kstep.stepk_plain` is the plain version of this kernel too, for every
window; the TPU kernel tests the unwrapped index and agrees whenever
global_nz == nz or the accelerated plane lies more than K planes from the
array's first and last plane.

The kernel moves a tile's region in one of two ways (`PATHS`), which
`choose_path` picks per launch from the shape and the buffers' alignment:
"box", where the Tensor Memory Accelerator brings the region in as 19 boxes,
one a speed taken one streaming step early, or "thread", every value by the
threads, for the shapes TMA cannot take (rows that are not whole 16-byte
pieces, box sides over 256, a region beyond the grid). On both the last step
stores the tile by the threads. The launch reports the path in `last_path`;
a box launch whose tensor map does not encode raises. `path="thread"`
forces the thread path, to compare the two.

B7 has no diagnostic modes (`stepk(mode=...)` refuses any but "full", as
`lbm_tpu.ops.d3q19_pallas.stepk(by=...)` does); B5 has them
(`d3q19_kstep_inplace_blocked`).

On a CUDA tensor the kernel is launched, or the call raises (a tile that does
not fit the device's shared memory raises and names the engine that takes the
shape); on a CPU tensor `stepk_plain` runs. There is no other route.

A bfloat16 state takes the thread path: its tile sits in shared memory as
float32, steps in float32 and is rounded once, at the last step's store. Its
tiles are the float32 thread path's bests (THREAD_TILES): bfloat16 was not
swept.
"""

from __future__ import annotations

import torch

from . import d3q19_kstep, passes
from .d2q9_kstep import check_mode, check_rc, compute_dtype, obstacle_u8
from .d3q19_kstep import MAX_K

# Launches of kernel B7 (one per K-step pass); callers may reset it.
launches = 0
# The path of the last launch of B7 ("box" or "thread").
last_path = None
# how a launch moves its regions, by index in the C entry points (Path)
PATHS = ("thread", "box")
MAX_BOX = 256  # TMA's longest side of a box, in values

# Shared memory a block may opt in to on an H100 (232,448 bytes), assumed for
# a tensor that is not on a CUDA device, and what the kernel declares
# statically beside the tile (the reduction's scratch).
H100_SMEM_PER_BLOCK = 227 * 1024
STATIC_SMEM = 128
# Threads of a block: the kernel's launch bounds (128 registers a thread at
# float32, 255 at float64). With the bounds doubled, 1024 threads were no
# faster in float32, and 512 in float64 (98 registers each) left an SM one
# block where two of 256 fit: 0.47 against 0.33 ms at K=1.
MAX_THREADS = {torch.float32: 512, torch.float64: 256, torch.bfloat16: 512}
# Tile extents that `choose_config` tries where no measured tile applies.
TILE_X = (8, 16, 32, 64)
TILE_YZ_MAX = 16
# The sweep of experiments/cuda-kstep-tiles/results3d_blocked.csv (NVIDIA H100
# 80GB HBM3, 700 W, 32x256x256, 967 (tile, threads, K, type) cases, each tile
# on the path `choose_path` gives it) found B7 and B5 slower than B6 and B4 at
# every K in both types, so they run only when named (`ops.d3q19.resolve_engine`).
# The fastest tiles of that sweep by (type, K), B7's first, then B5's under
# its scratch limit, and the thread count each ran at where it is not
# MAX_THREADS: on the box path 256 threads leave room for two blocks an SM
# (0.3133 against 0.3454 ms at K = 2 in float32). Many others lie within
# 10%.
MEASURED_TILES = {
    (torch.float32, 1): ((2, 6, 64), (4, 4, 64)), (torch.float32, 2): ((4, 4, 32),),
    (torch.float32, 3): ((8, 8, 8), (3, 8, 16)), (torch.float32, 4): ((4, 6, 8), (2, 10, 8)),
    (torch.float64, 1): ((2, 8, 32), (4, 4, 32)), (torch.float64, 2): ((4, 4, 16),),
    (torch.float64, 3): ((4, 4, 8), (3, 6, 8)), (torch.float64, 4): ((1, 2, 8),),
}
MEASURED_THREADS = {
    (torch.float32, 1, (2, 6, 64)): 256, (torch.float32, 1, (4, 4, 64)): 256,
    (torch.float32, 2, (4, 4, 32)): 256,
}
# The thread path's fastest tiles by K, B7's first, then B5's under its
# scratch limit, at MAX_THREADS unless named: the sweep made when the thread
# path was the only one (NVIDIA H100 80GB HBM3, 700 W, float32, 32x256x256,
# experiments/cuda-kstep-tiles/results3d_blocked_pr4.csv: B7 0.1727, 0.3395,
# 0.6821, 1.5731 ms a pass, B5 0.3762, 0.5769, 1.0413, 1.8742). A bfloat16
# state's buffer holds float32, so these are its tiles (`choose_config`).
THREAD_TILES = {1: ((4, 5, 16), (6, 16, 16)), 2: ((8, 6, 16), (6, 8, 16)),
                3: ((8, 8, 8), (5, 10, 8)), 4: ((5, 6, 8), (5, 6, 8))}
THREAD_TILE_THREADS = {(1, (4, 5, 16)): 256}
# Steps per pass that `choose_k` prefers: B7 takes 0.156, 0.157, 0.241 and
# 0.453 ms per step at K = 1..4 in float32, B5 0.380, 0.302, 0.388 and 0.716.
PREFERRED_K = 2


def smem_per_block(device) -> int:
    """Shared memory a block may opt in to on `device`; an H100's for a
    device that is not CUDA."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    if device.type != "cuda":
        return H100_SMEM_PER_BLOCK
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", H100_SMEM_PER_BLOCK))


def extended_cells(tile: tuple[int, int, int], k_steps: int) -> int:
    tz, ty, tx = tile
    return (tz + 2 * k_steps) * (ty + 2 * k_steps) * (tx + 2 * k_steps)


def shared_bytes(tile: tuple[int, int, int], k_steps: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of a block: 19 values of the compute type and a
    mask byte per cell of the tile extended by K cells per side."""
    itemsize = torch.empty((), dtype=compute_dtype(dtype)).element_size()
    return extended_cells(tile, k_steps) * (19 * itemsize + 1)


def box_extent(tile: tuple[int, int, int], k_steps: int, itemsize: int):
    """(nz_b, ny_b, sx, lp) of the box path's buffer (mirrors ext_of in
    csrc/d3q19_blocked.cu): planes [1, ez - 1) and rows [1, ey - 1) of the
    extended tile, each speed's box taken one streaming step early in z and
    y; rows of sx values from round_up(K, a) columns before the tile to as
    many after it (a = 16 / itemsize values: a box load starts on 16 bytes),
    the extended tile's first column lp values in."""
    tz, ty, tx = tile
    a = 16 // itemsize
    rk = -(-k_steps // a) * a
    return tz + 2 * k_steps - 2, ty + 2 * k_steps - 2, tx + 2 * rk, rk - k_steps


def box_shared_bytes(tile: tuple[int, int, int], k_steps: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of a block on the box path: 19 speeds of the
    buffer's cells, each speed's plane on 128 bytes, a mask byte a cell, 128
    bytes of slack to align the base and the mbarrier, on 8 bytes (mirrors
    shared_bytes in csrc/d3q19_blocked.cu)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nz_b, ny_b, sx, _ = box_extent(tile, k_steps, itemsize)
    cells = nz_b * ny_b * sx
    pitch = -(-cells * itemsize // 128) * 128
    return 128 + -(-(19 * pitch + cells) // 8) * 8 + 8


def choose_path(nz: int, ny: int, nx: int, tile: tuple[int, int, int], k_steps: int,
                dtype=torch.float32, aligned: bool = True, device=None) -> str:
    """"box" where TMA can move this launch's region, else "thread" (mirrors
    box_fits in csrc/d3q19_blocked.cu): rows of the lattice (nx) and of the
    tile (tx) whole 16-byte pieces; box sides of at most MAX_BOX, the
    extended tile no larger than the grid; the block in the device's shared
    memory; the lattice on 16 bytes (`aligned`). bfloat16: "thread", whose
    buffer holds float32."""
    if dtype == torch.bfloat16:
        return "thread"
    tz, ty, tx = tile
    itemsize = torch.empty((), dtype=dtype).element_size()
    ez, ey, sx = tz + 2 * k_steps, ty + 2 * k_steps, box_extent(tile, k_steps, itemsize)[2]
    fits = ((tx * itemsize) % 16 == 0 and (nx * itemsize) % 16 == 0
            and max(ez, ey, sx) <= MAX_BOX and ez <= nz and ey <= ny and sx <= nx
            and box_shared_bytes(tile, k_steps, dtype) <= smem_per_block(device) - STATIC_SMEM
            and aligned)
    return "box" if fits else "thread"


def block_bytes(nz: int, ny: int, nx: int, tile, k_steps: int, dtype=torch.float32,
                aligned: bool = True, device=None) -> int:
    """Dynamic shared memory of a block on the path `choose_path` gives the
    launch."""
    box = choose_path(nz, ny, nx, tile, k_steps, dtype, aligned, device) == "box"
    return (box_shared_bytes if box else shared_bytes)(tile, k_steps, dtype)


def resolve_path(path: str | None, f: torch.Tensor, tile, k_steps: int) -> str:
    """The path of a launch on f: choose_path's, or "thread" when asked for
    (to compare the two). Asking for "box" where the rule says "thread", or
    for "thread" where its block does not fit, raises."""
    _, nz, ny, nx = f.shape
    chosen = choose_path(nz, ny, nx, tile, k_steps, f.dtype, f.data_ptr() % 16 == 0, f.device)
    if path is None or path == chosen:
        return chosen
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if path == "box":
        raise ValueError(f"the box path does not take tile {tuple(tile)} at k_steps={k_steps} "
                         f"on {nz}x{ny}x{nx} {f.dtype} (choose_path)")
    if not thread_fits(tile, k_steps, f.dtype, f.device):
        raise ValueError(f"tile {tuple(tile)} at k_steps={k_steps} does not fit the thread path's "
                         f"shared memory ({shared_bytes(tile, k_steps, f.dtype)} bytes)")
    return path


def thread_fits(tile, k_steps: int, dtype=torch.float32, device=None) -> bool:
    """Whether a block of the thread path fits the device's shared memory."""
    return shared_bytes(tile, k_steps, dtype) <= smem_per_block(device) - STATIC_SMEM


def loaded_per_kept(tile: tuple[int, int, int], k_steps: int) -> float:
    """Cells a block loads for every cell it keeps."""
    tz, ty, tx = tile
    return extended_cells(tile, k_steps) / (tz * ty * tx)


def _load_cost(tile, k_steps, itemsize) -> float:
    """32-byte sectors a block loads per sector it stores: each row of the
    extended tile starts K cells before a sector boundary."""
    tz, ty, tx = tile
    rows = (tz + 2 * k_steps) * (ty + 2 * k_steps)
    per_row = -(-(tx + 2 * k_steps) * itemsize // 32) + 1
    return rows * per_row / (tz * ty * tx * itemsize / 32)


def scratch_planes(tile: tuple[int, int, int], k_steps: int, nz: int) -> tuple[int, int]:
    """(planes of the ring, planes of the snapshot) that the in-place kernel
    B5 keeps beside the lattice: ceil(K / tz) + 2 rows of tz planes (the
    launch of a row flushes a ring row while it writes another), and the
    first min(K, nz) planes."""
    tz = tile[0]
    return (-(-k_steps // tz) + 2) * tz, min(k_steps, nz)


def choose_config(nz: int, ny: int, nx: int, k_steps: int = PREFERRED_K,
                  dtype=torch.float32, device=None, *,
                  max_scratch_planes: int | None = None) -> tuple[int, int, int]:
    """The tile (tz, ty, tx) of a K-step pass on `device` (its opt-in shared
    memory; an H100's for the CPU): the first of MEASURED_TILES that fits the
    shared memory and the grid (B5's first where `max_scratch_planes` is
    given); else, among the tiles that fit, the one that
    loads the fewest sectors per sector kept, then the widest. With
    `max_scratch_planes` (the in-place kernel), only tiles whose ring and
    snapshot hold at most that many planes. Raises when nothing fits."""
    if not 1 <= k_steps <= MAX_K:
        raise ValueError(f"k_steps must be in 1..{MAX_K}, got {k_steps}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    budget = smem_per_block(device) - STATIC_SMEM

    def allowed(tile):
        return (block_bytes(nz, ny, nx, tile, k_steps, dtype, device=device) <= budget
                and (max_scratch_planes is None
                     or sum(scratch_planes(tile, k_steps, nz)) <= max_scratch_planes))

    measured = (THREAD_TILES[k_steps] if dtype == torch.bfloat16
                else MEASURED_TILES.get((dtype, k_steps), ()))
    if max_scratch_planes is not None:  # B5: its own measured tile first
        measured = measured[::-1]
    for tile in measured:
        if tile[0] <= nz and tile[1] <= ny and tile[2] <= nx and allowed(tile):
            return tile
    best = None
    for tx in TILE_X:
        if tx > max(nx, TILE_X[0]):
            continue
        for tz in range(1, min(nz, TILE_YZ_MAX) + 1):
            for ty in range(1, min(ny, TILE_YZ_MAX) + 1):
                tile = (tz, ty, tx)
                if min(shared_bytes(tile, k_steps, dtype),
                       box_shared_bytes(tile, k_steps, dtype)) > budget:
                    break
                if not allowed(tile):
                    continue
                key = (_load_cost(tile, k_steps, itemsize), -tx, tz)
                if best is None or key < best[0]:
                    best = (key, tile)
    if best is None:
        raise ValueError(
            f"no tile of the blocked kernel fits {budget} bytes of shared memory for "
            f"{nz}x{ny}x{nx} {dtype} at k_steps={k_steps}; use engine='cuda' or 'cuda-inplace' "
            "(the one-step kernels take any shape)")
    return best[1]


def choose_k(*step_counts: int) -> int:
    """Steps per pass of the blocked kernels for a run: PREFERRED_K when it
    divides every one of `step_counts`, else the largest smaller K that does."""
    return next(k for k in range(PREFERRED_K, 0, -1) if all(n % k == 0 for n in step_counts))


def kernel_args(f: torch.Tensor, mask_u8: torch.Tensor, *, k_steps: int,
                tile: tuple | None = None, threads: int | None = None,
                max_scratch_planes: int | None = None, **window):
    """Checks a CUDA call of either blocked kernel and returns (tile, number
    of tiles, the trailing scalar arguments of its C entry point)."""
    d3q19_kstep.check_state(f, mask_u8, k_steps)
    _, nz, ny, nx = f.shape
    if tile is None:
        tile = choose_config(nz, ny, nx, k_steps, f.dtype, f.device,
                             max_scratch_planes=max_scratch_planes)
    tz, ty, tx = (int(t) for t in tile)
    if min(tz, ty, tx) < 1:
        raise ValueError(f"tile {tile} must have positive extents")
    limit = MAX_THREADS[f.dtype]
    measured = (THREAD_TILE_THREADS.get((int(k_steps), (tz, ty, tx))) if f.dtype == torch.bfloat16
                else MEASURED_THREADS.get((f.dtype, int(k_steps), (tz, ty, tx))))
    threads = (measured or limit) if threads is None else int(threads)
    if threads < 32 or threads % 32 or threads > limit:
        raise ValueError(f"threads must be a multiple of 32 in 32..{limit} for {f.dtype}, "
                         f"got {threads}")
    need = block_bytes(nz, ny, nx, (tz, ty, tx), k_steps, f.dtype,
                       f.data_ptr() % 16 == 0, f.device) + STATIC_SMEM
    have = smem_per_block(f.device)
    if need > have:
        raise ValueError(
            f"tile {(tz, ty, tx)} at k_steps={k_steps} needs {need} bytes of shared memory, the "
            f"device gives a block {have}; use a smaller tile, or engine='cuda' or "
            "'cuda-inplace' (the one-step kernels take any shape)")
    gz, gy, gx = -(-nz // tz), -(-ny // ty), -(-nx // tx)
    if gz > 65535 or gy > 65535:
        raise ValueError(f"tile {(tz, ty, tx)} gives a grid of {gz} x {gy} x {gx} tiles, beyond "
                         "65535 along z or y")
    scalars = [nz, ny, nx, tz, ty, tx, threads, int(k_steps),
               *d3q19_kstep.window_scalars(f, **window)]
    return (tz, ty, tx), gz * gy * gx, scalars


def entry(f: torch.Tensor, name: str):
    return d3q19_kstep.entry(f, name, "d3q19_blocked")


def _launch(f, mask_u8, out, partials, tot, path, scalars):
    global launches, last_path
    launches += 1
    last_path = path
    rc = entry(f, "d3q19_blocked")(f.data_ptr(), mask_u8.data_ptr(), out.data_ptr(),
                                   partials.data_ptr(), tot.data_ptr(), check_mode("full"),
                                   PATHS.index(path), *scalars)
    check_rc(rc, "d3q19_blocked")


def refuse_mode(mode: str) -> None:
    """B7 has no diagnostic modes, as the TPU's blocked two-stream kernel has
    none (`lbm_tpu.ops.d3q19_pallas.stepk(by=...)`)."""
    if mode != "full":
        raise ValueError(f"mode={mode!r}: the (z, y)-blocked two-stream kernel has no "
                         "diagnostic modes; the in-place one has (d3q19_kstep_inplace_blocked)")


def stepk(
    f: torch.Tensor,
    mask: torch.Tensor,
    *,
    k_steps: int,
    omega: float,
    density: float,
    accel: float,
    accel_plane: int,
    plane_offset: int = 0,
    valid_planes: tuple | None = None,
    valid_rows: tuple | None = None,
    global_nz: int | None = None,
    tile: tuple[int, int, int] | None = None,
    threads: int | None = None,
    mode: str = "full",
    path: str | None = None,
):
    """K timesteps in one trip (kernel B7 on CUDA, `stepk_plain` on the CPU).
    Returns (f_after_K_steps, tot_u per step (K,)); f is unchanged. A `mode`
    other than "full" is refused; `path` as in `resolve_path`."""
    refuse_mode(mode)
    kw = dict(k_steps=k_steps, omega=omega, density=density, accel=accel,
              accel_plane=accel_plane, plane_offset=plane_offset, valid_planes=valid_planes,
              valid_rows=valid_rows, global_nz=global_nz)
    if f.device.type == "cpu":
        return d3q19_kstep.stepk_plain(f, mask, **kw)
    mask_u8 = obstacle_u8(mask)
    tile, ntiles, scalars = kernel_args(f, mask_u8, tile=tile, threads=threads, **kw)
    out = torch.empty_like(f)
    partials, tot = d3q19_kstep.sums(f, k_steps * ntiles), d3q19_kstep.sums(f, k_steps)
    _launch(f, mask_u8, out, partials, tot, resolve_path(path, f, tile, k_steps), scalars)
    return out, tot


def run(
    f: torch.Tensor,
    mask: torch.Tensor,
    *,
    num_steps: int,
    omega: float,
    density: float,
    accel: float,
    accel_plane: int,
    k_steps: int = 1,
    tile: tuple[int, int, int] | None = None,
    threads: int | None = None,
    mode: str = "full",
    path: str | None = None,
):
    """`num_steps` timesteps, `k_steps` per trip, between two lattices beside
    the caller's. Returns (f_final, tot_u (num_steps,)); f is unchanged. A
    `mode` other than "full" is refused; `path` as in `resolve_path`."""
    refuse_mode(mode)
    kw = dict(omega=omega, density=density, accel=accel, accel_plane=accel_plane)
    if f.device.type == "cpu":
        return passes.run_plain(d3q19_kstep.stepk_plain, f, mask, num_steps=num_steps,
                                k_steps=k_steps, kernel="B7", **kw)
    mask_u8 = obstacle_u8(mask)
    tile, ntiles, scalars = kernel_args(f, mask_u8, k_steps=k_steps, tile=tile,
                                        threads=threads, **kw)
    partials = d3q19_kstep.sums(f, k_steps * ntiles)
    other = None

    def launch_pass(i, cur, tot):
        # the first pass leaves the caller's f alone; later ones swap two lattices
        nonlocal other
        out = torch.empty_like(f) if i < 2 else other
        _launch(cur, mask_u8, out, partials, tot, resolve_path(path, cur, tile, k_steps),
                scalars)
        other = cur if i else None
        return out

    # a trace names the loop by its first pass's path, resolved only then
    return passes.run(f, num_steps=num_steps, k_steps=k_steps, kernel="B7",
                      path=lambda: resolve_path(path, f, tile, k_steps),
                      launch_pass=launch_pass, what="kernel B7 (d3q19_kstep_blocked)")
