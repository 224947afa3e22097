"""K D3Q19 steps of every tile in one trip, written back in place: the wrapper
of CUDA kernel B5, and the choice between the two in-place 3-D kernels.

The counterpart of `lbm_tpu.ops.d3q19_pallas_inplace_blocked` (kernel
`_kernel`, `choose_config`, `pick_engine`, `choose_k`, `stepk`, `run`), with
the contract of `d3q19_kstep_blocked` except that the state is advanced IN
PLACE: `stepk` and `run` overwrite `f` and return it.

Blocks run in no order on the card, so the z-rows of tiles go in order as
stream-ordered launches of B7's kernel, each writing to a ring of
ceil(K / tz) + 2 rows in device memory; once no later row reads a row's old
planes, the next row's launch flushes it into `f` with extra blocks, and the
last rows read planes [0, K) from a snapshot taken first
(csrc/d3q19_blocked.cu). One call of the C entry point is one pass: every
cell makes one trip per K steps. Beside the lattice a run holds the ring and
the snapshot (`scratch_planes`); `choose_config` keeps them under 0.45 of
the lattice where the grid has the planes for it. B5's state is
bit-identical to B7's and, with the same tile and threads, so is its Sum|u|.
A launch takes B7's path (`d3q19_kstep_blocked.choose_path`) and reports it
in `last_path`.

`stepk` and `run` take `mode`, the TPU kernel's diagnostic modes
(`d2q9_kstep.MODES`, `lbm_tpu.ops.d3q19_pallas_inplace_blocked.stepk(mode=)`):
"full", "stream_only" (K pull-streams without bounce-back or collision,
Sum|u| the window sum of the rest-speed plane) or "copy" (the state
unchanged, through the same load, store and ring; Sum|u| zeros, where the
TPU kernel adds a token). `d3q19_kstep.stepk_plain(mode=)` is their plain
version.

`pick_engine` and `choose_k` choose for the engine 'cuda-inplace' between this
kernel and the one-step kernel B4 (`d3q19_kstep_inplace`, the 'slab' kind, after
the TPU's z-slab kernel that it replaces), by what was measured on the card.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import d3q19_kstep, d3q19_kstep_blocked
from .d2q9_kstep import check_mode, check_rc, obstacle_u8
from .d3q19_kstep_blocked import PATHS, PREFERRED_K, scratch_planes  # noqa: F401  (B5's own)

# Launches of kernel B5 (one per K-step pass); callers may reset it.
launches = 0
# The path of the last launch of B5 ("box" or "thread").
last_path = None

# Share of the lattice's planes that ring and snapshot may take, and the
# planes they may take on a grid too shallow for that share.
SCRATCH_SHARE = 0.45
SCRATCH_MIN_PLANES = 8


def max_scratch_planes(nz: int, k_steps: int) -> int:
    return max(int(SCRATCH_SHARE * nz), SCRATCH_MIN_PLANES + k_steps)


def choose_config(nz: int, ny: int, nx: int, k_steps: int = PREFERRED_K,
                  dtype=torch.float32, device=None) -> tuple[int, int, int]:
    """The tile (tz, ty, tx) of an in-place K-step pass: B7's rule
    (`d3q19_kstep_blocked.choose_config`) among the tiles whose ring and
    snapshot stay within `max_scratch_planes`."""
    return d3q19_kstep_blocked.choose_config(
        nz, ny, nx, k_steps, dtype, device,
        max_scratch_planes=max_scratch_planes(nz, k_steps))


def pick_engine(nz: int, ny: int, nx: int, k_steps: int = PREFERRED_K,
                dtype=torch.float32, device=None):
    """('slab', None) or ('blocked', tile) for the in-place engine
    'cuda-inplace': kernel B4 (one launch per step) or B5 (K steps per trip),
    whichever was the faster on the card at this K and type
    (`d3q19_kstep_blocked.MS_PER_PASS`, measured at 32x256x256; both take time
    in proportion to the cells): as measured, B4 at every K."""
    if d3q19_kstep_blocked.faster_kind(dtype, "b4", "b5", k_steps) == "slab":
        return "slab", None
    return "blocked", choose_config(nz, ny, nx, k_steps, dtype, device)


def choose_k(nz: int, ny: int, nx: int, *step_counts: int, dtype=torch.float32, device=None):
    """('slab' | 'blocked', tile or None, k) for a run of the in-place engine:
    the kind's preferred K when it divides every one of `step_counts` (the
    total, and the chunk of a checkpointed run), else the largest smaller K
    that does, and the kind `pick_engine` names at that K."""
    return d3q19_kstep_blocked.kind_and_k(pick_engine, nz, ny, nx, step_counts, dtype, device)


def _scratch(f, tile, k_steps):
    """The ring and the snapshot of a pass at this tile, as one tensor each."""
    _, nz, ny, nx = f.shape
    ring_planes, snap_planes = scratch_planes(tile, k_steps, nz)
    ring = torch.empty((19, ring_planes, ny, nx), dtype=f.dtype, device=f.device)
    snap = torch.empty((19, snap_planes, ny, nx), dtype=f.dtype, device=f.device)
    return ring, snap


def _launch(f, mask_u8, ring, snap, partials, tot, mode, path, scalars):
    global launches, last_path
    launches += 1
    last_path = path
    rc = d3q19_kstep_blocked.entry(f, "d3q19_blocked_inplace")(
        f.data_ptr(), mask_u8.data_ptr(), ring.data_ptr(), snap.data_ptr(),
        partials.data_ptr(), tot.data_ptr(), check_mode(mode), PATHS.index(path), *scalars)
    check_rc(rc, "d3q19_blocked_inplace")


def _kernel_args(f, mask_u8, *, k_steps, tile, threads, **window):
    nz = f.shape[1] if f.dim() == 4 else 0
    return d3q19_kstep_blocked.kernel_args(
        f, mask_u8, k_steps=k_steps, tile=tile, threads=threads,
        max_scratch_planes=max_scratch_planes(nz, k_steps), **window)


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
    """K timesteps in one in-place trip (kernel B5 on CUDA,
    `d3q19_kstep.stepk_plain` on the CPU) in `mode`. Overwrites f with the
    state after K steps; returns (f, tot_u per step (K,)). `path` as in
    `d3q19_kstep_blocked.resolve_path`."""
    check_mode(mode)
    kw = dict(k_steps=k_steps, omega=omega, density=density, accel=accel,
              accel_plane=accel_plane, plane_offset=plane_offset, valid_planes=valid_planes,
              valid_rows=valid_rows, global_nz=global_nz)
    if f.device.type == "cpu":
        f_new, tot = d3q19_kstep.stepk_plain(f, mask, mode=mode, **kw)
        f.copy_(f_new)
        return f, tot
    mask_u8 = obstacle_u8(mask)
    tile, ntiles, scalars = _kernel_args(f, mask_u8, tile=tile, threads=threads, **kw)
    ring, snap = _scratch(f, tile, k_steps)
    partials, tot = d3q19_kstep.sums(f, k_steps * ntiles), d3q19_kstep.sums(f, k_steps)
    path = d3q19_kstep_blocked.resolve_path(path, f, tile, k_steps)
    _launch(f, mask_u8, ring, snap, partials, tot, mode, path, scalars)
    return f, tot


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
    """`num_steps` timesteps, `k_steps` per in-place trip, in `mode`.
    Overwrites f; returns (f, tot_u (num_steps,)). `path` as in
    `d3q19_kstep_blocked.resolve_path`."""
    check_mode(mode)
    if num_steps % k_steps:
        raise ValueError(f"num_steps {num_steps} not a multiple of k_steps {k_steps}")
    kw = dict(omega=omega, density=density, accel=accel, accel_plane=accel_plane)
    tots = d3q19_kstep.sums(f, num_steps)
    if f.device.type == "cpu":
        for i in profiling.passes(num_steps // k_steps, "B5", "plain", k_steps):
            f_new, tots[i * k_steps:(i + 1) * k_steps] = d3q19_kstep.stepk_plain(
                f, mask, k_steps=k_steps, mode=mode, **kw)
            f.copy_(f_new)
        return f, tots
    mask_u8 = obstacle_u8(mask)
    tile, ntiles, scalars = _kernel_args(f, mask_u8, k_steps=k_steps, tile=tile,
                                         threads=threads, **kw)
    ring, snap = _scratch(f, tile, k_steps)
    partials = d3q19_kstep.sums(f, k_steps * ntiles)
    path = d3q19_kstep_blocked.resolve_path(path, f, tile, k_steps)
    for i in profiling.passes(num_steps // k_steps, "B5", path, k_steps):
        _launch(f, mask_u8, ring, snap, partials, tots[i * k_steps:(i + 1) * k_steps], mode,
                path, scalars)
    return f, tots
