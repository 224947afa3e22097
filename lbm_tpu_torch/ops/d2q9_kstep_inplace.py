"""K fused D2Q9 steps per pass, written back in place: the wrapper of CUDA
kernel B1, the engine `auto` takes when B2's lattices do not fit.

The counterpart of `lbm_tpu.ops.d2q9_pallas_inplace` (kernel `_kernel`),
with the `stepk`/`run`/`simulate` contract of `d2q9_kstep` except that the
state is advanced IN PLACE: `stepk` and `run` overwrite `f` and return it.
`run` needs no second lattice, but holds two boundary snapshots of
(2K/tile_h + 2K/tile_w) of a lattice each, 0.75 at 16x32, K=4: a simulation
holds 3.5 lattices where B2's holds 4 (`d2q9_kstep.simulate_bytes`), so B1
saves half a lattice, not one.

The TPU kernel is safe in place because its bands run in order (delayed
write-back, wraparound snapshot). On the card blocks run in no order, so the
kernel reads its halo from a snapshot of the rows and columns around every
tile boundary (csrc/d2q9_kstep.cu). `stepk` takes the snapshot from f before
its pass; `run` takes it once and then lets each pass write the next pass's
snapshot from shared memory, alternating between two buffers. With the same
tiles, B1's state and Sum|u| are bit-identical to B2's.
"""

from __future__ import annotations

import torch

from ..core.params import Params
from . import d2q9_kstep

# Launches of kernel B1 (one per K-step pass); callers may reset it.
launches = 0
# The path of the last launch of B1 ("box" or "thread").
last_path = None


def _launch(f, mask_u8, snap, take_snapshot, next_snap, partials, tot, path, scalars):
    """One pass on `path`. snap = (hband, vband) holds the boundary snapshot,
    filled from f first when take_snapshot; next_snap receives the snapshot
    for the next pass, or is None."""
    global launches, last_path
    launches += 1
    last_path = path
    nh, nv = (0, 0) if next_snap is None else (next_snap[0].data_ptr(), next_snap[1].data_ptr())
    rc = d2q9_kstep._entry(f, "d2q9_kstep_inplace")(
        f.data_ptr(), mask_u8.data_ptr(), snap[0].data_ptr(), snap[1].data_ptr(),
        int(take_snapshot), nh, nv, partials.data_ptr(), tot.data_ptr(),
        d2q9_kstep.PATHS.index(path), *scalars)
    d2q9_kstep.check_rc(rc, f"d2q9_kstep_inplace ({path} path)")


def _snapshot(f, tile, k_steps):
    hshape, vshape = d2q9_kstep.snapshot_shapes(f.shape[1], f.shape[2], tile, k_steps)
    return (torch.empty(hshape, dtype=f.dtype, device=f.device),
            torch.empty(vshape, dtype=f.dtype, device=f.device))


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
    """K fused timesteps in one in-place pass (kernel B1 on CUDA,
    `d2q9_kstep.stepk_plain` on the CPU). Overwrites f with the state after
    K steps; returns (f, tot_u per step (K,))."""
    kw = dict(k_steps=k_steps, omega=omega, accel_w1=accel_w1, accel_w2=accel_w2,
              accel_row=accel_row, row_offset=row_offset, valid_rows=valid_rows,
              valid_cols=valid_cols, global_ny=global_ny, mode=mode)
    if f.device.type == "cpu":
        f_new, tot = d2q9_kstep.stepk_plain(f, mask, **kw)
        f.copy_(f_new)
        return f, tot
    mask_u8 = d2q9_kstep.obstacle_u8(mask)
    tile, ntiles, scalars = d2q9_kstep.kernel_args(f, mask_u8, tile=tile, **kw)
    partials = torch.empty(k_steps * ntiles, dtype=f.dtype, device=f.device)
    tot = torch.empty(k_steps, dtype=f.dtype, device=f.device)
    snap = _snapshot(f, tile, k_steps)
    _launch(f, mask_u8, snap, True, None, partials, tot,
            d2q9_kstep.launch_path(f, tile, k_steps, True, *snap), scalars)
    return f, tot


def step(f, mask, **kw):
    """One fused timestep in place. Returns (f, tot_u scalar)."""
    f, tots = stepk(f, mask, k_steps=1, **kw)
    return f, tots[0]


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
    """`num_steps` timesteps, `k_steps` per in-place pass. Overwrites f;
    returns (f, tot_u (num_steps,)). The first pass snapshots f's tile
    boundaries; each pass then hands the next one its snapshot."""
    kw = dict(omega=omega, accel_w1=accel_w1, accel_w2=accel_w2, accel_row=accel_row)
    if f.device.type == "cpu":
        f_new, tots = d2q9_kstep.run_plain(f, mask, num_steps=num_steps, k_steps=k_steps,
                                           mode=mode, **kw)
        f.copy_(f_new)
        return f, tots
    if num_steps % k_steps:
        raise ValueError(f"num_steps {num_steps} not a multiple of k_steps {k_steps}")
    tots = torch.empty(num_steps, dtype=f.dtype, device=f.device)
    mask_u8 = d2q9_kstep.obstacle_u8(mask)
    tile, ntiles, scalars = d2q9_kstep.kernel_args(f, mask_u8, k_steps=k_steps, tile=tile,
                                                   mode=mode, **kw)
    snaps = (_snapshot(f, tile, k_steps), _snapshot(f, tile, k_steps))
    path = d2q9_kstep.launch_path(f, tile, k_steps, True, *snaps[0], *snaps[1])
    partials = torch.empty(k_steps * ntiles, dtype=f.dtype, device=f.device)
    for i in range(num_steps // k_steps):
        _launch(f, mask_u8, snaps[i % 2], i == 0, snaps[(i + 1) % 2], partials,
                tots[i * k_steps:(i + 1) * k_steps], path, scalars)
    return f, tots


def simulate(params: Params, f: torch.Tensor, obstacle_mask: torch.Tensor):
    """Full simulation on kernel B1. Same contract as `d2q9.simulate`; the
    caller's f is left as it was (first_accelerate makes the copy that the
    passes then advance in place)."""
    return d2q9_kstep.simulate_with(run, params, f, obstacle_mask)
