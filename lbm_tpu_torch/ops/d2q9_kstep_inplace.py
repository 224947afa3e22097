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
from . import d2q9_kstep, passes

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
    partials, tot = d2q9_kstep.sums(f, k_steps * ntiles), d2q9_kstep.sums(f, k_steps)
    snap = _snapshot(f, tile, k_steps)
    _launch(f, mask_u8, snap, True, None, partials, tot,
            d2q9_kstep.launch_path(f, tile, k_steps, True, *snap), scalars)
    return f, tot


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
        return passes.run_plain(d2q9_kstep.stepk_plain, f, mask, num_steps=num_steps,
                                k_steps=k_steps, kernel="B1", in_place=True, mode=mode, **kw)
    mask_u8 = d2q9_kstep.obstacle_u8(mask)
    tile, ntiles, scalars = d2q9_kstep.kernel_args(f, mask_u8, k_steps=k_steps, tile=tile,
                                                   mode=mode, **kw)
    snaps = (_snapshot(f, tile, k_steps), _snapshot(f, tile, k_steps))
    path = d2q9_kstep.launch_path(f, tile, k_steps, True, *snaps[0], *snaps[1])
    partials = d2q9_kstep.sums(f, k_steps * ntiles)

    def launch_pass(i, f, tot):
        _launch(f, mask_u8, snaps[i % 2], i == 0, snaps[(i + 1) % 2], partials, tot, path,
                scalars)
        return f

    return passes.run(f, num_steps=num_steps, k_steps=k_steps, kernel="B1", path=path,
                      launch_pass=launch_pass, what="kernel B1 (d2q9_kstep_inplace)")


def snapshot_plain(f: torch.Tensor, tile, k_steps: int):
    """B1's boundary snapshot of f, as the kernel lays it out
    (csrc/d2q9_kstep.cu): hband[b, q, i] is row (b*th - K + i) mod ny of
    plane q, vband[b, q, y, i] column (b*tw - K + i) mod nx of row y."""
    rowmap, colmap = _snapshot_maps(f.shape[1], f.shape[2], tile, k_steps, f.device)
    return (f[:, rowmap].permute(1, 0, 2, 3).contiguous(),
            f[:, :, colmap].permute(2, 0, 1, 3).contiguous())


def _snapshot_maps(ny, nx, tile, k_steps, device):
    th, tw = tile
    i = torch.arange(2 * k_steps, device=device)
    rowmap = (torch.arange(-(-ny // th), device=device)[:, None] * th - k_steps + i) % ny
    colmap = (torch.arange(-(-nx // tw), device=device)[:, None] * tw - k_steps + i) % nx
    return rowmap, colmap


class SnapshotPatch:
    """Copies given rows (every column) and columns (every row) of a state
    into a boundary snapshot of it (`snapshot_plain`'s layout): call with
    (snapshot, f). Each band's entries that hold such a cell, and the cell,
    are found once, as flat indices: a refresh is a gather and a scatter a
    band."""

    def __init__(self, ny: int, nx: int, tile, k_steps: int, rows, cols, device):
        rowmap, colmap = _snapshot_maps(ny, nx, tile, k_steps, device)
        hit_rows = torch.zeros(ny, dtype=torch.bool, device=device)
        hit_cols = torch.zeros(nx, dtype=torch.bool, device=device)
        hit_rows[torch.as_tensor(rows, dtype=torch.long, device=device)] = True
        hit_cols[torch.as_tensor(cols, dtype=torch.long, device=device)] = True
        q = torch.arange(9, device=device)
        # hband[b, q, i, x] holds f[q, rowmap[b, i], x]
        r = rowmap[:, None, :, None]
        x = torch.arange(nx, device=device)[None, None, None, :]
        src = ((q[None, :, None, None] * ny + r) * nx + x).expand(-1, -1, -1, nx)
        hit = (hit_rows[r] | hit_cols[x]).expand_as(src)
        self.h_dst, self.h_src = hit.reshape(-1).nonzero().squeeze(1), src[hit]
        # vband[b, q, y, i] holds f[q, y, colmap[b, i]]
        y = torch.arange(ny, device=device)[None, None, :, None]
        c = colmap[:, None, None, :]
        src = ((q[None, :, None, None] * ny + y) * nx + c).expand(-1, 9, ny, -1)
        hit = (hit_rows[y] | hit_cols[c]).expand_as(src)
        self.v_dst, self.v_src = hit.reshape(-1).nonzero().squeeze(1), src[hit]

    def __call__(self, snap, f: torch.Tensor) -> None:
        hband, vband = snap
        flat = f.view(-1)
        hband.view(-1).index_copy_(0, self.h_dst, flat.index_select(0, self.h_src))
        vband.view(-1).index_copy_(0, self.v_dst, flat.index_select(0, self.v_src))


class Chain:
    """Passes of B1 over one state that the caller rewrites in part between
    passes: the rows `rows` (every column) and the columns `cols` (every
    row), as the ghost bands of `parallel.kstep_sharded`. Like `run`, each
    pass writes the next one's boundary snapshot; before a pass, `__call__`
    copies the rewritten cells from f into the snapshot that pass reads, so
    it equals a fresh snapshot of f (`snapshot_plain`) at a fraction of its
    cost. rows=None: the caller rewrites all of f, and every pass takes its
    snapshot. The kernel's arguments are checked once. On the CPU each pass
    is `d2q9_kstep.stepk_plain`.

    Construct with stepk's keywords (k_steps, omega, accel_w1, accel_w2,
    accel_row, row_offset, valid_rows, valid_cols, global_ny, tile); a call
    is one pass, writing Sum|u| per step into `tot` (K,)."""

    def __init__(self, f: torch.Tensor, mask: torch.Tensor, *, rows, cols=(), tile=None,
                 **kw):
        self.f, self.kw = f, kw
        self.passes = 0
        if f.device.type == "cpu":
            self.mask = mask
            return
        self.mask = d2q9_kstep.obstacle_u8(mask)
        k = kw["k_steps"]
        tile, ntiles, self.scalars = d2q9_kstep.kernel_args(f, self.mask, tile=tile, **kw)
        self.snaps = (_snapshot(f, tile, k), _snapshot(f, tile, k))
        self.path = d2q9_kstep.launch_path(f, tile, k, True, *self.snaps[0], *self.snaps[1])
        self.partials = d2q9_kstep.sums(f, k * ntiles)
        self.patch = (None if rows is None else
                      SnapshotPatch(f.shape[1], f.shape[2], tile, k, rows, cols, f.device))

    def __call__(self, tot: torch.Tensor) -> None:
        if self.f.device.type == "cpu":
            f_new, tot[:] = d2q9_kstep.stepk_plain(self.f, self.mask, **self.kw)
            self.f.copy_(f_new)
        elif self.patch is None:
            _launch(self.f, self.mask, self.snaps[0], True, None, self.partials, tot,
                    self.path, self.scalars)
        else:
            snap, next_snap = self.snaps[self.passes % 2], self.snaps[(self.passes + 1) % 2]
            if self.passes:
                self.patch(snap, self.f)
            _launch(self.f, self.mask, snap, self.passes == 0, next_snap, self.partials, tot,
                    self.path, self.scalars)
            self.passes += 1


def simulate(params: Params, f: torch.Tensor, obstacle_mask: torch.Tensor):
    """Full simulation on kernel B1. Same contract as `d2q9.simulate`; the
    caller's f is left as it was (first_accelerate makes the copy that the
    passes then advance in place)."""
    return d2q9_kstep.simulate_with(run, params, f, obstacle_mask)
