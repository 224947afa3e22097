"""Halo exchange between the ranks of a mesh: point-to-point rings.

The counterpart of `lbm_tpu.parallel.halo`. The reference benchmarked five
halo-exchange strategies on the IPU (main/HaloRegionApproaches.cpp) and
found compiler-scheduled "implicit" exchange fastest, with the two-wave
explicit variant (N-S wave then E-W wave, corners riding the waves,
:359-519) the best explicit scheme. Here:

  * ``implicit``  — the global step applied to a DTensor sharded over the
    mesh: PyTorch's DTensor chooses the collectives. A roll along a sharded
    dim all-gathers that dim and keeps the local slice (12 all-gathers a
    step on a (2, 2) mesh, no halo exchange); the state stays sharded.
  * ``ppermute``  — the explicit step: one N-S ring wave of boundary rows,
    then one E-W wave of boundary columns of the row-extended block, so the
    corner speeds cross diagonally in two hops (the 2Wave trick). Periodic
    wraparound falls out of the ring.
  * ``manytensors`` — a ghost-extended block whose 8 ghost regions are
    overwritten by per-direction sends (explicitManyTensors analogue).
  * ``allgather`` / ``naive`` — deliberately-heavy baselines (see below).

A ring shift is a `batch_isend_irecv` pair on the mesh axis's ranks; on an
axis of one rank it is a local copy (what `ppermute` with the identity
permutation does). Every strategy keeps the single-device semantics: a step
on an N-rank mesh equals the global step.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..core.params import Params
from ..ops import d2q9
from ..utils import profiling
from . import mesh as mesh_lib

ROW, COL = mesh_lib.ROW_AXIS, mesh_lib.COL_AXIS


def start_ring_shift(x: torch.Tensor, mesh: DeviceMesh, axis: str, direction: int):
    """Start passing `x` to the neighbour `direction` steps along `axis`
    (periodic; +1: to the next-higher index). Returns (the buffer that will
    hold what arrives, the works to wait on)."""
    if mesh_lib.axis_size(mesh, axis) == 1:
        return x.clone(memory_format=torch.contiguous_format), []
    send = x.contiguous()
    recv = torch.empty_like(send)
    group = mesh.get_group(axis)
    ops = [dist.P2POp(dist.isend, send, mesh_lib.neighbour(mesh, axis, direction), group),
           dist.P2POp(dist.irecv, recv, mesh_lib.neighbour(mesh, axis, -direction), group)]
    return recv, dist.batch_isend_irecv(ops)


def wait(works) -> None:
    for w in works:
        w.wait()


def shift_into(dst: torch.Tensor, x: torch.Tensor, mesh: DeviceMesh, axis: str,
               direction: int) -> None:
    """ring_shift(x, ...) written into `dst` (a view, e.g. a buffer's ghost
    band): what arrives lands in a contiguous staging tensor and is copied
    in; on an axis of one rank, x is copied straight in."""
    if mesh_lib.axis_size(mesh, axis) == 1:
        dst.copy_(x)
    else:
        dst.copy_(ring_shift(x, mesh, axis, direction))


def ring_shift(x: torch.Tensor, mesh: DeviceMesh, axis: str, direction: int) -> torch.Tensor:
    """Pass `x` to the neighbour `direction` steps along `axis` (periodic)
    and return what arrives from the other side."""
    recv, works = start_ring_shift(x, mesh, axis, direction)
    wait(works)
    return recv


def exchange_halos_2wave(f_loc: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """(C, h, w) local block -> (C, h+2, w+2) with periodic ghost ring.

    Wave 1 (N-S): boundary rows ride the 'ry' ring. Wave 2 (E-W): boundary
    columns of the row-extended block ride the 'rx' ring — ghost corners
    arrive via two hops, never a diagonal send (the 2Wave insight,
    HaloRegionApproaches.cpp:359-519).
    """
    # wave 1: rows. ghost row below = real top row of the southern neighbour.
    ghost_south = ring_shift(f_loc[:, -1:, :], mesh, ROW, +1)  # from row-shard i-1
    ghost_north = ring_shift(f_loc[:, :1, :], mesh, ROW, -1)   # from row-shard i+1
    ext = torch.cat([ghost_south, f_loc, ghost_north], dim=1)
    # wave 2: columns of the extended block (corners included).
    ghost_west = ring_shift(ext[:, :, -1:], mesh, COL, +1)
    ghost_east = ring_shift(ext[:, :, :1], mesh, COL, -1)
    return torch.cat([ghost_west, ext, ghost_east], dim=2)


def _stream_from_ext(ext: torch.Tensor, h: int, w: int) -> tuple[torch.Tensor, ...]:
    """Pull-streaming by slicing the ghost-extended block: speed k at local
    cell (jj, ii) = ext[k, jj+1-dy, ii+1-dx]."""

    def sl(k, dy, dx):
        return ext[k, 1 - dy: 1 - dy + h, 1 - dx: 1 - dx + w]

    return (sl(0, 0, 0), sl(1, 0, 1), sl(2, 1, 0), sl(3, 0, -1), sl(4, -1, 0),
            sl(5, 1, 1), sl(6, 1, -1), sl(7, -1, -1), sl(8, -1, 1))


def _all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> list[torch.Tensor]:
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(mesh_lib.axis_size(mesh, axis))]
    dist.all_gather(out, x, group=mesh.get_group(axis))
    return out


def exchange_halos_allgather(f_loc: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Same contract as exchange_halos_2wave, but each shard all-gathers the
    boundary rows/cols of EVERY shard and selects its neighbours' — the
    deliberately-heavy strategy, kept as the analogue of the reference's
    worst performer `explicitOneTensor` (HaloRegionApproaches.cpp:522-738)
    for the strategy-comparison experiment."""
    my_r, my_c = mesh_lib.block_coords(mesh)
    nr, nc = mesh_lib.axis_size(mesh, ROW), mesh_lib.axis_size(mesh, COL)
    tops = _all_gather(f_loc[:, -1:, :], mesh, ROW)
    bots = _all_gather(f_loc[:, :1, :], mesh, ROW)
    ext = torch.cat([tops[(my_r - 1) % nr], f_loc, bots[(my_r + 1) % nr]], dim=1)
    lefts = _all_gather(ext[:, :, -1:], mesh, COL)
    rights = _all_gather(ext[:, :, :1], mesh, COL)
    return torch.cat([lefts[(my_c - 1) % nc], ext, rights[(my_c + 1) % nc]], dim=2)


def exchange_halos_naive(f_loc: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Deliberately-chatty exchange: every edge AND every corner is its own
    collective (12 total: 4 edges + 4 corners x 2 hops), each waited on
    before the next is sent, so nothing batches or overlaps.

    The analogue of the reference's worst performer `explicitOneTensor`
    (HaloRegionApproaches.cpp:522-738): per-direction sequential copies
    serialised into 99.9% sync time. Correct physics; never use it for
    production.
    """
    ghost_s = ring_shift(f_loc[:, -1:, :], mesh, ROW, +1)
    ghost_n = ring_shift(f_loc[:, :1, :], mesh, ROW, -1)
    ghost_w = ring_shift(f_loc[:, :, -1:], mesh, COL, +1)
    ghost_e = ring_shift(f_loc[:, :, :1], mesh, COL, -1)

    def corner(cell, row_dir, col_dir):
        return ring_shift(ring_shift(cell, mesh, ROW, row_dir), mesh, COL, col_dir)

    c_sw = corner(f_loc[:, -1:, -1:], +1, +1)  # from (ri-1, ci-1)
    c_se = corner(f_loc[:, -1:, :1], +1, -1)   # from (ri-1, ci+1)
    c_nw = corner(f_loc[:, :1, -1:], -1, +1)   # from (ri+1, ci-1)
    c_ne = corner(f_loc[:, :1, :1], -1, -1)    # from (ri+1, ci+1)

    bottom = torch.cat([c_sw, ghost_s, c_se], dim=2)
    middle = torch.cat([ghost_w, f_loc, ghost_e], dim=2)
    top = torch.cat([c_nw, ghost_n, c_ne], dim=2)
    return torch.cat([bottom, middle, top], dim=1)


def exchange_halos_manytensors(f_loc: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Persistent-ghost-buffer strategy: the shard's block lives ghost-
    extended ((C, h+2, w+2)) and its 8 ghost regions are overwritten by
    per-direction messages — 4 corner-free edge sends plus 4 one-cell corner
    sends (each corner routed as two axis hops) — each written into the
    extended block in place rather than rebuilt by concatenation.

    The analogue of the reference's ``explicitManyTensors``
    (HaloRegionApproaches.cpp:166-357). All 8 first hops are started before
    any is waited on. Ghost contents are identical to exchange_halos_2wave."""
    c, h, w = f_loc.shape
    ext = f_loc.new_zeros((c, h + 2, w + 2))
    ext[:, 1:h + 1, 1:w + 1] = f_loc
    firsts = [start_ring_shift(x, mesh, axis, d) for x, axis, d in (
        (f_loc[:, -1:, :], ROW, +1), (f_loc[:, :1, :], ROW, -1),      # ghost_s, ghost_n
        (f_loc[:, :, -1:], COL, +1), (f_loc[:, :, :1], COL, -1),      # ghost_w, ghost_e
        (f_loc[:, -1:, -1:], ROW, +1), (f_loc[:, -1:, :1], ROW, +1),  # corners' first hop
        (f_loc[:, :1, -1:], ROW, -1), (f_loc[:, :1, :1], ROW, -1))]
    for _, works in firsts:
        wait(works)
    (g_s, _), (g_n, _), (g_w, _), (g_e, _) = firsts[:4]
    ext[:, 0:1, 1:w + 1] = g_s
    ext[:, h + 1:h + 2, 1:w + 1] = g_n
    ext[:, 1:h + 1, 0:1] = g_w
    ext[:, 1:h + 1, w + 1:w + 2] = g_e
    # corners: second hop along the columns
    for (x, _), col_dir, (r0, c0) in zip(firsts[4:], (+1, -1, +1, -1),
                                         ((0, 0), (0, w + 1), (h + 1, 0), (h + 1, w + 1))):
        ext[:, r0:r0 + 1, c0:c0 + 1] = ring_shift(x, mesh, COL, col_dir)
    return ext


def exchange_halos_none(f_loc: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Local-periodic ghost ring WITHOUT any inter-shard communication.
    Physically wrong at shard boundaries — exists only as the zero-exchange
    cost baseline for the exchange-vs-compute experiment."""
    ext = torch.cat([f_loc[:, -1:, :], f_loc, f_loc[:, :1, :]], dim=1)
    return torch.cat([ext[:, :, -1:], ext, ext[:, :, :1]], dim=2)


def exchange_halos_2wave_padded(f_loc: torch.Tensor, mesh: DeviceMesh, pad_rows: int,
                                pad_cols: int) -> torch.Tensor:
    """2-wave exchange for pad-and-mask uneven grids (the runtime analogue of
    the reference's remainder-row strategies, StructuredGridUtils.hpp:309-412).

    The global grid is padded so it divides the mesh; all padding sits at the
    top of the LAST row-shard / the east of the LAST column-shard. The torus
    therefore wraps at each shard's top *valid* row/col, not its block edge:
    every shard sends its top valid row (only the last shard's differs) and
    each receiver writes the incoming north/east ghost at its own valid edge
    + 1 too (the appended position for unpadded shards, a padding row/col on
    the last). Cells above/right of the ghost are dead padding: masked as
    obstacles, excluded from Sum|u|, never read by valid cells.
    """
    _, h, w = f_loc.shape
    my_r, my_c = mesh_lib.block_coords(mesh)
    tv = h - 1 - (pad_rows if my_r == mesh_lib.axis_size(mesh, ROW) - 1 else 0)
    ghost_south = ring_shift(f_loc[:, tv:tv + 1, :], mesh, ROW, +1)
    ghost_north = ring_shift(f_loc[:, :1, :], mesh, ROW, -1)
    ext = torch.cat([ghost_south, f_loc, ghost_north], dim=1)
    ext[:, tv + 2:tv + 3, :] = ghost_north

    lv = w - 1 - (pad_cols if my_c == mesh_lib.axis_size(mesh, COL) - 1 else 0)
    ghost_west = ring_shift(ext[:, :, lv:lv + 1], mesh, COL, +1)
    ghost_east = ring_shift(ext[:, :, :1], mesh, COL, -1)
    ext = torch.cat([ghost_west, ext, ghost_east], dim=2)
    ext[:, :, lv + 2:lv + 3] = ghost_east
    return ext


EXCHANGES = {
    "ppermute": exchange_halos_2wave,
    "manytensors": exchange_halos_manytensors,
    "allgather": exchange_halos_allgather,
    "naive": exchange_halos_naive,
    "none": exchange_halos_none,
}


def make_sharded_step(mesh: DeviceMesh, *, omega: float, accel_w1: float, accel_w2: float,
                      exchange: str = "ppermute", pad_rows: int = 0, pad_cols: int = 0):
    """Explicit-exchange distributed step: f (9, ny, nx) DTensor sharded over
    (ry, rx); returns (f', tot_u) with tot_u summed over the mesh
    (`mesh.sum_by_rank`) — the analogue of the reference's distributed
    averageVelocity reduction (main/LbmAoS.cpp:25-93). pad_rows/pad_cols > 0
    selects the pad-and-mask uneven-grid exchange (ppermute only)."""
    if (pad_rows or pad_cols) and exchange != "ppermute":
        raise ValueError(
            f"uneven grids (padding) support only the 'ppermute' strategy, "
            f"not {exchange!r}"
        )
    if pad_rows or pad_cols:
        exchange_fn = functools.partial(exchange_halos_2wave_padded, pad_rows=pad_rows,
                                        pad_cols=pad_cols)
    elif exchange in EXCHANGES:
        exchange_fn = EXCHANGES[exchange]
    else:
        raise ValueError(f"unknown strategy {exchange!r}")

    def step(f, obstacle_mask, accel_mask):
        f_loc = f.to_local()
        _, h, w = f_loc.shape
        s = _stream_from_ext(exchange_fn(f_loc, mesh), h, w)
        f_new, tot = d2q9.collide(s, obstacle_mask.to_local(), accel_mask.to_local(),
                                  omega=omega, accel_w1=accel_w1, accel_w2=accel_w2)
        return (DTensor.from_local(f_new, mesh, f.placements, run_check=False),
                mesh_lib.sum_by_rank(tot, mesh))

    return step


def run_sharded(
    f: DTensor,
    obstacle_mask: DTensor,
    accel_mask: DTensor,
    *,
    mesh: DeviceMesh,
    num_steps: int,
    omega: float,
    accel_w1: float,
    accel_w2: float,
    exchange: str = "ppermute",
    pad_rows: int = 0,
    pad_cols: int = 0,
):
    """num_steps explicit-halo steps. Returns (f_final DTensor, tot_u
    (num_steps,) in the state's type, the same on every rank)."""
    step = make_sharded_step(mesh, omega=omega, accel_w1=accel_w1, accel_w2=accel_w2,
                             exchange=exchange, pad_rows=pad_rows, pad_cols=pad_cols)
    tots = torch.empty(num_steps, dtype=f.dtype, device=f.to_local().device)
    for i in range(num_steps):
        f, tots[i] = step(f, obstacle_mask, accel_mask)
        if profiling.NAN_DEBUG:
            profiling.check_nans(f, i + 1, f"the sharded step ({exchange})")
    return f, tots


def prepare_sharded(
    params: Params,
    f,
    obstacle_mask,
    mesh: DeviceMesh,
    strategy: str = "ppermute",
    *,
    first_accelerate: bool = True,
):
    """Lay the state out on the mesh ready for run_sharded: pad-and-mask if
    the grid does not divide the mesh, shard it, and apply the one-off
    guarded acceleration (skip with first_accelerate=False when resuming
    from a checkpoint — the state is already accelerated). `f` and the mask
    are the full arrays, the same on every rank (f a numpy array, or a host
    bfloat16 tensor). Returns (f, padded_mask, amask, (pad_rows, pad_cols)),
    the first three DTensors on this rank's device."""
    aw = d2q9.AccelWeights.from_params(params)
    accel_row = params.ny - 2
    ny, nx = params.ny, params.nx
    n_r, n_c = mesh.shape

    padded_mask = np.asarray(obstacle_mask, bool)
    pad_r = pad_c = 0
    if ny % n_r or nx % n_c:
        if strategy == "implicit":
            # the implicit step's global roll would wrap through padding
            raise ValueError(
                f"{ny}x{nx} does not divide the {n_r}x{n_c} mesh; the "
                "'implicit' strategy cannot lay out uneven shards — use "
                "strategy='ppermute' (pad-and-mask)"
            )
        pad_r, pad_c = mesh_lib.shard_padding(ny, nx, n_r, n_c)
        # padding cells are equilibrium-filled obstacles, never read by
        # valid cells (the padded exchange wraps at the valid edge)
        f, padded_mask = mesh_lib.pad_grid(params, f, obstacle_mask, pad_r, pad_c)

    device = mesh_lib.local_device()
    f_full = mesh_lib.full_tensor(f, device)
    mask_full = torch.from_numpy(np.ascontiguousarray(padded_mask)).to(device)
    if first_accelerate:
        # elementwise, so the full array gives every block's bits
        f_full = d2q9.first_accelerate(f_full, mask_full, accel_row=accel_row,
                                       accel_w1=aw.w1, accel_w2=aw.w2)
    amask = d2q9.accel_row_mask(ny + pad_r, nx + pad_c, accel_row, dtype=f_full.dtype,
                                device=device)
    return (mesh_lib.shard(f_full, mesh, mesh_lib.grid_placements()),
            mesh_lib.shard(mask_full, mesh, mesh_lib.mask_placements()),
            mesh_lib.shard(amask, mesh, mesh_lib.row_placements()),
            (pad_r, pad_c))


def dtensor_roll(x: DTensor, shifts, dims) -> DTensor:
    """torch.roll of a DTensor: the rolled dims all-gathered (redistributed
    to Replicate on the mesh dims that shard them), rolled, and each rank's
    block kept — the collectives of PyTorch's own sharding rule for roll,
    which some builds lack (`NotImplementedError: Operator aten.roll.default
    does not have a sharding strategy registered`)."""
    rolled = {d % x.ndim for d in (dims if isinstance(dims, tuple) else (dims,))}
    full = [Replicate() if isinstance(p, Shard) and p.dim in rolled else p
            for p in x.placements]
    mesh = x.device_mesh
    local = torch.roll(x.redistribute(mesh, full).to_local(), shifts, dims)
    return DTensor.from_local(local, mesh, full, run_check=False).redistribute(mesh, x.placements)


def run_implicit(f, obstacle_mask, accel_mask, *, num_steps, omega, accel_w1, accel_w2):
    """The 'implicit' strategy: the global step (`d2q9.collide` of
    `d2q9.stream_pull`) on the DTensors, PyTorch's DTensor choosing the
    collectives: an all-gather of each rolled dim (`dtensor_roll`), the rest
    elementwise on the blocks. Returns (f_final DTensor, tot_u (num_steps,)
    as a plain tensor, the same on every rank), as `run_global_step`."""
    def step(f):
        return d2q9.collide(d2q9.stream_pull(f, roll=dtensor_roll), obstacle_mask, accel_mask,
                            omega=omega, accel_w1=accel_w1, accel_w2=accel_w2)

    return run_global_step(step, f, num_steps)


def run_global_step(step, f: DTensor, num_steps: int):
    """num_steps of step(f) -> (f', Sum|u|) on a DTensor state. Sum|u| comes
    out as partial sums, one a rank (Partial placements); they are added by
    `mesh.sum_by_rank`, in rank order, not by the all-reduce PyTorch would
    choose, whose order follows the vector's length (so a run in chunks
    would round otherwise than a whole one). Returns (f_final DTensor, tot_u
    (num_steps,) as a plain tensor, the same on every rank)."""
    tots = []
    for i in range(num_steps):
        f, tot = step(f)
        if profiling.NAN_DEBUG:
            profiling.check_nans(f, i + 1, "the global step")
        if not all(isinstance(p, Partial) and p.reduce_op == "sum" for p in tot.placements):
            raise RuntimeError(f"the implicit step's Sum|u| came out as {tot.placements}, "
                               "not partial sums")
        tots.append(tot.to_local())
    mesh = f.device_mesh
    return f, mesh_lib.sum_by_rank(torch.stack(tots) if tots else f.to_local().new_zeros(0),
                                   mesh)


def run_strategy(strategy: str, f, obstacle_mask, accel_mask, *, mesh, num_steps, omega,
                 accel_w1, accel_w2, pad_rows=0, pad_cols=0):
    """num_steps of `strategy` on the laid-out state. Returns (f_final
    DTensor, tot_u (num_steps,))."""
    kw = dict(num_steps=num_steps, omega=omega, accel_w1=accel_w1, accel_w2=accel_w2)
    if strategy == "implicit":
        return run_implicit(f, obstacle_mask, accel_mask, **kw)
    if strategy not in EXCHANGES:
        raise ValueError(f"unknown strategy {strategy!r}")
    return run_sharded(f, obstacle_mask, accel_mask, mesh=mesh, exchange=strategy,
                       pad_rows=pad_rows, pad_cols=pad_cols, **kw)


def simulate_sharded(
    params: Params,
    f,
    obstacle_mask,
    mesh: DeviceMesh,
    *,
    strategy: str = "ppermute",
    allow_invalid: bool = False,
):
    """Full reference-semantics simulation on a mesh of ranks.

    strategy='ppermute': explicit halo rings (this module).
    strategy='implicit': global step on DTensors; PyTorch chooses the
    collectives (the reference's winning "implicit" scheme).
    strategy='allgather' / 'naive' / 'manytensors': the other exchanges.
    ('none' is a physically-WRONG zero-communication cost baseline and is
    rejected here unless allow_invalid=True.)

    Grids that do not divide the mesh run via pad-and-mask (ppermute only).
    Returns (f_final, av_vels): the full (9, ny, nx) state and the (max_iters,)
    average velocities, the same on every rank.
    """
    if strategy == "none" and not allow_invalid:
        raise ValueError(
            "'none' skips halo exchange and gives wrong physics; it is a "
            "cost baseline only (pass allow_invalid=True if you mean it)"
        )
    if strategy != "implicit" and strategy not in EXCHANGES:
        raise ValueError(f"unknown strategy {strategy!r}")
    f, padded_mask, amask, (pad_r, pad_c) = prepare_sharded(
        params, f, obstacle_mask, mesh, strategy)
    aw = d2q9.AccelWeights.from_params(params)
    f_final, tot_u = run_strategy(strategy, f, padded_mask, amask, mesh=mesh,
                                  num_steps=params.max_iters, omega=params.omega,
                                  accel_w1=aw.w1, accel_w2=aw.w2, pad_rows=pad_r,
                                  pad_cols=pad_c)
    f_full = f_final.full_tensor()[:, :params.ny, :params.nx]
    num_free = torch.tensor(int((~np.asarray(obstacle_mask, bool)).sum()), dtype=tot_u.dtype,
                            device=tot_u.device)
    return f_full, tot_u / num_free


def with_ring(fn, x: DTensor, *others: DTensor) -> DTensor:
    """fn(ext, *other blocks) on each rank, where ext is x's block with a
    one-cell periodic ring from its neighbours (`exchange_halos_2wave`);
    returns the result as a DTensor laid out like x. The sharded depthwise
    convolution of the blur (`ops.stencil.blur_step_conv` on a DTensor)."""
    mesh = x.device_mesh
    out = fn(exchange_halos_2wave(x.to_local(), mesh), *(o.to_local() for o in others))
    return DTensor.from_local(out, mesh, x.placements, run_check=False)
