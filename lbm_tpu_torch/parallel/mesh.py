"""Device meshes for spatial domain decomposition on torch.distributed.

The counterpart of `lbm_tpu.parallel.mesh`. The analogue of the reference's
inter-IPU partitioning (`grids::partitionForIpus`,
main/include/StructuredGridUtils.hpp:472-561): the ranks of the initialised
process group form a `DeviceMesh` with dims ('ry', 'rx') — grid rows sharded
over 'ry', columns over 'rx' — and the factorisation keeps shards close to
square (least halo perimeter per cell). One rank drives one device: a GPU
under NCCL, or the CPU under gloo.

A (9, ny, nx) state is a `DTensor` with placements `grid_placements()` (the
speeds whole, rows on 'ry', columns on 'rx': `P(None, 'ry', 'rx')` in the
reference); a rank's block is its `to_local()`. Blocks are always equal:
grids that do not divide the mesh are padded first (`pad_grid`).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

ROW_AXIS = "ry"
COL_AXIS = "rx"


def best_factorisation(
    n_devices: int, ny: int, nx: int, *, require_even: bool = True,
    for_padding: bool = False,
) -> tuple[int, int]:
    """Pick (rows, cols) with rows*cols == n_devices minimising shard
    perimeter/area — the reference's row/col-imbalance heuristic
    (StructuredGridUtils.hpp:489-520) recast for halo traffic.

    require_even=True only admits factorisations that divide the grid
    exactly. require_even=False admits remainder splits (the analogue of the
    reference's remainder-row strategies, StructuredGridUtils.hpp:309-412).
    for_padding=True additionally restricts to factorisations the
    pad-and-mask RUNTIME can execute — shards take ceil-divided blocks and
    all padding must land in the LAST shard of each axis, i.e.
    (r-1)*ceil(ny/r) < ny; the planner's round-robin remainder splits
    (partition.partition_for_devices) have no such constraint and must not
    pass it. Prefers exact splits (zero waste), then lower halo traffic.
    """
    best = (n_devices, 1)
    best_cost = math.inf
    for r in range(1, n_devices + 1):
        if n_devices % r:
            continue
        c = n_devices // r
        if r > ny or c > nx:
            continue
        if require_even and (ny % r or nx % c):
            continue
        h = -(-ny // r)  # ceil
        w = -(-nx // c)
        if for_padding and ((r - 1) * h >= ny or (c - 1) * w >= nx):
            continue  # padding would spill beyond the last shard
        waste = (r * h * c * w - ny * nx) / (ny * nx)
        cost = 1 / h + 1 / w + waste  # halo cells per cell + padded fraction
        if cost < best_cost:
            best_cost = cost
            best = (r, c)
    if best_cost is math.inf:
        raise ValueError(
            f"cannot divide {ny}x{nx} grid evenly over {n_devices} devices"
            if require_even else
            f"no runnable factorisation of {n_devices} devices for a "
            f"{ny}x{nx} grid (shards would be pure padding)"
        )
    return best


def shard_padding(ny: int, nx: int, n_rows: int, n_cols: int) -> tuple[int, int]:
    """(pad_rows, pad_cols) to make a ny x nx grid divide an
    n_rows x n_cols mesh with ceil-sized shards. Padding always lands in the
    last shard of each axis; raises if a shard would be pure padding."""
    h = -(-ny // n_rows)
    w = -(-nx // n_cols)
    if (n_rows - 1) * h >= ny or (n_cols - 1) * w >= nx:
        raise ValueError(
            f"{ny}x{nx} on a {n_rows}x{n_cols} mesh: a whole shard would be "
            f"padding; use fewer devices along that axis"
        )
    return n_rows * h - ny, n_cols * w - nx


def pad_grid(params, f, obstacle_mask, pad_rows: int, pad_cols: int):
    """Pad-and-mask state construction shared by the uneven-grid runtimes
    (halo.simulate_sharded, kstep_sharded.simulate): padding cells hold the
    initial equilibrium (finite values), are masked as obstacles (excluded
    from Sum|u|, dynamics bounded by rebound) and sit after the real rows
    (top) / cols (east). Returns (f_padded, mask_padded): the state in f's
    host form (a numpy array, or a CPU tensor for bfloat16,
    `core.state.host_state`), the mask as a numpy array."""
    from ..core import state

    bf16 = isinstance(f, torch.Tensor) and f.dtype == torch.bfloat16
    f_host = f.cpu() if bf16 else np.asarray(f)
    new_ny, new_nx = params.ny + pad_rows, params.nx + pad_cols
    fpad = state.initial_distributions(dataclasses.replace(params, ny=new_ny, nx=new_nx),
                                       torch.bfloat16 if bf16 else f_host.dtype)
    fpad[:, : params.ny, : params.nx] = f_host
    mask_pad = np.ones((new_ny, new_nx), bool)
    mask_pad[: params.ny, : params.nx] = np.asarray(obstacle_mask)
    return fpad, mask_pad


def full_tensor(f, device) -> torch.Tensor:
    """A full state held on the host (a numpy array, or a CPU tensor for
    bfloat16) as a contiguous tensor on `device`."""
    if isinstance(f, torch.Tensor):
        return f.contiguous().to(device)
    return torch.from_numpy(np.ascontiguousarray(f)).to(device)


def device_type() -> str:
    """'cuda' for a NCCL process group, else 'cpu' (gloo)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def local_device() -> torch.device:
    """The device this rank drives: its GPU under NCCL, else the CPU."""
    if device_type() == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh2d(rows: int, cols: int) -> DeviceMesh:
    """A rows x cols mesh over every rank of the initialised process group
    (rank r at (r // cols, r % cols)). The same shape in the same group
    gives the same mesh: a mesh's axis groups set up their connections on
    first use, about a second under gloo."""
    world = dist.get_world_size()
    if rows * cols != world:
        raise ValueError(f"a {rows}x{cols} mesh needs {rows * cols} ranks; the process "
                         f"group has {world}")
    return _mesh2d(rows, cols, dist.distributed_c10d._get_default_group())


@functools.lru_cache(maxsize=8)
def _mesh2d(rows: int, cols: int, group) -> DeviceMesh:
    return DeviceMesh(device_type(), torch.arange(rows * cols).reshape(rows, cols),
                      mesh_dim_names=(ROW_AXIS, COL_AXIS))


def make_mesh1d(n: int) -> DeviceMesh:
    """A one-axis ('ry',) mesh over the n ranks of the initialised process
    group, rank r at index r (the reference's `Mesh(devices, ('ry',))`)."""
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a mesh of {n} ranks needs {n} ranks; the process group has {world}")
    return _mesh1d(n, dist.distributed_c10d._get_default_group())


@functools.lru_cache(maxsize=8)
def _mesh1d(n: int, group) -> DeviceMesh:
    return DeviceMesh(device_type(), torch.arange(n), mesh_dim_names=(ROW_AXIS,))


def make_mesh(n_devices: int | None = None, ny: int = 1024, nx: int = 1024, *,
              require_even: bool = False) -> DeviceMesh:
    """Mesh over the best (rows, cols) factorisation for a ny x nx grid, over
    the n_devices ranks of the process group (default: all of them).

    require_even=True restricts to exact splits — pass it from consumers
    that shard WITHOUT pad-and-mask (the 'implicit' strategy, conv-sharded),
    so that an uneven factorisation is this clear ValueError."""
    if n_devices is None:
        n_devices = dist.get_world_size()
    try:
        r, c = best_factorisation(n_devices, ny, nx)
    except ValueError:
        if require_even:
            raise
        # no exact split: the runtime runs uneven grids via pad-and-mask
        # (halo.simulate_sharded, strategy='ppermute')
        r, c = best_factorisation(n_devices, ny, nx, require_even=False,
                                  for_padding=True)
    return make_mesh2d(r, c)


def grid_placements():
    """Placements of a (9, ny, nx) state: speeds whole, space sharded."""
    return (Shard(1), Shard(2))


def mask_placements():
    """Placements of a (ny, nx) plane."""
    return (Shard(0), Shard(1))


def row_placements():
    """Placements of a (ny, 1) column (the accelerated-row mask)."""
    return (Shard(0), Replicate())


def block_coords(mesh: DeviceMesh) -> tuple[int, int]:
    """(row, col) of this rank's block in the mesh."""
    r, c = mesh.get_coordinate()
    return int(r), int(c)


# The exchanges ask these every chunk, so they read the mesh's shape:
# `mesh[axis]` builds a sub-mesh (~0.2 ms) and `mesh.mesh` a tensor (~0.05
# ms), more than a chunk's exchange costs at world size 1.
def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def coordinate(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along `axis`."""
    return int(mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)])


def neighbour(mesh: DeviceMesh, axis: str, direction: int) -> int:
    """Global rank of the rank `direction` blocks away along `axis`
    (periodic), on a mesh of `make_mesh2d` (rank r at (r // cols, r %
    cols)) or `make_mesh1d` (rank r at r)."""
    coords = [int(c) for c in mesh.get_coordinate()]
    dim = mesh.mesh_dim_names.index(axis)
    coords[dim] = (coords[dim] + direction) % mesh.shape[dim]
    rank = 0
    for c, n in zip(coords, mesh.shape):
        rank = rank * n + c
    return rank


def shard(x, mesh: DeviceMesh, placements, device=None) -> DTensor:
    """The DTensor of full array `x` (numpy or tensor, the same on every
    rank) with `placements` on `mesh`: each rank keeps its own block, with no
    communication. Every sharded dim must divide its mesh dim."""
    x = torch.as_tensor(x)
    index = [slice(None)] * x.dim()
    for mesh_dim, (p, coord) in enumerate(zip(placements, mesh.get_coordinate())):
        if isinstance(p, Shard):
            n = mesh.size(mesh_dim)
            size = x.shape[p.dim]
            if size % n:
                raise ValueError(f"dim {p.dim} of size {size} does not divide the mesh's "
                                 f"{n} blocks")
            b = size // n
            index[p.dim] = slice(coord * b, (coord + 1) * b)
    local = x[tuple(index)].to(device or local_device()).contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False)


def sum_by_rank(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Sum of every rank's `x` (same shape on each), the same bits on every
    rank: an all-reduce of a (ranks, ...) tensor in which each rank fills its
    own row (the others are zeros, which add exactly), then the rows added in
    rank order. No float atomics, no order that depends on the collective's
    algorithm (the contract of the port's Sum|u|)."""
    n = mesh.size()
    rows = torch.zeros((n, *x.shape), dtype=x.dtype, device=x.device)
    rows[mesh.get_rank()] = x
    dist.all_reduce(rows)  # the mesh holds every rank of the group
    out = rows[0].clone()
    for i in range(1, n):
        out = out + rows[i]
    return out
