"""Communication-avoiding multi-device D3Q19: ghost-plane exchange + the local
K-step CUDA kernels (B4; B6 as the oracle).

The counterpart of `lbm_tpu.parallel.pallas_sharded_3d`, and the 3-D twin of
`kstep_sharded`. Each rank owns a contiguous slab of z-planes over a one-axis
('ry',) mesh (`make_z_mesh`); y and x stay whole on every rank, their periodic
wrap inside the kernel. A slab carries K ghost planes a side, exchanged once
per K steps with one ring-shift pair; the local kernel — by default B4, in
place (`ops.d3q19_kstep_inplace`; local_engine='two-stream' runs B6,
`ops.d3q19_kstep`) — then advances the ghost-extended slab K steps, with
plane_offset / valid_planes / global_nz saying where it sits in the grid.
Information moves one plane a step, so owned planes stay exact for K <= the
ghost depth. Sum|u| excludes ghost planes; each rank keeps it per step and
the mesh adds it once a run in rank order (`mesh.sum_by_rank`). A bfloat16
slab is stored in bfloat16 and stepped by the local kernel's bfloat16
instance (through a float32 scratch lattice of the extended slab, rounding
once a pass; B4 on the path `d3q19_kstep.choose_path` gives the slab, the
wave path where it fits); Sum|u| is float32, and the free-cell count is
rounded to bfloat16 before the float32 division, as on one device.

Each rank keeps one persistent ghost-extended buffer (19, h + 2K, ny, nx): a
chunk writes the ghost planes it receives into it (a band is 19 runs of
memory, so what travels is staged in one contiguous tensor) and the kernel
advances the whole buffer. Uneven nz pads the last slab (pad-and-mask): its
dead planes are obstacles, and the torus wraps at its last valid plane.

`make_zy_chunk_fn` and `run_zy` / `simulate_zy` shard y too, over a
('ry', 'rx') mesh: wave 1 exchanges GHOST_Y-row bands along 'rx', wave 2 the
K-plane ghosts of the y-extended block along 'ry', so the corners ride along.

The reference's local kernel falls back to its two-stream kernel when no
in-place configuration fits a block (pallas_sharded_3d.py:56-64). The port
decides the kernel before any launch (`local_kernel`) and has no such
branch: its in-place kernels take any shape.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from ..ops import d3q19, d3q19_kstep, d3q19_kstep_inplace, d3q19_lattice
from . import halo as halo_lib, mesh as mesh_lib

ROW, COL = mesh_lib.ROW_AXIS, mesh_lib.COL_AXIS
GHOST_Y = 8  # the y ghost band: the reference kernels' 8-row sublane block
LOCAL_ENGINES = ("inplace", "two-stream")


def local_kernel(local_engine: str):
    """The stepk of the local kernel, the same for every block (the kernels
    take any shape): 'inplace' (default) B4 (`d3q19_kstep_inplace`),
    'two-stream' B6 (`d3q19_kstep`), the same arithmetic out of place (the
    oracle)."""
    kernels = {"inplace": d3q19_kstep_inplace.stepk, "two-stream": d3q19_kstep.stepk}
    if local_engine not in kernels:
        raise ValueError(f"local_engine must be one of {LOCAL_ENGINES}, got {local_engine!r}")
    return kernels[local_engine]


def make_z_mesh(n_devices: int | None = None) -> DeviceMesh:
    """One-axis ('ry',) mesh over the ranks of the process group."""
    return mesh_lib.make_mesh1d(n_devices or dist.get_world_size())


def plan_planes(nz: int, n_shards: int, ghost: int) -> tuple[int, int]:
    """(shard_depth, pad_planes) for the ghost-plane path: shard depths are a
    multiple of the ghost depth (the reference kernel's K | nz), so uneven nz
    pads the LAST z-shard (pad-and-mask; the reference's remainder rows,
    StructuredGridUtils.hpp:309-412)."""
    h = -(-nz // n_shards)
    h = -(-h // ghost) * ghost
    if nz - (n_shards - 1) * h < ghost:
        raise ValueError(
            f"{nz} planes on {n_shards} z-shards: the last shard would hold "
            f"< {ghost} valid planes (ghost-aligned depth {h}); use fewer "
            "z-shards or k_steps")
    return h, n_shards * h - nz


def extended_mask(obstacle_mask: np.ndarray, n_shards: int, ghost: int) -> np.ndarray:
    """Per-shard ghost-extended obstacle masks stacked to (r*(h+2g), ny, nx).

    Uneven nz: each extended local plane maps to the real periodic global
    plane ((s*h + j - g) mod nz); the last shard's planes beyond its valid
    and north-ghost planes are dead padding, marked as obstacles (out of
    Sum|u|, dynamics bounded by rebound)."""
    nz, ny, nx = obstacle_mask.shape
    h, _pad = plan_planes(nz, n_shards, ghost)
    blocks = []
    for s in range(n_shards):
        vh = min(h, nz - s * h)
        planes = (s * h - ghost + np.arange(h + 2 * ghost)) % nz
        blk = obstacle_mask[planes].copy()
        blk[2 * ghost + vh:] = True  # dead padding planes
        blocks.append(blk)
    return np.concatenate(blocks, axis=0)


def make_zy_mesh(n_z: int, n_y: int) -> DeviceMesh:
    """(z, y) mesh: 'ry' shards z-planes, 'rx' y-rows (the repo-wide axis
    names, so the halo helpers carry over)."""
    return mesh_lib.make_mesh2d(n_z, n_y)


def plan_rows_y(ny: int, n_y_shards: int) -> tuple[int, int]:
    """(shard_rows, pad_rows) for the y axis: shard heights are a multiple of
    GHOST_Y, and uneven ny pads the LAST y-shard, as plan_planes does z."""
    h = -(-ny // n_y_shards)
    h = -(-h // GHOST_Y) * GHOST_Y
    if ny - (n_y_shards - 1) * h < GHOST_Y:
        raise ValueError(
            f"{ny} rows on {n_y_shards} y-shards: the last shard would hold "
            f"< {GHOST_Y} valid rows (8-aligned shard height {h}); use "
            "fewer y-shards")
    return h, n_y_shards * h - ny


def extended_mask_zy(obstacle_mask: np.ndarray, n_z: int, n_y: int, ghost: int) -> np.ndarray:
    """Per-shard (z, y) ghost-extended obstacle masks stacked to
    (n_z*(hz+2g), n_y*(hy+2*GHOST_Y), nx), so that sharding dims 0 and 1 over
    ('ry', 'rx') hands each rank its block. Each extended cell maps to the
    real periodic global cell; dead padding planes and rows are obstacles."""
    nz, ny, nx = obstacle_mask.shape
    hz, _ = plan_planes(nz, n_z, ghost)
    hy, _ = plan_rows_y(ny, n_y)
    z_blocks = []
    for s in range(n_z):
        vhz = min(hz, nz - s * hz)
        planes = (s * hz - ghost + np.arange(hz + 2 * ghost)) % nz
        y_blocks = []
        for t in range(n_y):
            vhy = min(hy, ny - t * hy)
            rows = (t * hy - GHOST_Y + np.arange(hy + 2 * GHOST_Y)) % ny
            blk = obstacle_mask[np.ix_(planes, rows)].copy()
            blk[2 * ghost + vhz:, :] = True   # dead padding planes
            blk[:, 2 * GHOST_Y + vhy:] = True  # dead padding rows
            y_blocks.append(blk)
        z_blocks.append(np.concatenate(y_blocks, axis=1))
    return np.concatenate(z_blocks, axis=0)


def choose_k(nz: int, n_z: int, *step_counts: int, overlap: bool = False) -> int:
    """K of a sharded kernel run: `d3q19_kstep.choose_k` (the preferred K,
    else the least time a step) among the K that divide every one of
    `step_counts` and whose plan `plan_planes` admits for n_z z-shards (and,
    with `overlap`, an even split of at least 3K planes a shard). 1 when
    none does, so that the run raises plan_planes' own refusal."""
    def admits(k):
        try:
            h, pad = plan_planes(nz, n_z, k)
        except ValueError:
            return False
        return not overlap or (pad == 0 and h >= 3 * k)

    return d3q19_kstep.choose_k(*step_counts, admit=admits)


class _Chunk:
    """What the chunk functions share: this rank's z-slab and the kernels'
    scalar arguments."""

    def __init__(self, mesh, *, k_steps, omega, density, accel, accel_plane, nz,
                 local_engine):
        if not 1 <= k_steps <= d3q19_kstep.MAX_K:
            raise ValueError(f"k_steps must be in 1..{d3q19_kstep.MAX_K}, got {k_steps}")
        self.mesh = mesh
        self.g = k_steps
        self.n_z = mesh_lib.axis_size(mesh, ROW)
        self.h, self.pad = plan_planes(nz, self.n_z, k_steps)
        s = mesh_lib.coordinate(mesh, ROW)
        self.z0 = s * self.h
        self.vh = self.h - (self.pad if s == self.n_z - 1 else 0)
        self.local_engine = local_engine
        self.kw = dict(k_steps=k_steps, omega=omega, density=density, accel=accel,
                       accel_plane=accel_plane, global_nz=nz)

    def kernel(self):
        """The local kernel, with its keywords."""
        return local_kernel(self.local_engine), dict(self.kw)

    def shift_into(self, dst, x, axis, direction):
        halo_lib.shift_into(dst, x, self.mesh, axis, direction)

    def exchange_planes(self, buf):
        """The K-plane ghosts of `buf` (the extended slab, planes [K, K + h)
        owned): the top valid planes to the next rank's south ghost, the
        first planes to the previous rank's north ghost. With uneven nz the
        torus wraps at the last slab's valid edge: it sends its top valid
        planes and writes the incoming north ghost after them as well."""
        g, h, vh = self.g, self.h, self.vh
        self.shift_into(buf[:, :g], buf[:, vh:vh + g], ROW, +1)
        if self.pad:  # the two places of the north ghost may overlap
            ghost_n = halo_lib.ring_shift(buf[:, g:2 * g], self.mesh, ROW, -1)
            buf[:, g + h:] = ghost_n
            buf[:, vh + g:vh + 2 * g] = ghost_n
        else:
            self.shift_into(buf[:, g + h:], buf[:, g:2 * g], ROW, -1)


class _Fused(_Chunk):
    """make_chunk_fn's chunk: one kernel on the rank's ghost-extended slab."""

    def start(self, f_loc, mask_ext_loc):
        _, h, ny, nx = f_loc.shape
        g = self.g
        self.buf = f_loc.new_empty((19, h + 2 * g, ny, nx))
        self.buf[:, g:g + h] = f_loc
        self.mask = mask_ext_loc
        self.stepk, self.kwargs = self.kernel()
        self.kwargs.update(plane_offset=self.z0 - g, valid_planes=(g, g + self.vh))

    def own(self):
        return self.buf[:, self.g:self.g + self.h]

    def __call__(self, tots):
        self.exchange_planes(self.buf)
        self.buf, t = self.stepk(self.buf, self.mask, **self.kwargs)
        tots.copy_(t)


class _Overlap(_Chunk):
    """make_overlap_chunk_fn's chunk: the ghost planes travel while an
    interior kernel runs on the owned slab; two 3K-plane boundary kernels
    finish the edge planes once they land."""

    def __init__(self, mesh, **kw):
        super().__init__(mesh, **kw)
        g = self.g
        if self.pad:
            raise ValueError(
                "overlap=True supports evenly-sharded nz only (no pad planes); "
                f"nz={kw['nz']} on {self.n_z} shards pads {self.pad} planes — use the "
                "fused path")
        if self.h < 3 * g:
            raise ValueError(
                f"overlap=True needs >= 3*K planes per shard (h={self.h}, K={g}): "
                "thinner shards have no ghost-independent interior to overlap")

    def start(self, f_loc, mask_ext_loc):
        _, h, ny, nx = f_loc.shape
        g, m = self.g, mask_ext_loc
        self.buf = f_loc.clone(memory_format=torch.contiguous_format)
        self.sb = f_loc.new_empty((19, 3 * g, ny, nx))
        self.nb = f_loc.new_empty((19, 3 * g, ny, nx))
        self.masks = (m[g:g + h], m[:3 * g], m[h - g:h + 2 * g])
        self.t = d3q19_kstep.sums(f_loc, 2 * g).view(2, g)
        self.interior_kernel, kw = self.kernel()
        self.interior_kw = dict(kw, plane_offset=self.z0, valid_planes=(g, h - g))
        self.strip_kernel, kw = self.kernel()
        edge = dict(kw, valid_planes=(g, 2 * g))
        self.strip_kw = (dict(edge, plane_offset=self.z0 - g),
                         dict(edge, plane_offset=self.z0 + h - 2 * g))

    def own(self):
        return self.buf

    def __call__(self, tots):
        g, h, buf = self.g, self.h, self.buf
        m_own, m_s, m_n = self.masks
        # 1. start the ghost exchange...
        ghost_s, ws = halo_lib.start_ring_shift(buf[:, h - g:], self.mesh, ROW, +1)
        ghost_n, wn = halo_lib.start_ring_shift(buf[:, :g], self.mesh, ROW, -1)
        # the boundary kernels' owned planes, taken before the interior
        # kernel advances the slab in place
        self.sb[:, g:] = buf[:, :2 * g]
        self.nb[:, :2 * g] = buf[:, h - 2 * g:]
        # 2. ...then the interior kernel, which depends only on the owned
        # planes; planes outside [K, h-K) wrap around the slab and are
        # discarded
        buf, t = self.interior_kernel(buf, m_own, **self.interior_kw)
        tots.copy_(t)
        # 3. boundary kernels: K ghost + 2K owned planes -> the K edge planes
        # whose stencil reaches the ghosts
        halo_lib.wait(ws + wn)
        self.sb[:, :g] = ghost_s
        self.nb[:, 2 * g:] = ghost_n
        self.sb, t_s = self.strip_kernel(self.sb, m_s, **self.strip_kw[0])
        self.nb, t_n = self.strip_kernel(self.nb, m_n, **self.strip_kw[1])
        buf[:, :g] = self.sb[:, g:2 * g]
        buf[:, h - g:] = self.nb[:, g:2 * g]
        self.buf = buf
        tots += t_s
        tots += t_n


class _ZY(_Chunk):
    """make_zy_chunk_fn's chunk: one kernel on the rank's (z, y)
    ghost-extended block (19, hz + 2K, hy + 2 GHOST_Y, nx)."""

    def __init__(self, mesh, *, ny, **kw):
        if kw["k_steps"] > GHOST_Y:
            raise ValueError(f"k_steps must be <= {GHOST_Y} (the y ghost band absorbs one "
                             "row of wavefront per step)")
        super().__init__(mesh, **kw)
        self.n_y = mesh_lib.axis_size(mesh, COL)
        self.hy, self.pad_y = plan_rows_y(ny, self.n_y)
        t = mesh_lib.coordinate(mesh, COL)
        self.vhy = self.hy - (self.pad_y if t == self.n_y - 1 else 0)

    def start(self, f_loc, mask_ext_loc):
        _, hz, hy, nx = f_loc.shape
        g, gy = self.g, GHOST_Y
        self.buf = f_loc.new_empty((19, hz + 2 * g, hy + 2 * gy, nx))
        self.buf[:, g:g + hz, gy:gy + hy] = f_loc
        self.mask = mask_ext_loc
        self.stepk, self.kwargs = self.kernel()
        self.kwargs.update(plane_offset=self.z0 - g, valid_planes=(g, g + self.vh),
                           valid_rows=(gy, gy + self.vhy))

    def own(self):
        return self.buf[:, self.g:self.g + self.h, GHOST_Y:GHOST_Y + self.hy]

    def __call__(self, tots):
        gy, hy, vhy = GHOST_Y, self.hy, self.vhy
        # wave 1 (y rows along 'rx', the owned planes): GHOST_Y-row edge
        # bands, the torus wrapping at the last y-shard's valid edge
        own = self.buf[:, self.g:self.g + self.h]
        self.shift_into(own[:, :, :gy], own[:, :, vhy:vhy + gy], COL, +1)
        if self.pad_y:
            ghost_e = halo_lib.ring_shift(own[:, :, gy:2 * gy], self.mesh, COL, -1)
            own[:, :, gy + hy:] = ghost_e
            own[:, :, vhy + gy:vhy + 2 * gy] = ghost_e
        else:
            self.shift_into(own[:, :, gy + hy:], own[:, :, gy:2 * gy], COL, -1)
        # wave 2 (z planes along 'ry') of the y-extended block: the K-plane
        # ghosts carry the z-neighbours' y ghosts, the corners
        self.exchange_planes(self.buf)
        self.buf, t = self.stepk(self.buf, self.mask, **self.kwargs)
        tots.copy_(t)


def make_chunk_fn(mesh: DeviceMesh, *, k_steps: int, omega: float, density: float,
                  accel: float, accel_plane: int, nz: int, overlap: bool = False,
                  local_engine: str = "inplace"):
    """The chunk of this rank on a z-mesh: `chunk.start(f_loc, mask_ext_loc)`
    lays its slab into the ghost-extended buffer, each `chunk(tots)` advances
    it K steps and writes this rank's Sum|u| per step into tots (K,),
    `chunk.own()` is the owned slab. overlap=True gives
    make_overlap_chunk_fn's chunk; local_engine picks the kernel
    (`local_kernel`)."""
    kw = dict(k_steps=k_steps, omega=omega, density=density, accel=accel,
              accel_plane=accel_plane, nz=nz, local_engine=local_engine)
    return _Overlap(mesh, **kw) if overlap else _Fused(mesh, **kw)


def make_overlap_chunk_fn(mesh: DeviceMesh, **kw):
    """The exchange/compute-overlapped chunk (the interface of make_chunk_fn).

    A K-step update of owned plane j reads planes [j-K, j+K], so owned planes
    [K, h-K) never read a ghost: their kernel runs while the ghost planes
    travel (under NCCL on NCCL's stream). Two 3K-plane boundary kernels (K
    ghost + 2K owned planes in, the K edge planes out) run once they land.
    The state is bit-identical to the fused path; Sum|u| is three partial
    sums a step, so it equals the fused path's to rounding. Requires even
    sharding (no pad) and h >= 3K."""
    return make_chunk_fn(mesh, overlap=True, **kw)


def make_zy_chunk_fn(mesh: DeviceMesh, *, k_steps: int, omega: float, density: float,
                     accel: float, accel_plane: int, nz: int, ny: int,
                     local_engine: str = "inplace"):
    """The chunk of this rank on a (z, y) mesh (the interface of
    make_chunk_fn). Wave 1: GHOST_Y-row y ghost bands along 'rx'. Wave 2:
    K-plane z ghosts of the y-extended block along 'ry' (corners ride
    along). Both axes take uneven grids by pad-and-mask. The kernel's Sum|u|
    window excludes ghost planes and ghost rows (valid_planes, valid_rows)."""
    return _ZY(mesh, k_steps=k_steps, omega=omega, density=density, accel=accel,
               accel_plane=accel_plane, nz=nz, ny=ny, local_engine=local_engine)


def _run_chunks(chunk, f: DTensor, mask_ext: DTensor, mesh, num_steps: int, k_steps: int):
    if num_steps % k_steps:
        raise ValueError("num_steps must be a multiple of k_steps")
    f_loc = f.to_local()
    chunk.start(f_loc, mask_ext.to_local())
    tots = d3q19_kstep.sums(f_loc, num_steps)
    for i in range(num_steps // k_steps):
        chunk(tots[i * k_steps:(i + 1) * k_steps])
    return (DTensor.from_local(chunk.own().contiguous(), mesh, f.placements, run_check=False),
            mesh_lib.sum_by_rank(tots, mesh))


def run(f: DTensor, mask_ext: DTensor, *, mesh: DeviceMesh, num_steps: int, k_steps: int,
        omega: float, density: float, accel: float, accel_plane: int, nz: int,
        overlap: bool = False, local_engine: str = "inplace"):
    """num_steps steps in chunks of k_steps on a z-mesh. Returns (f_final
    DTensor, tot_u (num_steps,), the same on every rank)."""
    chunk = make_chunk_fn(mesh, k_steps=k_steps, omega=omega, density=density, accel=accel,
                          accel_plane=accel_plane, nz=nz, overlap=overlap,
                          local_engine=local_engine)
    return _run_chunks(chunk, f, mask_ext, mesh, num_steps, k_steps)


def run_zy(f: DTensor, mask_ext: DTensor, *, mesh: DeviceMesh, num_steps: int, k_steps: int,
           omega: float, density: float, accel: float, accel_plane: int, nz: int, ny: int,
           local_engine: str = "inplace"):
    """num_steps steps in chunks of k_steps on a (z, y) mesh. Returns
    (f_final DTensor, tot_u (num_steps,), the same on every rank)."""
    chunk = make_zy_chunk_fn(mesh, k_steps=k_steps, omega=omega, density=density,
                             accel=accel, accel_plane=accel_plane, nz=nz, ny=ny,
                             local_engine=local_engine)
    return _run_chunks(chunk, f, mask_ext, mesh, num_steps, k_steps)


def _padded(f, density: float, pad_z: int, pad_y: int = 0):
    """f (19, nz, ny, nx), a numpy array or a host bfloat16 tensor, with
    pad_z planes and pad_y rows of the initial equilibrium after it
    (pad-and-mask: finite values in dead cells), in f's host form."""
    bf16 = isinstance(f, torch.Tensor) and f.dtype == torch.bfloat16
    f = f.cpu() if bf16 else np.asarray(f)
    _, nz, ny, nx = f.shape
    if not (pad_z or pad_y):
        return f
    out = d3q19_lattice.initial_distributions(nz + pad_z, ny + pad_y, nx, density,
                                              torch.bfloat16 if bf16 else f.dtype.type)
    out[:, :nz, :ny] = f
    return out


def prepare(f, obstacle_mask, mesh: DeviceMesh, *, k_steps: int, density: float = 0.1):
    """Lay a full state ((19, nz, ny, nx), a numpy array or a host bfloat16
    tensor, the same on every rank) out for run() on a z-mesh: pad-and-mask
    uneven nz, shard it, and build the ghost-extended obstacle mask. Returns
    (f, mask_ext) as DTensors on this rank's device."""
    mask = np.asarray(obstacle_mask, bool)
    n_z = mesh_lib.axis_size(mesh, ROW)
    _, pad = plan_planes(mask.shape[0], n_z, k_steps)
    return (mesh_lib.shard(_padded(f, density, pad), mesh, (Shard(1),)),
            mesh_lib.shard(extended_mask(mask, n_z, k_steps), mesh, (Shard(0),)))


def prepare_zy(f, obstacle_mask, mesh: DeviceMesh, *, k_steps: int, density: float = 0.1):
    """prepare() for run_zy on a (z, y) mesh: both axes pad-and-mask."""
    mask = np.asarray(obstacle_mask, bool)
    nz, ny, _ = mask.shape
    n_z, n_y = mesh.shape
    _, pad_z = plan_planes(nz, n_z, k_steps)
    _, pad_y = plan_rows_y(ny, n_y)
    return (mesh_lib.shard(_padded(f, density, pad_z, pad_y), mesh, (Shard(1), Shard(2))),
            mesh_lib.shard(extended_mask_zy(mask, n_z, n_y, k_steps), mesh,
                           (Shard(0), Shard(1))))


def start_state(nz, ny, nx, obstacle_mask, density, dtype):
    """(the uniform state at rest on the host, a numpy array or for bfloat16
    a CPU tensor; the obstacle mask, by default
    `ops.d3q19.default_obstacle_mask`)."""
    from ..models.lbm import host_dtype

    mask = (d3q19.default_obstacle_mask(nz, ny, nx) if obstacle_mask is None
            else np.asarray(obstacle_mask, bool))
    return d3q19_lattice.initial_distributions(nz, ny, nx, density, host_dtype(dtype)), mask


def finisher(mask: np.ndarray, nz: int, ny: int):
    """finish(f_final, tot_u): the full (19, nz, ny, nx) state and av_vels,
    Sum|u| divided by the free-cell count in the state's type (rounded for
    bfloat16), as on one device."""
    def finish(f_final: DTensor, tot: torch.Tensor):
        num_free = torch.tensor(int((~mask).sum()), dtype=f_final.dtype, device=tot.device)
        return f_final.full_tensor()[:, :nz, :ny], tot / num_free

    return finish


def laid_out(nz, ny, nx, mesh, *, zy, num_steps, k_steps, omega, density, accel,
              obstacle_mask, dtype, overlap=False, local_engine="inplace"):
    """(advance, finish, block) of a ghost-plane run on `mesh` (a (z, y) one
    when `zy`) from the uniform state at rest; see
    `models.lbm3d.setup_engine`. block is
    the shape the local kernel runs on (the overlap's interior block)."""
    f0, mask = start_state(nz, ny, nx, obstacle_mask, density, dtype)
    kw = dict(mesh=mesh, num_steps=num_steps, k_steps=k_steps, omega=omega, density=density,
              accel=accel, accel_plane=nz - 2, nz=nz, local_engine=local_engine)
    h = plan_planes(nz, mesh_lib.axis_size(mesh, ROW), k_steps)[0]
    if zy:
        f, mask_ext = prepare_zy(f0, mask, mesh, k_steps=k_steps, density=density)
        block = (19, h + 2 * k_steps,
                 plan_rows_y(ny, mesh_lib.axis_size(mesh, COL))[0] + 2 * GHOST_Y, nx)

        def advance():
            return run_zy(f, mask_ext, ny=ny, **kw)
    else:
        f, mask_ext = prepare(f0, mask, mesh, k_steps=k_steps, density=density)
        block = (19, h if overlap else h + 2 * k_steps, ny, nx)

        def advance():
            return run(f, mask_ext, overlap=overlap, **kw)
    return advance, finisher(mask, nz, ny), block


def simulate(
    nz: int, ny: int, nx: int, *,
    num_steps: int,
    omega: float = 1.85,
    density: float = 0.1,
    accel: float = 0.005,
    obstacle_mask=None,
    dtype=torch.float32,
    mesh: DeviceMesh | None = None,
    k_steps: int = 2,
    overlap: bool = False,
    local_engine: str = "inplace",
):
    """Full 3-D run on the ghost-plane path over a z-mesh (default: every
    rank of the group), from the uniform state at rest; the contract of
    `ops.d3q19.simulate`, on every rank: (f_final (19, nz, ny, nx),
    av_vels (num_steps,)) on this rank's device. overlap=True uses the
    exchange/compute-overlapped chunk (even sharding only);
    local_engine='two-stream' runs B6 on each slab."""
    advance, finish, _ = laid_out(
        nz, ny, nx, mesh or make_z_mesh(), zy=False, num_steps=num_steps, k_steps=k_steps,
        omega=omega, density=density, accel=accel, obstacle_mask=obstacle_mask, dtype=dtype,
        overlap=overlap, local_engine=local_engine)
    return finish(*advance())


def default_zy_shape(n: int, nz: int, ny: int) -> tuple[int, int]:
    """(n_z, n_y) of a (z, y) mesh of n ranks by default: the reference's
    factorisation, admitting splits that pad-and-mask can run."""
    return mesh_lib.best_factorisation(n, nz, ny, require_even=False, for_padding=True)


def simulate_zy(
    nz: int, ny: int, nx: int, *,
    num_steps: int,
    omega: float = 1.85,
    density: float = 0.1,
    accel: float = 0.005,
    obstacle_mask=None,
    dtype=torch.float32,
    mesh: DeviceMesh | None = None,
    k_steps: int = 2,
    local_engine: str = "inplace",
):
    """Full 3-D run on a (z, y) mesh (default: `default_zy_shape` over every
    rank of the group); the contract of `simulate`. Both axes take uneven
    grids by pad-and-mask."""
    mesh = mesh or make_zy_mesh(*default_zy_shape(dist.get_world_size(), nz, ny))
    advance, finish, _ = laid_out(
        nz, ny, nx, mesh, zy=True, num_steps=num_steps, k_steps=k_steps, omega=omega,
        density=density, accel=accel, obstacle_mask=obstacle_mask, dtype=dtype,
        local_engine=local_engine)
    return finish(*advance())
