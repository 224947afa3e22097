"""Communication-avoiding multi-device LBM: ghost-band exchange + the local
K-step CUDA kernels (B1, B2).

The counterpart of `lbm_tpu.parallel.pallas_sharded` (the port names its
Pallas counterparts `kstep`). Each rank owns a contiguous block of the grid
over a ('ry', 'rx') mesh. Instead of exchanging one halo row/column every
step, each block carries ghost bands — GHOST rows and, when columns are
sharded, GHOST_COLS columns — exchanged once per K steps with one ring-shift
pair per mesh axis (the 2-wave scheme: columns first, then rows of the
column-extended block so the corners ride along). The fused K-step local
kernel — by default B1, in place (`ops.d2q9_kstep_inplace`;
local_engine='two-stream' runs B2, `ops.d2q9_kstep`) — then advances the
ghost-extended block K steps, with row_offset / valid_rows / valid_cols /
global_ny describing where the block sits in the grid. Information
propagates one cell per step, so owned cells stay exact for K <= GHOST.
Sum|u| partials exclude ghost cells; each rank keeps them per step and the
mesh adds them once a run in rank order (`mesh.sum_by_rank`). A bfloat16
state is stored in bfloat16 and stepped by the kernels' bfloat16 instance,
which steps in float32 and rounds once a pass; Sum|u| is float32
(`d2q9_kstep.compute_dtype`), and the free-cell count is rounded to
bfloat16 before the float32 division, as on one device.

Each rank keeps one persistent ghost-extended buffer: a chunk writes the
ghost bands it receives into it and passes the whole contiguous buffer to
the kernel, which (B1) advances it in place; nothing is concatenated. The
ghost widths are the reference's (its kernel's halo block and the TPU lane
width), so that the masks and the overlap rules match it; they are not yet
tuned for this card.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..core.params import Params
from ..ops import d2q9, d2q9_kstep, d2q9_kstep_inplace
from ..utils import profiling
from . import halo as halo_lib, mesh as mesh_lib

ROW, COL = mesh_lib.ROW_AXIS, mesh_lib.COL_AXIS
GHOST = 8         # ghost band height (the reference kernel's halo block)
GHOST_COLS = 128  # ghost band width (the reference's TPU lane width)


def _local_stepk(local_engine: str):
    """The ghost-extended local kernel: 'inplace' (default) B1, which
    advances the buffer in place; 'two-stream' B2, bit-identical arithmetic
    (the oracle)."""
    if local_engine == "two-stream":
        return d2q9_kstep.stepk
    if local_engine == "inplace":
        return d2q9_kstep_inplace.stepk
    raise ValueError(
        f"local_engine must be 'inplace' or 'two-stream', "
        f"got {local_engine!r}")


def overlap_scheme(n_col_shards: int, shard_w: int,
                   scheme: str = "auto") -> str:
    """Resolve which decomposition make_overlap_chunk_fn uses.

    'row' (the 'auto' resolution): the row wave rides under the interior
    kernel; on a 2-D mesh the column wave stays exposed. 'full2d' hides
    BOTH waves under a ghost-free interior kernel, at the price of
    recomputing the W/E boundary strips (3*GHOST_COLS columns computed to
    yield GHOST_COLS valid); the reference's exchange model prices that
    recompute above the column wave it hides, so 'auto' never picks it.
    full2d also needs a column interior to hide the wave under:
    n_col_shards > 1 and shard_w >= 3*GHOST_COLS."""
    if scheme in ("auto", "row"):
        return "row"
    if scheme == "full2d":
        if n_col_shards <= 1:
            raise ValueError("scheme='full2d' needs a column-sharded mesh "
                             "(row meshes have no column wave to hide)")
        if shard_w < 3 * GHOST_COLS:
            raise ValueError(
                f"scheme='full2d' needs shard width >= {3 * GHOST_COLS} "
                f"(got {shard_w}): narrower shards have no column interior "
                "to hide the column wave under")
        return "full2d"
    raise ValueError(f"scheme must be 'auto'|'row'|'full2d', got {scheme!r}")


def make_row_mesh(n_devices: int | None = None) -> DeviceMesh:
    """1-D rows-only mesh (columns wrap locally on each shard)."""
    import torch.distributed as dist

    n = n_devices or dist.get_world_size()
    return mesh_lib.make_mesh2d(n, 1)


def plan_rows(ny: int, n_row_shards: int) -> tuple[int, int]:
    """(shard_h, pad_rows) for the ghost-band path: shard heights are a
    multiple of 8 (the reference kernel's sublane block), so uneven grids pad
    the LAST row-shard (the reference's remainder-row strategy,
    StructuredGridUtils.hpp:309-412, recast as pad-and-mask)."""
    h = -(-ny // n_row_shards)
    h = -(-h // 8) * 8
    # the last shard's VALID rows must cover a full ghost band: its top
    # GHOST valid rows are what the wrap-around south ghost is sliced from
    if ny - (n_row_shards - 1) * h < GHOST:
        raise ValueError(
            f"{ny} rows on {n_row_shards} row-shards: the last shard would "
            f"hold < {GHOST} valid rows (8-aligned shard height {h}); use "
            f"fewer row-shards or halo.simulate_sharded"
        )
    return h, n_row_shards * h - ny


def extended_mask(obstacle_mask: np.ndarray, n_row_shards: int,
                  n_col_shards: int = 1) -> np.ndarray:
    """Per-shard ghost-extended obstacle masks, stacked to
    (r*(h+16), c*(w+256)) so mask placements hand each rank its slab.

    Rows may be uneven: each extended local row maps to the REAL-periodic
    global row ((s*h + j - GHOST) mod ny); padding rows beyond the last
    shard's valid+ghost zone are marked as obstacles (excluded from Sum|u|,
    dynamics bounded by rebound)."""
    ny, nx = obstacle_mask.shape
    if nx % n_col_shards:
        raise ValueError(
            f"{nx} columns not divisible by {n_col_shards} column-shards "
            "(uneven support is rows-only on the ghost-band path; use a "
            "row mesh or halo.simulate_sharded for uneven columns)"
        )
    h, pad = plan_rows(ny, n_row_shards)
    w = nx // n_col_shards
    if n_col_shards > 1 and w < GHOST_COLS:
        raise ValueError(f"shard width {w} < ghost band {GHOST_COLS}")
    gc = GHOST_COLS if n_col_shards > 1 else 0
    row_blocks = []
    for s in range(n_row_shards):
        vh = h - pad if s == n_row_shards - 1 else h
        rows = (s * h - GHOST + np.arange(h + 2 * GHOST)) % ny
        col_blocks = []
        for t in range(n_col_shards):
            cols = np.arange(t * w - gc, t * w + w + gc) % nx
            blk = obstacle_mask[np.ix_(rows, cols)].copy()
            blk[2 * GHOST + vh:, :] = True  # dead padding rows
            col_blocks.append(blk)
        row_blocks.append(np.concatenate(col_blocks, axis=1))
    return np.concatenate(row_blocks, axis=0)


class _Chunk:
    """What the fused and overlapped chunk functions share: this rank's
    place in the mesh and the kernel's scalar arguments."""

    def __init__(self, mesh, *, k_steps, omega, accel_w1, accel_w2, accel_row, ny,
                 local_engine):
        if not 1 <= k_steps <= GHOST:
            raise ValueError(f"k_steps must be in 1..{GHOST}")
        self.mesh = mesh
        self.n_rows, self.n_cols = mesh.shape
        self.h, self.pad_rows = plan_rows(ny, self.n_rows)
        self.gc = GHOST_COLS if self.n_cols > 1 else 0
        self.stepk = _local_stepk(local_engine)
        my_r, _ = mesh_lib.block_coords(mesh)
        self.row0 = my_r * self.h
        self.vh = self.h - (self.pad_rows if my_r == self.n_rows - 1 else 0)
        self.kw = dict(k_steps=k_steps, omega=omega, accel_w1=accel_w1, accel_w2=accel_w2,
                       accel_row=accel_row, global_ny=ny)

    def shift(self, x, axis, direction):
        return halo_lib.ring_shift(x, self.mesh, axis, direction)

    def shift_into(self, dst, x, axis, direction):
        halo_lib.shift_into(dst, x, self.mesh, axis, direction)

    def chain(self, buf, mask, rows, cols=(), **window):
        """B1's passes on `buf` (`d2q9_kstep_inplace.Chain`), or None for B2."""
        if self.stepk is not d2q9_kstep_inplace.stepk:
            return None
        return d2q9_kstep_inplace.Chain(buf, mask, rows=rows, cols=cols, **window, **self.kw)

    def kernel(self, buf, mask, *, row_offset, valid_rows, valid_cols):
        return self.stepk(buf, mask, row_offset=row_offset, valid_rows=valid_rows,
                          valid_cols=valid_cols, **self.kw)


class _Fused(_Chunk):
    """make_chunk_fn's chunk: one kernel on the whole ghost-extended block
    (9, h + 2 GHOST, w + 2 gc), the rank's persistent buffer."""

    def start(self, f_loc, mask_ext_loc):
        _, h, w = f_loc.shape
        g, gc, vh = GHOST, self.gc, self.vh
        self.w = w
        self.buf = f_loc.new_empty((9, h + 2 * g, w + 2 * gc))
        self.buf[:, g:g + h, gc:gc + w] = f_loc
        self.mask = mask_ext_loc
        self.window = dict(row_offset=self.row0 - g, valid_rows=(g, g + vh),
                           valid_cols=(gc, gc + w))
        # B1's passes chain their boundary snapshots; the ghost bands that
        # the exchange rewrites are copied into each one
        self.passes = self.chain(
            self.buf, self.mask,
            rows=[*range(g), *range(g + h, h + 2 * g),
                  *(range(vh + g, vh + 2 * g) if self.pad_rows else ())],
            cols=[*range(gc), *range(gc + w, w + 2 * gc)], **self.window)

    def own(self):
        return self.buf[:, GHOST:GHOST + self.h, self.gc:self.gc + self.w]

    def __call__(self, tots):
        g, gc, h, w, vh, buf = GHOST, self.gc, self.h, self.w, self.vh, self.buf
        # wave 1 (columns, only when column-sharded): gc-wide edge blocks
        if self.n_cols > 1:
            own = buf[:, g:g + h]
            self.shift_into(own[:, :, :gc], own[:, :, w:w + gc], COL, +1)
            self.shift_into(own[:, :, gc + w:], own[:, :, gc:2 * gc], COL, -1)
        # wave 2 (rows): GHOST-row edge blocks of the column-extended rows,
        # so ghost corners ride along. With uneven rows the torus wraps at
        # the last shard's valid edge: it sends its top valid GHOST rows and
        # writes the incoming north ghost there as well
        self.shift_into(buf[:, :g], buf[:, vh:g + vh], ROW, +1)
        if self.pad_rows:  # the two places of the north ghost may overlap
            ghost_n = self.shift(buf[:, g:2 * g], ROW, -1)
            buf[:, g + h:] = ghost_n
            buf[:, vh + g:vh + 2 * g] = ghost_n
        else:
            self.shift_into(buf[:, g + h:], buf[:, g:2 * g], ROW, -1)
        if self.passes is not None:
            self.passes(tots)
        else:
            self.buf, tots[:] = self.kernel(buf, self.mask, **self.window)


class _Overlap(_Chunk):
    """make_overlap_chunk_fn's chunk: the row ghosts travel while an
    interior kernel runs on the owned rows; boundary kernels on 3 GHOST-row
    strips finish the edge rows once they land ('full2d': the column wave
    too, five kernels)."""

    def __init__(self, mesh, *, scheme, **kw):
        super().__init__(mesh, **kw)
        if self.pad_rows:
            raise ValueError(
                "overlap=True supports evenly-sharded rows only (no pad); "
                f"ny={kw['ny']} on {self.n_rows} row-shards pads {self.pad_rows} rows — use "
                "the fused path")
        if self.h < 3 * GHOST:
            raise ValueError(
                f"overlap=True needs >= {3 * GHOST} rows per shard (h={self.h}): "
                "thinner shards have no ghost-independent interior to overlap")
        self.scheme = scheme

    def start(self, f_loc, mask_ext_loc):
        _, h, w = f_loc.shape
        g, gcw = GHOST, GHOST_COLS
        self.w = w
        self.full2d = overlap_scheme(self.n_cols, w, self.scheme) == "full2d"
        m = mask_ext_loc
        if self.full2d:
            # the owned block alone; W/E strips (h, 3 gc), S/N strips
            # (3 GHOST, w + 2 gc)
            self.buf = f_loc.clone()
            self.wb = f_loc.new_empty((9, h, 3 * gcw))
            self.eb = f_loc.new_empty((9, h, 3 * gcw))
            self.masks = [m[g:g + h, gcw:gcw + w].contiguous(), m[g:g + h, :3 * gcw].contiguous(),
                          m[g:g + h, w - gcw:w + 2 * gcw].contiguous()]
        else:
            # the column-extended owned rows (h, w + 2 gc)
            self.buf = f_loc.new_empty((9, h, w + 2 * self.gc))
            self.buf[:, :, self.gc:self.gc + w] = f_loc
            self.masks = [m[g:g + h]]
        width = w + 2 * (gcw if self.full2d else self.gc)
        self.sb = f_loc.new_empty((9, 3 * g, width))
        self.nb = f_loc.new_empty((9, 3 * g, width))
        self.masks += [m[:3 * g], m[h - g:h + 2 * g]]
        gc = gcw if self.full2d else self.gc
        self.interior_window = dict(row_offset=self.row0, valid_rows=(g, h - g),
                                    valid_cols=(gc, w - gc) if self.full2d else (gc, gc + w))
        # B1's interior passes chain their snapshots: the edge rows (and
        # columns) that the boundary kernels and the exchange rewrite are
        # copied into each one; the strips are rewritten whole every chunk
        cols = ([*range(gc), *range(w - gc, w)] if self.full2d
                else [*range(gc), *range(gc + w, w + 2 * gc)])
        self.passes = self.chain(self.buf, self.masks[0], [*range(g), *range(h - g, h)],
                                 cols, **self.interior_window)
        edge = dict(valid_rows=(g, 2 * g), valid_cols=(gc, gc + w))
        self.edge_windows = [dict(row_offset=self.row0 - g, **edge),
                             dict(row_offset=self.row0 + h - 2 * g, **edge)]
        self.strip_passes = [self.chain(b, m_b, None, **win) for b, m_b, win in
                             zip((self.sb, self.nb), self.masks[-2:], self.edge_windows)]
        if self.full2d:
            self.side_window = dict(row_offset=self.row0, valid_rows=(g, h - g),
                                    valid_cols=(gcw, 2 * gcw))
            self.strip_passes += [self.chain(b, m_b, None, **self.side_window) for b, m_b in
                                  zip((self.wb, self.eb), self.masks[1:3])]
        self.t = d2q9_kstep.sums(f_loc, 4 * self.kw["k_steps"]).view(4, -1)

    def interior(self, buf, mask, tot):
        """The interior kernel on the owned block, Sum|u| into tot: buf."""
        if self.passes is not None:
            self.passes(tot)
            return buf
        buf, tot[:] = self.kernel(buf, mask, **self.interior_window)
        return buf

    def strip(self, i, buf, mask, window, tot):
        """Boundary kernel i on a strip buffer, Sum|u| into tot: the strip."""
        if self.strip_passes[0] is not None:
            self.strip_passes[i](tot)
            return buf
        buf, tot[:] = self.kernel(buf, mask, **window)
        return buf

    def own(self):
        gc = 0 if self.full2d else self.gc
        return self.buf[:, :, gc:gc + self.w]

    def __call__(self, tots):
        if self.full2d:
            self._full2d(tots)
        else:
            self._row(tots)

    def _row(self, tots):
        g, gc, h, w, buf = GHOST, self.gc, self.h, self.w, self.buf
        m_own, m_s, m_n = self.masks
        if self.n_cols > 1:
            self.shift_into(buf[:, :, :gc], buf[:, :, w:w + gc], COL, +1)
            self.shift_into(buf[:, :, gc + w:], buf[:, :, gc:2 * gc], COL, -1)
        # 1. start the row-ghost exchange...
        ghost_s, ws = halo_lib.start_ring_shift(buf[:, h - g:], self.mesh, ROW, +1)
        ghost_n, wn = halo_lib.start_ring_shift(buf[:, :g], self.mesh, ROW, -1)
        # the boundary kernels' owned rows, taken before the interior kernel
        # advances the buffer in place
        self.sb[:, g:] = buf[:, :2 * g]
        self.nb[:, :2 * g] = buf[:, h - 2 * g:]
        # 2. ...then the interior kernel, which depends only on the owned
        # rows; rows outside [GHOST, h-GHOST) wrap around the block and are
        # discarded
        buf = self.interior(buf, m_own, tots)
        # 3. boundary kernels: one ghost band + two owned bands -> the GHOST
        # edge rows whose stencil reaches the ghosts
        halo_lib.wait(ws + wn)
        self.sb[:, :g] = ghost_s
        self.nb[:, 2 * g:] = ghost_n
        t_s, t_n = self.t[0], self.t[1]
        self.sb = self.strip(0, self.sb, m_s, self.edge_windows[0], t_s)
        self.nb = self.strip(1, self.nb, m_n, self.edge_windows[1], t_n)
        buf[:, :g] = self.sb[:, g:2 * g]
        buf[:, h - g:] = self.nb[:, g:2 * g]
        self.buf = buf
        tots += t_s
        tots += t_n

    def _full2d(self, tots):
        """Both-wave overlap: the interior kernel depends on no ghosts."""
        g, gcw, h, w, buf = GHOST, GHOST_COLS, self.h, self.w, self.buf
        m_i, m_w, m_e, m_s, m_n = self.masks
        sb, nb, wb, eb = self.sb, self.nb, self.wb, self.eb
        # 1. every first-hop ghost exchange, started before the interior kernel
        firsts = [halo_lib.start_ring_shift(x, self.mesh, axis, d) for x, axis, d in (
            (buf[:, :, -gcw:], COL, +1), (buf[:, :, :gcw], COL, -1),
            (buf[:, -g:], ROW, +1), (buf[:, :g], ROW, -1))]
        # the strips' owned parts, before the interior kernel advances buf
        wb[:, :, gcw:] = buf[:, :, :2 * gcw]
        eb[:, :, :2 * gcw] = buf[:, :, w - 2 * gcw:]
        sb[:, g:, gcw:gcw + w] = buf[:, :2 * g]
        nb[:, :2 * g, gcw:gcw + w] = buf[:, h - 2 * g:]
        # 2. interior kernel: owned block only; cells within K of its edge
        # wrap around it and are discarded
        buf = self.interior(buf, m_i, tots)
        for _, works in firsts:
            halo_lib.wait(works)
        (ghost_w, _), (ghost_e, _), (ghost_s, _), (ghost_n, _) = firsts
        # ghost corners: second-hop COLUMN shifts of the row strips (the two
        # hops commute, so every ghost cell is bitwise the fused path's)
        self.shift_into(sb[:, :g, :gcw], ghost_s[:, :, -gcw:], COL, +1)
        self.shift_into(sb[:, :g, gcw + w:], ghost_s[:, :, :gcw], COL, -1)
        self.shift_into(nb[:, 2 * g:, :gcw], ghost_n[:, :, -gcw:], COL, +1)
        self.shift_into(nb[:, 2 * g:, gcw + w:], ghost_n[:, :, :gcw], COL, -1)
        sb[:, :g, gcw:gcw + w] = ghost_s
        nb[:, 2 * g:, gcw:gcw + w] = ghost_n
        sb[:, g:, :gcw] = ghost_w[:, :2 * g]
        sb[:, g:, gcw + w:] = ghost_e[:, :2 * g]
        nb[:, :2 * g, :gcw] = ghost_w[:, h - 2 * g:]
        nb[:, :2 * g, gcw + w:] = ghost_e[:, h - 2 * g:]
        wb[:, :, :gcw] = ghost_w
        eb[:, :, 2 * gcw:] = ghost_e
        # 3. W/E column-boundary kernels, interior rows only; 4. S/N
        # row-boundary kernels, the full owned width with the corners
        t_w, t_e, t_s, t_n = self.t
        self.wb = self.strip(2, wb, m_w, self.side_window, t_w)
        self.eb = self.strip(3, eb, m_e, self.side_window, t_e)
        self.sb = self.strip(0, sb, m_s, self.edge_windows[0], t_s)
        self.nb = self.strip(1, nb, m_n, self.edge_windows[1], t_n)
        # 5. stitch the four boundary regions into the interior's result
        buf[:, g:h - g, :gcw] = self.wb[:, g:h - g, gcw:2 * gcw]
        buf[:, g:h - g, w - gcw:] = self.eb[:, g:h - g, gcw:2 * gcw]
        buf[:, :g] = self.sb[:, g:2 * g, gcw:gcw + w]
        buf[:, h - g:] = self.nb[:, g:2 * g, gcw:gcw + w]
        self.buf = buf
        for t in (t_w, t_e, t_s, t_n):
            tots += t


def make_chunk_fn(mesh: DeviceMesh, *, k_steps: int, omega: float, accel_w1: float,
                  accel_w2: float, accel_row: int, ny: int, local_engine: str = "inplace"):
    """The fused chunk of this rank: `chunk.start(f_loc, mask_ext_loc)` lays
    its block into the ghost-extended buffer, each `chunk(tots)` advances it
    K steps and writes this rank's Sum|u| per step into tots (K,),
    `chunk.own()` is the owned block. local_engine picks the kernel (see
    _local_stepk)."""
    return _Fused(mesh, k_steps=k_steps, omega=omega, accel_w1=accel_w1, accel_w2=accel_w2,
                  accel_row=accel_row, ny=ny, local_engine=local_engine)


def make_overlap_chunk_fn(mesh: DeviceMesh, *, k_steps: int, omega: float, accel_w1: float,
                          accel_w2: float, accel_row: int, ny: int,
                          local_engine: str = "inplace", scheme: str = "auto"):
    """The exchange/compute-overlapped chunk (the interface of make_chunk_fn).

    A K-step update of owned row j reads rows [j-K, j+K], so owned rows
    [GHOST, h-GHOST) never read a row ghost: their kernel runs while the
    ghost bands travel (under NCCL the sends and receives run on NCCL's
    stream; the boundary kernels wait for them). Two 3*GHOST-row boundary
    kernels (one ghost band + 2 owned bands in, the GHOST edge rows out)
    run once the ghosts land. scheme='full2d' (see `overlap_scheme`)
    overlaps the column wave too, with five kernels.

    The state is bit-identical to the fused path: the same per-cell
    arithmetic, and the kernels' Sum|u| windows partition the owned cells
    (3 or 5 partial sums, so Sum|u| is equal to rounding only).

    Requires evenly-sharded rows (no pad) and h >= 3*GHOST."""
    return _Overlap(mesh, scheme=scheme, k_steps=k_steps, omega=omega, accel_w1=accel_w1,
                    accel_w2=accel_w2, accel_row=accel_row, ny=ny, local_engine=local_engine)


def run(
    f: DTensor,
    mask_ext: DTensor,
    *,
    mesh: DeviceMesh,
    num_steps: int,
    k_steps: int,
    omega: float,
    accel_w1: float,
    accel_w2: float,
    accel_row: int,
    ny: int,
    local_engine: str = "inplace",
    overlap: bool = False,
    scheme: str = "auto",
):
    """num_steps steps in chunks of k_steps. Returns (f_final DTensor, tot_u
    (num_steps,) in the kernels' compute type, the same on every rank)."""
    if num_steps % k_steps:
        raise ValueError("num_steps must be a multiple of k_steps")
    if scheme == "full2d" and not overlap:
        raise ValueError("scheme='full2d' is a scheme of the overlapped chunk; pass "
                         "overlap=True")
    kw = dict(k_steps=k_steps, omega=omega, accel_w1=accel_w1, accel_w2=accel_w2,
              accel_row=accel_row, ny=ny, local_engine=local_engine)
    chunk = (make_overlap_chunk_fn(mesh, scheme=scheme, **kw) if overlap
             else make_chunk_fn(mesh, **kw))
    f_loc = f.to_local()
    chunk.start(f_loc, mask_ext.to_local())
    tots = d2q9_kstep.sums(f_loc, num_steps)
    for i in range(num_steps // k_steps):
        chunk(tots[i * k_steps:(i + 1) * k_steps])
        if profiling.NAN_DEBUG:
            profiling.check_nans(chunk.own(), (i + 1) * k_steps, "a ghost-band chunk", k_steps)
    return (DTensor.from_local(chunk.own().contiguous(), mesh, f.placements, run_check=False),
            mesh_lib.sum_by_rank(tots, mesh))


def prepare(
    params: Params,
    f,
    obstacle_mask,
    mesh: DeviceMesh,
    *,
    first_accelerate: bool = True,
):
    """Lay the state out for run(): pad-and-mask uneven rows, shard, one-off
    guarded acceleration (skip with first_accelerate=False when resuming a
    checkpoint), and build the ghost-extended obstacle mask. `f` and the
    mask are the full arrays, the same on every rank (f a numpy array, or a
    host bfloat16 tensor). Returns (f, mask_ext, pad_rows), the first two
    DTensors on this rank's device."""
    n_rows, n_cols = mesh.shape
    aw = d2q9.AccelWeights.from_params(params)
    obstacle_np = np.asarray(obstacle_mask, bool)
    _, pad = plan_rows(params.ny, n_rows)
    mask_padded = obstacle_np
    if pad:
        # pad-and-mask: equilibrium-filled dead rows in the last shard,
        # masked as obstacles (shared helper with halo.simulate_sharded)
        f, mask_padded = mesh_lib.pad_grid(params, f, obstacle_np, pad, 0)
    device = mesh_lib.local_device()
    f_full = mesh_lib.full_tensor(f, device)
    if first_accelerate:
        f_full = d2q9.first_accelerate(
            f_full, torch.from_numpy(np.ascontiguousarray(mask_padded)).to(device),
            accel_row=params.ny - 2, accel_w1=aw.w1, accel_w2=aw.w2)
    mask_ext = extended_mask(obstacle_np, n_rows, n_cols)
    return (mesh_lib.shard(f_full, mesh, mesh_lib.grid_placements()),
            mesh_lib.shard(mask_ext, mesh, mesh_lib.mask_placements(), device), pad)


def simulate(
    params: Params,
    f,
    obstacle_mask,
    mesh: DeviceMesh | None = None,
    *,
    k_steps: int = 4,
    local_engine: str = "inplace",
    overlap: bool = False,
    scheme: str = "auto",
):
    """Full reference-semantics distributed simulation on the ghost-band +
    local-kernel path. Same contract as d2q9.simulate, with the full
    (9, ny, nx) state and the av_vels the same on every rank.
    local_engine='inplace' (default) runs B1 on each block; 'two-stream'
    B2. overlap=True rides the row-ghost exchange under the interior kernel
    (make_overlap_chunk_fn; even row sharding, >= 24 rows a block);
    scheme='full2d' hides the column wave too (see overlap_scheme)."""
    if mesh is None:
        mesh = make_row_mesh()
    aw = d2q9.AccelWeights.from_params(params)
    ny, nx = params.ny, params.nx
    f_sh, mask_ext, _ = prepare(params, f, obstacle_mask, mesh)
    f_final, tot_u = run(
        f_sh, mask_ext, mesh=mesh, num_steps=params.max_iters,
        k_steps=k_steps, omega=params.omega, accel_w1=aw.w1, accel_w2=aw.w2,
        accel_row=ny - 2, ny=ny, local_engine=local_engine,
        overlap=overlap, scheme=scheme,
    )
    # the free-cell count in the state's type (rounded for bfloat16), the
    # division in Sum|u|'s
    num_free = ny * nx - int(np.asarray(obstacle_mask, bool).sum())
    return (f_final.full_tensor()[:, :ny, :],
            tot_u / torch.tensor(num_free, dtype=f_sh.dtype, device=tot_u.device))
