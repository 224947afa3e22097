"""The box path and the in-place schedule of the blocked D3Q19 kernels B5 and
B7 (csrc/d3q19_blocked.cu), modelled in Python and held to what the kernel
relies on. No card is needed: these are the plans, not the kernel.

The region of a tile on the box path (`region_plan`, a mirror of the
kernel's load): 19 rank-4 boxes, one a speed, of (1, ez - 2, ey - 2, sx)
values, speed q's taken one streaming step early in z and y (at planes and
rows shifted by -e_q), its rows widened to whole 16-byte pieces
(`d3q19_kstep_blocked.box_extent`), TMA filling what lies beyond the grid
with zeros; then the threads load the values of each speed's box that lie
beyond a periodic edge from the wrapped cell, or, for B5's last z-rows,
from the snapshot of planes [0, K). Held here: every box starts on 16 bytes
and has no side over 256; for each speed the box's cells in the grid and the
threads' strips partition what the first step pulls exactly; executed in
numpy, the buffer holds the old state's periodic neighbourhood of the tile
wherever the tile's K steps read it; and K streaming steps taken with the
kernel's own addresses (the AA pattern on the shifted buffer) give K
periodic pull-streams of the tile. `choose_path` (mirror
of box_fits) is held on cases of each rule.

B5's schedule (`schedule`, a mirror of in_place): launch r steps z-row r of
tiles into ring slot r mod (lag + 2) and, with extra blocks, flushes ring row
r - lag - 1 into the lattice; one last launch flushes the rows left. Its
rounds run at plane granularity: no flush writes a plane that a row of the
same launch reads, no row reads a plane that a flush has already written
(the snapshot serves the planes past the last), no ring slot is written
before its flush has read it, and every plane is written once.
"""

import itertools

import numpy as np
import pytest
import torch

from lbm_tpu_torch.ops import d3q19_kstep_blocked as b7
from lbm_tpu_torch.ops import d3q19_kstep_inplace_blocked as b5
from lbm_tpu_torch.ops.d3q19_lattice import E, OPPOSITE

ITEMSIZE = {torch.float32: 4, torch.float64: 8}


def region_plan(shape, tile, k, itemsize, block, nsnap=0, shifted=True):
    """The boxes and strips of the tile at `block` = (iz, iy, ix): a list,
    by speed q, of (box start (x, y, z), box size (sx, ny_b, nz_b), strips)
    with strips {(bz, by, bx): ("f" | "snap", (z, y, x))}, the buffer cells
    of speed q's box that lie beyond the grid and that the steps read (B5's
    last rows read planes z < nsnap past the end from "snap"). `shifted`:
    the boxes taken one streaming step early (every mode but copy)."""
    nz, ny, nx = shape
    tz, ty, tx = tile
    iz, iy, ix = block
    nz_b, ny_b, sx, lp = b7.box_extent(tile, k, itemsize)
    ex = tx + 2 * k
    z0, y0, x0 = iz * tz - k, iy * ty - k, ix * tx - k
    plan = []
    for q in range(19):
        dz, dy, _ = (int(v) * shifted for v in E[q])
        start = (x0 - lp, y0 + 1 - dy, z0 + 1 - dz)
        strips = {}
        for bz, by, lx in itertools.product(range(nz_b), range(ny_b), range(ex)):
            uz, uy, ux = start[2] + bz, start[1] + by, x0 + lx
            if 0 <= uz < nz and 0 <= uy < ny and 0 <= ux < nx:
                continue
            z, y, x = uz % nz, uy % ny, ux % nx
            source = "snap" if uz >= nz and z < nsnap else "f"
            strips[(bz, by, lp + lx)] = (source, (z, y, x))
        plan.append((start, (sx, ny_b, nz_b), strips))
    return plan


def box_cells(shape, start, size, lp, ex):
    """The buffer cells (bz, by, bx) that a box brings from the grid, among
    the columns the steps read."""
    nz, ny, nx = shape
    (x, y, z), (sx, ny_b, nz_b) = start, size
    return {(bz, by, bx) for bz, by, bx in itertools.product(range(nz_b), range(ny_b), range(sx))
            if 0 <= z + bz < nz and 0 <= y + by < ny and 0 <= x + bx < nx
            and lp <= bx < lp + ex}


def run_plan(current, snap, tile, k, block, itemsize, shifted=True):
    """The buffer the plan fills, (19, nz_b, ny_b, sx): each speed's box from
    `current` (what the lattice holds when the launch runs), zeros beyond the
    grid, then its strips from `current` or `snap`."""
    _, nz, ny, nx = current.shape
    plan = region_plan((nz, ny, nx), tile, k, itemsize, block, snap.shape[1], shifted)
    nz_b, ny_b, sx, _ = b7.box_extent(tile, k, itemsize)
    buf = np.zeros((19, nz_b, ny_b, sx), current.dtype)
    for q, ((x, y, z), _, strips) in enumerate(plan):
        zs, ys, xs = np.arange(z, z + nz_b), np.arange(y, y + ny_b), np.arange(x, x + sx)
        inside = (((zs >= 0) & (zs < nz))[:, None, None] & ((ys >= 0) & (ys < ny))[None, :, None]
                  & ((xs >= 0) & (xs < nx))[None, None, :])
        box = current[q][np.ix_(np.clip(zs, 0, nz - 1), np.clip(ys, 0, ny - 1),
                                np.clip(xs, 0, nx - 1))]
        buf[q] = np.where(inside, box, 0)
        for (bz, by, bx), (source, (zz, yy, xx)) in strips.items():
            buf[q, bz, by, bx] = (snap if source == "snap" else current)[q, zz, yy, xx]
    return buf


def stream_with_kernel_addresses(buf, tile, k, itemsize):
    """K streaming steps of the kernel's box path on its buffer, with its own
    addresses (no collision: stream_only): odd steps pull slot (c - e_q, q)
    and store o[opp] there, even steps read (c, opp(q)) and store (c, q),
    each through the shifted layout (slot (c, q) at buf[q][c + dz sz + dy
    sy]); the last step's values of the tile's cells are what it stores.
    Returns the tile, (19, tz, ty, tx)."""
    tz, ty, tx = tile
    nz_b, ny_b, sx, lp = b7.box_extent(tile, k, itemsize)
    flat = buf.reshape(19, -1).copy()
    sz, sy = ny_b * sx, sx
    ez, ey, ex = tz + 2 * k, ty + 2 * k, tx + 2 * k
    for j in range(1, k + 1):
        lo = k if j == k else j  # the last step's region is the tile
        lz, ly, lx = np.meshgrid(np.arange(lo, ez - lo), np.arange(lo, ey - lo),
                                 np.arange(lo, ex - lo), indexing="ij")
        c = ((lz - 1) * sz + (ly - 1) * sy + lp + lx).ravel()
        if j % 2:  # pull: the z and y parts of e_q and of q's shift cancel
            s = np.stack([flat[q][c - E[q][2]] for q in range(19)])
        else:
            s = np.stack([flat[OPPOSITE[q]][c - (E[q][0] * sz + E[q][1] * sy)]
                          for q in range(19)])
        if j == k:
            return s.reshape(19, tz, ty, tx)
        for q in range(19):
            if j % 2:
                flat[q][c - E[q][2]] = s[OPPOSITE[q]]
            else:
                flat[q][c + E[q][0] * sz + E[q][1] * sy] = s[q]


GRIDS = [
    # (shape, tile, K, dtype)
    ((32, 256, 256), (8, 6, 16), 2, torch.float32),
    ((12, 16, 32), (8, 6, 16), 2, torch.float32),   # wraps in every axis, edge tiles in z
    ((12, 16, 32), (2, 4, 8), 3, torch.float32),
    ((10, 12, 16), (4, 4, 4), 1, torch.float32),
    ((9, 10, 12), (3, 5, 4), 4, torch.float32),
    ((8, 12, 16), (2, 4, 4), 2, torch.float64),
    ((8, 12, 16), (4, 3, 2), 3, torch.float64),
]


def blocks_of(shape, tile):
    return itertools.product(*(range(-(-n // t)) for n, t in zip(shape, tile)))


@pytest.mark.parametrize("shape, tile, k, dtype", GRIDS)
def test_boxes_start_on_16_bytes_and_keep_to_256(shape, tile, k, dtype):
    itemsize = ITEMSIZE[dtype]
    nz_b, ny_b, sx, lp = b7.box_extent(tile, k, itemsize)
    assert (sx * itemsize) % 16 == 0 and 0 <= lp < 16 // itemsize
    assert max(nz_b, ny_b, sx, 19) <= b7.MAX_BOX
    for block in blocks_of(shape, tile):
        for (x, _, _), size, _ in region_plan(shape, tile, k, itemsize, block):
            assert (x * itemsize) % 16 == 0, f"box at column {x}"
            assert max(size) <= b7.MAX_BOX


@pytest.mark.parametrize("shape, tile, k, dtype", GRIDS)
def test_boxes_and_strips_partition_what_the_first_step_pulls(shape, tile, k, dtype):
    itemsize = ITEMSIZE[dtype]
    tz, ty, tx = tile
    nz_b, ny_b, _, lp = b7.box_extent(tile, k, itemsize)
    ex = tx + 2 * k
    # every speed's buffer: planes and rows [1, e - 1) as the first step
    # pulls them, the extended tile's columns
    needed = set(itertools.product(range(nz_b), range(ny_b), range(lp, lp + ex)))
    wrapped = 0
    for block in blocks_of(shape, tile):
        for start, size, strips in region_plan(shape, tile, k, itemsize, block, nsnap=k):
            from_box = box_cells(shape, start, size, lp, ex)
            assert not from_box & set(strips), "a value comes from the box and a strip"
            assert from_box | set(strips) == needed
            wrapped += bool(strips)
    assert wrapped > 0  # the first and last tiles of every axis wrap


@pytest.mark.parametrize("shape, tile, k, dtype", GRIDS[1:])
def test_the_plan_fills_the_periodic_neighbourhood(shape, tile, k, dtype):
    """Executed in numpy, each speed's buffer holds the old state's periodic
    neighbourhood of the tile one streaming step early. B5: when z-row iz
    runs, the rows up to iz - lag - 1 have been flushed, or are being
    flushed, so the lattice holds other values there (-1 here); the
    snapshot keeps planes [0, K) as they were, and the buffer takes every
    plane past the end that the tile's steps read from it."""
    itemsize = ITEMSIZE[dtype]
    nz, ny, nx = shape
    tz, ty, tx = tile
    lag = -(-k // tz)
    nz_b, ny_b, _, lp = b7.box_extent(tile, k, itemsize)
    rng = np.random.default_rng(0)
    old = rng.random((19, nz, ny, nx))
    snap = old[:, :min(k, nz)].copy()
    for block in blocks_of(shape, tile):
        iz, iy, ix = block
        current = old.copy()
        current[:, :max(0, iz - lag) * tz] = -1.0  # flushed rows hold new values
        buf = run_plan(current, snap, tile, k, block, itemsize)
        # the planes the tile's K steps read: its own in the grid and K a side
        own_hi = min((iz + 1) * tz, nz) - iz * tz + k
        for q in range(19):
            dz, dy, _ = E[q]
            zs = np.arange(iz * tz - k + 1 - dz, iz * tz - k + 1 - dz + nz_b)
            keep = (zs >= iz * tz - k) & (zs < iz * tz + own_hi)
            ys = np.arange(iy * ty - k + 1 - dy, iy * ty - k + 1 - dy + ny_b)
            xs = np.arange(ix * tx - k, (ix + 1) * tx + k)
            want = old[q][zs[keep] % nz][:, ys % ny][:, :, xs % nx]
            np.testing.assert_array_equal(buf[q][keep][:, :, lp:lp + tx + 2 * k], want)


@pytest.mark.parametrize("shape, tile, k, dtype", GRIDS[1:] + [((6, 8, 8), (2, 4, 4), 4,
                                                               torch.float32)])
def test_k_streams_by_the_kernels_addresses(shape, tile, k, dtype):
    """stream_only on the box path, by the kernel's addresses: each tile
    equals K periodic pull-streams of the lattice (bit for bit: streaming
    only moves values)."""
    itemsize = ITEMSIZE[dtype]
    nz, ny, nx = shape
    tz, ty, tx = tile
    rng = np.random.default_rng(1)
    old = rng.random((19, nz, ny, nx))
    want = old.copy()
    for _ in range(k):
        want = np.stack([np.roll(want[q], tuple(int(v) for v in E[q]), axis=(0, 1, 2))
                         for q in range(19)])
    for block in blocks_of(shape, tile):
        iz, iy, ix = block
        got = stream_with_kernel_addresses(run_plan(old, old[:, :k], tile, k, block, itemsize),
                                           tile, k, itemsize)
        zs = np.arange(iz * tz, (iz + 1) * tz)
        ys = np.arange(iy * ty, (iy + 1) * ty)
        xs = np.arange(ix * tx, (ix + 1) * tx)
        inside = np.ix_(zs < nz, ys < ny, xs < nx)  # an edge tile's cells beyond are clipped
        np.testing.assert_array_equal(
            got[:, inside[0][:, 0, 0]][:, :, inside[1][0, :, 0]][:, :, :, inside[2][0, 0, :]],
            want[:, zs[zs < nz]][:, :, ys[ys < ny]][:, :, :, xs[xs < nx]])


def test_copy_mode_boxes_are_not_shifted():
    """Copy steps nothing, so its boxes come unshifted and hold every own
    cell of the tile at every K, K = 1 included."""
    shape, tile, itemsize = (12, 16, 32), (8, 6, 16), 4
    rng = np.random.default_rng(2)
    old = rng.random((19, *shape))
    for k in (1, 2):
        nz_b, ny_b, sx, lp = b7.box_extent(tile, k, itemsize)
        buf = run_plan(old, old[:, :k], tile, k, (0, 1, 1), itemsize, shifted=False)
        own = buf[:, k - 1:k - 1 + tile[0], k - 1:k - 1 + tile[1], lp + k:lp + k + tile[2]]
        np.testing.assert_array_equal(own, old[:, :tile[0], 6:12, 16:32])


@pytest.mark.parametrize("shape, tile, k, dtype, path", [
    ((32, 256, 256), (8, 6, 16), 2, torch.float32, "box"),
    ((32, 256, 256), (6, 8, 16), 2, torch.float32, "box"),    # 147,976 B
    ((32, 256, 256), (8, 5, 16), 1, torch.float32, "box"),
    ((32, 256, 256), (5, 8, 8), 2, torch.float64, "box"),
    ((32, 256, 256), (6, 16, 16), 1, torch.float32, "box"),     # 177,544 B
    ((32, 256, 256), (8, 12, 32), 2, torch.float32, "thread"),  # shared memory
    ((32, 256, 256), (8, 6, 10), 2, torch.float32, "thread"),   # tile rows off 16 bytes
    ((13, 50, 70), (6, 8, 16), 2, torch.float32, "thread"),     # lattice rows off 16 bytes
    ((12, 16, 32), (8, 6, 16), 2, torch.float32, "box"),
    ((11, 16, 32), (8, 6, 16), 2, torch.float32, "thread"),     # the box deeper than the grid
    ((32, 256, 256), (4, 4, 200), 2, torch.float32, "thread"),  # a box side over 256
])
def test_choose_path(shape, tile, k, dtype, path):
    assert b7.choose_path(*shape, tile, k, dtype) == path
    if path == "box":
        assert b7.choose_path(*shape, tile, k, dtype, aligned=False) == "thread"
        assert b7.box_shared_bytes(tile, k, dtype) + b7.STATIC_SMEM <= 227 * 1024


def test_box_shared_bytes_mirrors_the_kernel():
    # (6, 8, 16) at K = 2 in float32: a buffer of (8, 10, 24) cells, 19
    # speeds of 7,680 B (on 128 bytes already) and a mask byte a cell, the
    # alignment slack and the mbarrier
    assert b7.box_extent((6, 8, 16), 2, 4) == (8, 10, 24, 2)
    assert b7.box_shared_bytes((6, 8, 16), 2) == 128 + 19 * 7680 + 1920 + 8 == 147976
    # a speed's plane of 1,344 B takes 1,408
    assert b7.box_extent((1, 5, 4), 2, 8) == (3, 7, 8, 0)
    assert b7.box_shared_bytes((1, 5, 4), 2, torch.float64) == 128 + 19 * 1408 + 168 + 8
    assert b7.box_extent((5, 8, 8), 1, 8) == (5, 8, 12, 1)
    assert b7.box_extent((5, 8, 8), 3, 8) == (9, 12, 16, 1)
    assert b7.box_extent((5, 8, 8), 4, 4) == (11, 14, 16, 0)


def schedule(nz, tz, k):
    """The launches of one B5 pass (mirrors in_place in
    csrc/d3q19_blocked.cu): a list of launches, each a list of ("row", r,
    slot) and ("flush", d, slot)."""
    gz, lag = -(-nz // tz), -(-k // tz)
    ring_rows = lag + 2
    launches = []
    for r in range(gz):
        acts = [("row", r, r % ring_rows)]
        if r - lag - 1 >= 0:
            acts.append(("flush", r - lag - 1, (r - lag - 1) % ring_rows))
        launches.append(acts)
    first = max(0, gz - lag - 1)
    launches.append([("flush", d, d % ring_rows) for d in range(first, gz)])
    return launches, ring_rows


def row_planes(r, nz, tz):
    return range(r * tz, min((r + 1) * tz, nz))


@pytest.mark.parametrize("nz, tz, k", [(32, 6, 2), (32, 4, 2), (32, 8, 2), (32, 2, 3),
                                       (12, 2, 4), (13, 5, 1), (8, 8, 2), (5, 2, 4),
                                       (32, 1, 4), (7, 3, 3), (4, 4, 1), (2, 1, 2)])
def test_the_folded_flush_schedule(nz, tz, k):
    launches, ring_rows = schedule(nz, tz, k)
    assert ring_rows * tz == b7.scratch_planes((tz, 1, 8), k, nz)[0]
    nsnap = min(k, nz)
    written = np.zeros(nz, int)     # flushes that wrote each plane
    slot_row = [None] * ring_rows   # the ring row a slot holds, until flushed
    for acts in launches:
        rows = [a for a in acts if a[0] == "row"]
        flushes = [a for a in acts if a[0] == "flush"]
        flushed_now = {z for _, d, _ in flushes for z in row_planes(d, nz, tz)}
        for _, r, slot in rows:
            own = row_planes(r, nz, tz)
            for uz in range(own.start - k, own.stop + k):  # what the tile's K steps read
                z = uz % nz
                if uz >= nz:
                    assert z < nsnap, f"row {r} reads plane {z} past the end, not in the snapshot"
                    continue
                assert written[z] == 0, f"row {r} reads plane {z} after its flush"
                assert z not in flushed_now, f"a flush writes plane {z} while row {r} reads it"
            assert slot not in {s for _, _, s in flushes}, "a slot written while flushed"
            assert slot_row[slot] is None, f"ring slot {slot} written before its flush read it"
        for _, d, slot in flushes:
            assert slot_row[slot] == d, f"flush of row {d} finds slot {slot} of {slot_row[slot]}"
        for _, d, slot in flushes:
            slot_row[slot] = None
            for z in row_planes(d, nz, tz):
                written[z] += 1
        for _, r, slot in rows:
            slot_row[slot] = r
    assert (written == 1).all() and all(s is None for s in slot_row)
    # one launch a z-row of tiles and one for the rows left: no copy launch
    # of its own for any flush but the last
    assert len(launches) == -(-nz // tz) + 1


def test_b5_tiles_keep_the_ring_under_the_scratch_share():
    """With lag + 2 ring rows B5's tile stays within `max_scratch_planes`, so
    a run peaks under 1.5 x the lattice."""
    for k in (1, 2, 3, 4):
        for dtype in ITEMSIZE:
            tile = b5.choose_config(32, 256, 256, k, dtype, "cpu")
            assert sum(b7.scratch_planes(tile, k, 32)) <= b5.max_scratch_planes(32, k)


def test_a_forced_path_raises_where_it_cannot_run():
    """`path="thread"` compares the two paths; it raises where the thread
    path's block does not fit (the box path's buffer is smaller), as
    `path="box"` does where the rule says "thread"."""
    f = torch.zeros((19, 12, 16, 32))
    assert b7.resolve_path(None, f, (4, 6, 16), 2) == "box"
    assert b7.resolve_path("thread", f, (4, 6, 16), 2) == "thread"
    assert b7.resolve_path(None, f, (4, 6, 16), 4) == "box"  # 221,896 B
    assert not b7.thread_fits((4, 6, 16), 4)                    # 310,464 B
    with pytest.raises(ValueError, match="does not fit the thread path"):
        b7.resolve_path("thread", f, (4, 6, 16), 4)
    with pytest.raises(ValueError, match="box path does not take"):
        b7.resolve_path("box", torch.zeros((19, 13, 50, 70)), (2, 9, 32), 2)
    with pytest.raises(ValueError, match="path must be one of"):
        b7.resolve_path("tma", f, (4, 6, 16), 2)
