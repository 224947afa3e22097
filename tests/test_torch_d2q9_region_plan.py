"""The load and store plan of the D2Q9 K-step kernels B1 and B2 on the CPU.

`region_plan` mirrors how a launch moves each tile's region into
shared memory (TMA boxes, then strips the threads patch) and its tile back
out (TMA boxes from the dense tile, and B1's ring). Here the plan is
executed in numpy with TMA's semantics, values beyond the source read as
zeros and a box landing dense at its offset, on a seeded state, and every
tile's assembled region is held bit for bit to the wrapped slice of the state
(B2), or to the state and its boundary snapshot read as the kernels'
cell_source reads them (B1). The plan must keep TMA's limits, and its boxes
and strips must supply every value of a region exactly once. The stores,
executed on the region's interior, must give back the state and, for B1, the
snapshot of the next pass.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lbm_tpu_torch.ops import d2q9_kstep

DTYPES = {4: np.float32, 8: np.float64}
TORCH_DTYPES = {4: torch.float32, 8: torch.float64}


def region_plan(ny: int, nx: int, tile, k_steps: int, itemsize: int, in_place: bool,
                aligned: bool = True) -> dict:
    """How a launch of B1 (`in_place`) or B2 moves every tile's region in and
    its tile out: a mirror of the kernels' load and store plan.

    Returns {"path": choose_path(...), "tiles": [...]}, one entry a tile in
    row-major order with its place (ty, tx, r0, c0, th, tw, rh, rw) and:
      * "boxes": the TMA loads, each {"source": "f" | "hband", "dims": the
        source as (Z, Y, X) (hband as (nty * 9, 2K, nx)), "box": (bz, by,
        bx), "at": (x, y, z) of its first value (values beyond the source read
        as zeros), "smem": its byte offset in the region buffer, where it
        lands dense, "keep": ((q0, q1), (r0, r1), (c0, c1)), the planes, rows
        and columns of the region whose values it supplies};
      * "strips": what the threads load after the boxes have landed, each
        {"source": ..., "rows": (r0, r1), "cols": (c0, c1)} over all nine
        planes, read where the kernels' cell_source reads a region cell. On
        the thread path one strip, source "threads", is the whole region;
      * "stores": the TMA stores from the dense (9, th, tw) tile the last
        step writes, each {"target": "out" | "next_hband", "dims", "box",
        "at", "smem": the byte offset in the dense tile}; B1's out is f;
      * "ring_threads": B1's columns of next_vband, which the threads write,
        each {"cols": (c0, c1) of the tile, "boundary": b, "slots": (i0, i1)}.
    The kernels compute the same boxes and strips per block (kstep_box_kernel,
    strips_of); a run on the card holds B1 and B2 to each other and to the
    plain version."""
    th_full, tw_full = tile
    k, e = k_steps, itemsize
    nty, ntx = -(-ny // th_full), -(-nx // tw_full)
    path = d2q9_kstep.choose_path(ny, nx, tile, k, e, in_place, aligned)
    tiles = []
    for ty in range(nty):
        for tx in range(ntx):
            r0, c0 = ty * th_full, tx * tw_full
            th, tw = min(th_full, ny - r0), min(tw_full, nx - c0)
            rh, rw = th + 2 * k, tw + 2 * k
            entry = dict(ty=ty, tx=tx, r0=r0, c0=c0, th=th, tw=tw, rh=rh, rw=rw, boxes=[],
                         strips=[], stores=[], ring_threads=[])
            tiles.append(entry)
            if path == "thread":
                entry["strips"].append(dict(source="threads", rows=(0, rh), cols=(0, rw)))
                continue
            plane = rh * rw
            lft, rgt = max(0, k - c0), max(0, c0 + tw + k - nx)
            below = (ty + 1) % nty
            f_dims, band_dims = (9, ny, nx), (nty * 9, 2 * k, nx)
            strips = []
            if in_place:
                for q in range(9):
                    entry["boxes"] += [
                        dict(source="hband", dims=band_dims, box=(1, k, rw),
                             at=(c0 - k, 0, ty * 9 + q), smem=q * plane * e,
                             keep=((q, q + 1), (0, k), (lft, rw - rgt))),
                        dict(source="f", dims=f_dims, box=(1, th, rw), at=(c0 - k, r0, q),
                             smem=(q * plane + k * rw) * e,
                             keep=((q, q + 1), (k, k + th), (k, k + tw))),
                        dict(source="hband", dims=band_dims, box=(1, k, rw),
                             at=(c0 - k, k, below * 9 + q), smem=(q * plane + (k + th) * rw) * e,
                             keep=((q, q + 1), (k + th, rh), (lft, rw - rgt)))]
                for rows in ((0, k), (k + th, rh)):
                    strips += [("hband", rows, (0, lft)), ("hband", rows, (rw - rgt, rw))]
                strips += [("vband", (k, k + th), (0, k)), ("vband", (k, k + th), (rw - k, rw))]
            else:
                top, bot = max(0, k - r0), max(0, r0 + th + k - ny)
                entry["boxes"].append(dict(source="f", dims=f_dims, box=(9, rh, rw),
                                           at=(c0 - k, r0 - k, 0), smem=0,
                                           keep=((0, 9), (top, rh - bot), (lft, rw - rgt))))
                strips += [("f", (0, top), (0, rw)), ("f", (rh - bot, rh), (0, rw)),
                           ("f", (top, rh - bot), (0, lft)), ("f", (top, rh - bot), (rw - rgt, rw))]
            entry["strips"] = [dict(source=src, rows=rows, cols=cols) for src, rows, cols in strips
                               if rows[1] > rows[0] and cols[1] > cols[0]]
            entry["stores"].append(dict(target="out", dims=f_dims, box=(9, th, tw),
                                        at=(c0, r0, 0), smem=0))
            if in_place:
                for q in range(9):
                    entry["stores"] += [
                        dict(target="next_hband", dims=band_dims, box=(1, k, tw),
                             at=(c0, k, ty * 9 + q), smem=q * th * tw * e),
                        dict(target="next_hband", dims=band_dims, box=(1, k, tw),
                             at=(c0, 0, below * 9 + q), smem=(q * th * tw + (th - k) * tw) * e)]
                entry["ring_threads"] = [dict(cols=(0, k), boundary=tx, slots=(k, 2 * k)),
                                         dict(cols=(tw - k, tw), boundary=(tx + 1) % ntx,
                                              slots=(0, k))]
    return dict(path=path, tiles=tiles)


def seeded_state(ny, nx, itemsize, seed=10):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, (9, ny, nx)).astype(DTYPES[itemsize])


def snapshot(f, tile, k):
    """The boundary snapshot as the kernels' snapshot kernels take it:
    hband[b, q, i, x] is row (b*th - k + i) mod ny, vband[b, q, y, i]
    column (b*tw - k + i) mod nx."""
    _, ny, nx = f.shape
    th, tw = tile
    rows = (np.arange(-(-ny // th))[:, None] * th - k + np.arange(2 * k)[None, :]) % ny
    cols = (np.arange(-(-nx // tw))[:, None] * tw - k + np.arange(2 * k)[None, :]) % nx
    hband = f[:, rows, :].transpose(1, 0, 2, 3)  # (nty, 9, 2k, nx)
    vband = f[:, :, cols].transpose(2, 0, 1, 3)  # (ntx, 9, ny, 2k)
    return np.ascontiguousarray(hband), np.ascontiguousarray(vband)


def cell_source(f, hband, vband, t, tile, k, in_place, r, c):
    """The nine values of region cell (r, c) of tile t, where the kernels'
    cell_source reads them."""
    _, ny, nx = f.shape
    gr, gc = (t["r0"] - k + r) % ny, (t["c0"] - k + c) % nx
    if in_place:
        nty, ntx = hband.shape[0], vband.shape[0]
        if r < k or r >= k + t["th"]:
            b = t["ty"] if r < k else (t["ty"] + 1) % nty
            return hband[b, :, r if r < k else r - t["th"], gc]
        if c < k or c >= k + t["tw"]:
            b = t["tx"] if c < k else (t["tx"] + 1) % ntx
            return vband[b, :, gr, c if c < k else c - t["tw"]]
    return f[:, gr, gc]


def check_box(box, itemsize, smem_limit):
    """TMA's limits: sides of at most 256, box rows and source rows of whole
    16-byte pieces, a first column on 16 bytes (an H100 traps on a box load
    8 bytes off), a shared-memory offset of a multiple of 128 bytes, the box
    inside the buffer it lands in or leaves from."""
    bz, by, bx = box["box"]
    assert max(bz, by, bx) <= d2q9_kstep.MAX_BOX and min(bz, by, bx) >= 1
    assert (bx * itemsize) % 16 == 0 and (box["dims"][2] * itemsize) % 16 == 0
    assert (box["at"][0] * itemsize) % 16 == 0
    assert box["smem"] % 128 == 0
    assert box["smem"] + bz * by * bx * itemsize <= smem_limit


def read_box(src, box):
    """The box of src (Z, Y, X) at (x, y, z) as TMA reads it, zeros beyond
    the source, and the mask of the values that lay inside it."""
    bz, by, bx = box["box"]
    x, y, z = box["at"]
    zz, yy, xx = np.ix_(np.arange(z, z + bz), np.arange(y, y + by), np.arange(x, x + bx))
    inside = ((zz >= 0) & (zz < src.shape[0]) & (yy >= 0) & (yy < src.shape[1])
              & (xx >= 0) & (xx < src.shape[2]))
    vals = np.where(inside, src[np.clip(zz, 0, src.shape[0] - 1), np.clip(yy, 0, src.shape[1] - 1),
                                np.clip(xx, 0, src.shape[2] - 1)], 0)
    return vals.astype(src.dtype), np.broadcast_to(inside, vals.shape)


def assemble(plan_tile, f, hband, vband, tile, k, in_place, itemsize):
    """Executes a tile's loads: the boxes land dense in the region buffer,
    then the threads store the strips. Returns the region (9, rh, rw) and how
    many of the boxes' kept values and strip cells supplied each value."""
    rh, rw = plan_tile["rh"], plan_tile["rw"]
    n = 9 * rh * rw
    smem = np.full(n, np.nan, dtype=f.dtype)
    landed = np.zeros(n, dtype=int)  # TMA writes of each value (in no order)
    supplied = np.zeros((9, rh, rw), dtype=int)
    sources = {"f": f, "hband": hband.reshape(-1, *hband.shape[2:]) if hband is not None else None}
    for box in plan_tile["boxes"]:
        check_box(box, itemsize, n * itemsize)
        src = sources[box["source"]]
        assert src.shape == tuple(box["dims"])
        vals, inside = read_box(src, box)
        off = box["smem"] // itemsize
        smem[off:off + vals.size] = vals.ravel()
        landed[off:off + vals.size] += 1
        (q0, q1), (r0, r1), (c0, c1) = box["keep"]
        kept = np.zeros(n, dtype=bool)
        kept.reshape(9, rh, rw)[q0:q1, r0:r1, c0:c1] = True
        # what a box keeps, it placed from inside its source
        placed = np.zeros(n, dtype=bool)
        placed[off:off + vals.size] = inside.ravel()
        assert not (kept & ~placed).any(), f"box {box} keeps values it did not read"
        supplied[q0:q1, r0:r1, c0:c1] += 1
    assert landed.max(initial=0) <= 1, "two boxes land on the same values"
    region = smem.reshape(9, rh, rw)
    for strip in plan_tile["strips"]:
        (r0, r1), (c0, c1) = strip["rows"], strip["cols"]
        for r in range(r0, r1):
            for c in range(c0, c1):
                if strip["source"] != "threads":
                    # the source the plan names is the one cell_source reads
                    edge = r < k or r >= k + plan_tile["th"]
                    side = c < k or c >= k + plan_tile["tw"]
                    want = ("hband" if edge else "vband" if side else "f") if in_place else "f"
                    assert strip["source"] == want, (strip, r, c)
                region[:, r, c] = cell_source(f, hband, vband, plan_tile, tile, k, in_place, r, c)
        supplied[:, r0:r1, c0:c1] += 1
    return region, supplied


def execute_stores(plan, f, tile, k, in_place, itemsize):
    """Copy mode: each tile's interior, dense (9, th, tw), leaves by the
    plan's stores. Returns the state written and, in place, the snapshot the
    next pass reads."""
    _, ny, nx = f.shape
    th, tw = tile
    out = np.full_like(f, np.nan)
    nty, ntx = -(-ny // th), -(-nx // tw)
    next_h = np.full((nty * 9, 2 * k, nx), np.nan, dtype=f.dtype)
    next_v = np.full((ntx, 9, ny, 2 * k), np.nan, dtype=f.dtype)
    targets = {"out": out, "next_hband": next_h}
    for t in plan["tiles"]:
        dense = f[:, t["r0"]:t["r0"] + t["th"], t["c0"]:t["c0"] + t["tw"]].ravel()
        for st in t["stores"]:
            check_box(st, itemsize, dense.size * itemsize)
            dst = targets[st["target"]]
            assert dst.shape == tuple(st["dims"])
            bz, by, bx = st["box"]
            x, y, z = st["at"]
            assert 0 <= x and x + bx <= dst.shape[2] and 0 <= y and y + by <= dst.shape[1]
            off = st["smem"] // itemsize
            dst[z:z + bz, y:y + by, x:x + bx] = dense[off:off + bz * by * bx].reshape(bz, by, bx)
        for part in t["ring_threads"]:
            (c0, c1), (i0, i1) = part["cols"], part["slots"]
            rows = slice(t["r0"], t["r0"] + t["th"])
            next_v[part["boundary"], :, rows, i0:i1] = f[:, rows, t["c0"] + c0:t["c0"] + c1]
    return out, next_h.reshape(nty, 9, 2 * k, nx), next_v


def hold_plan(ny, nx, tile, k, itemsize, in_place):
    f = seeded_state(ny, nx, itemsize)
    hband, vband = snapshot(f, tile, k) if in_place else (None, None)
    plan = region_plan(ny, nx, tile, k, itemsize, in_place)
    assert plan["path"] == d2q9_kstep.choose_path(ny, nx, tile, k, itemsize, in_place)
    nty, ntx = -(-ny // tile[0]), -(-nx // tile[1])
    assert [(t["ty"], t["tx"]) for t in plan["tiles"]] == [(a, b) for a in range(nty)
                                                          for b in range(ntx)]
    for t in plan["tiles"]:
        region, supplied = assemble(t, f, hband, vband, tile, k, in_place, itemsize)
        assert (supplied == 1).all(), f"tile {t['ty']},{t['tx']}: a value supplied 0 or 2 times"
        rows = (t["r0"] - k + np.arange(t["rh"])) % ny
        cols = (t["c0"] - k + np.arange(t["rw"])) % nx
        wrapped = f[:, rows][:, :, cols]
        # B1's snapshot was taken from f, so its region is B2's, bit for bit
        assert np.array_equal(region, wrapped), f"tile {t['ty']},{t['tx']}"
        if in_place:
            via = np.stack([np.stack([cell_source(f, hband, vband, t, tile, k, True, r, c)
                                      for c in range(t["rw"])], axis=1)
                            for r in range(t["rh"])], axis=1)
            assert np.array_equal(region, via)
    return plan, f, hband, vband


@pytest.mark.parametrize("in_place", [False, True], ids=["B2", "B1"])
@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(64, 64), (40, 72)], ids=["64x64", "40x72"])
def test_region_plan_assembles_every_region(shape, k, itemsize, in_place):
    """Both grids wrap on both axes (40x72 in 8x8 tiles, 64x64 in 16x32);
    every path that the rule picks here assembles every region exactly."""
    ny, nx = shape
    tile = d2q9_kstep.choose_config(ny, nx, TORCH_DTYPES[itemsize])[:2]
    plan, f, hband, vband = hold_plan(ny, nx, tile, k, itemsize, in_place)
    if plan["path"] == "box":
        out, next_h, next_v = execute_stores(plan, f, tile, k, in_place, itemsize)
        assert np.array_equal(out, f)
        if in_place:
            assert np.array_equal(next_h, hband) and np.array_equal(next_v, vband)
        # a tile away from the grid's edges needs no strip in B2; in B1 only
        # the 2K columns beside it, from vband
        inner = [t for t in plan["tiles"] if 0 < t["ty"] < max(t2["ty"] for t2 in plan["tiles"])
                 and 0 < t["tx"] < max(t2["tx"] for t2 in plan["tiles"])]
        for t in inner:
            assert [s["source"] for s in t["strips"]] == (["vband", "vband"] if in_place else [])


@pytest.mark.parametrize("in_place", [False, True], ids=["B2", "B1"])
def test_region_plan_flagship_is_the_box_path(in_place):
    """1024^2, f32, 16x32, K=4: boxes; 188 of B2's 2,048 tiles (those whose
    region wraps) and all of B1's carry strips, B1's edge columns corners
    too; three boxes a plane in place, one box else."""
    ny = nx = 1024
    th, tw, k = d2q9_kstep.choose_config(ny, nx)
    plan = region_plan(ny, nx, (th, tw), k, 4, in_place)
    assert plan["path"] == "box" and len(plan["tiles"]) == 2048
    with_strips = [t for t in plan["tiles"] if t["strips"]]
    assert len(with_strips) == (2048 if in_place else 188)
    assert {len(t["boxes"]) for t in plan["tiles"]} == {27 if in_place else 1}
    assert {len(t["stores"]) for t in plan["tiles"]} == {19 if in_place else 1}
    corners = [t for t in plan["tiles"] if len(t["strips"]) > 2]
    assert len(corners) == (128 if in_place else 0)
    # the block keeps three blocks an SM of the H100's 228 KB (1 KB each reserved)
    assert 3 * (d2q9_kstep.box_smem_bytes(th, tw, k, 4) + 1024) <= 228 * 1024


@pytest.mark.parametrize("in_place", [False, True], ids=["B2", "B1"])
@pytest.mark.parametrize("case", ["edge_tiles", "k3_f32", "misaligned"])
def test_region_plan_thread_path(case, in_place):
    """Edge tiles (64x1001), K=3 in float32 (a region row of 38 values is
    not whole 16-byte pieces) and a state off 16 bytes take the thread path,
    whose one strip is the whole region, read as cell_source reads it."""
    shape, k, itemsize, aligned = {"edge_tiles": ((64, 1001), 4, 4, True),
                                   "k3_f32": ((64, 64), 3, 4, True),
                                   "misaligned": ((64, 64), 4, 4, False)}[case]
    tile = d2q9_kstep.choose_config(*shape)[:2]
    assert d2q9_kstep.choose_path(*shape, tile, k, itemsize, in_place, aligned) == "thread"
    plan = region_plan(*shape, tile, k, itemsize, in_place, aligned)
    assert plan["path"] == "thread"
    for t in plan["tiles"]:
        assert not t["boxes"] and not t["stores"]
        assert t["strips"] == [dict(source="threads", rows=(0, t["rh"]), cols=(0, t["rw"]))]
    if case == "k3_f32":
        hold_plan(*shape, tile, k, itemsize, in_place)


def test_box_smem_bytes_formula():
    # smem_bytes with each state buffer rounded to 128 B, the mbarrier's 16 B
    # and 128 B to align the base: 70,352 B at the flagship's 16x32, K=4, f32
    assert d2q9_kstep.box_smem_bytes(16, 32, 4, 4) == d2q9_kstep.smem_bytes(16, 32, 4, 4) + 144
    assert d2q9_kstep.box_smem_bytes(16, 32, 4, 4) == 70352
    # 8x8, K=3: a 14x14 region, 7,056 B a state buffer (7,168 rounded to 128)
    assert d2q9_kstep.box_smem_bytes(8, 8, 3, 4) == 128 + 7168 + 7056 + 16 + 64 + 196 + 28
