"""The resident blur's scheme (csrc/blur_resident.cuh, kernels B8 and B13)
as a small PyTorch model, held bit for bit against the variants' plain
versions (lbm_tpu_torch.ops.blur_resident_opt.plain), and the rules around
it that run on the CPU: the depth a launch takes, the exchange's layout and
its tags.

The model does what each block of the kernel does, in the kernel's layout:
a tile with a halo k cells deep (k rows, k*hw columns; hw = C for v2's
(h, w*C) layout), k passes on a region that shrinks by one cell a side a
pass, the mask or the ring over every cell a pass computes, then the
tile's first and last k rows and k*hw columns written to the exchange
(two parities) and the halo read from the neighbours' edges with periodic
wrap, rows across the tile and k*hw columns more a side (the corners); the
run's remainder of passes mod k is a shorter last group. Only the tags and
the order in which blocks run are left out: the kernel's tags make a block
read exactly what the model reads.
"""

import numpy as np
import pytest
import torch
from test_torch_blur_resident_opt import FIT_TABLE

from lbm_tpu_torch.ops import blur_resident_opt as bro
from lbm_tpu_torch.ops import stencil

F32, BF16 = torch.float32, torch.bfloat16
DTYPES = {"float32": F32, "bfloat16": BF16}
# (C, h, w), interior (h0, w0), and the tiles of the (C, h, w) layout and of
# v2's (h, w*C): short last tiles, one tile row, one tile column
CASES = {
    "odd": ((3, 37, 53), (33, 47), (10, 15), (10, 40)),
    "small": ((4, 24, 40), (20, 35), (8, 12), (8, 48)),
    "one-tile-row": ((3, 37, 53), (33, 47), (37, 15), (37, 40)),
    "one-tile-column": ((4, 24, 40), (20, 35), (6, 40), (6, 160)),
}
PASSES = (0, 2, 6, 7)


def case(shape, hw0, seed=0):
    """An image of noise inside rows 1..h0 and columns 1..w0, zero outside,
    and its interior mask (run.py main's kind of image)."""
    (c, h, w), (h0, w0) = shape, hw0
    interior = np.zeros((h, w), np.float32)
    interior[1:1 + h0, 1:1 + w0] = 1
    return np.random.default_rng(seed).random((c, h, w)).astype(np.float32) * interior, interior


def _stage(spec, lo, mid, hi):
    """One stage, `lo` summed first, in the variant's order and type."""
    if spec.bf16_arith:
        quarter, half = torch.tensor(0.25, dtype=BF16), torch.tensor(0.5, dtype=BF16)
        return quarter * (lo + hi) + half * mid
    if spec.folded:
        return 0.25 * (lo + hi) + 0.5 * mid
    return lo + 2.0 * mid + hi


def _finish(spec, acc, edge):
    """A pass's last step: the 1/16 and the mask, or the ring set to zero."""
    if spec.bf16_arith:
        return torch.where(edge, torch.zeros((), dtype=BF16), acc)
    if not spec.folded:
        acc = acc * (1.0 / 16.0)
    if spec.ring:
        return torch.where(edge, torch.zeros((), dtype=spec.state), acc.to(spec.state))
    return (acc * edge).to(spec.state)


def model(variant, n, img, interior, hw0, c, tile, k):
    """The kernel's scheme at `tile` and depth k on the image in its layout
    ((C, h, w), or (h, w*C) for v2): returns (out, exchanges made, the
    exchange's row and column words)."""
    spec = bro.SPECS[variant]
    x = img.to(spec.state)
    if spec.rank2:
        x, hw = x[None], c
    else:
        hw = 1
    planes, h, w = x.shape
    th, tw = tile
    nty, ntx = -(-h // th), -(-w // tw)
    khw = k * hw
    assert k <= h - (nty - 1) * th and khw <= w - (ntx - 1) * tw, "a halo of one tile"
    edge = bro.ring_mask(h, w, *hw0)[0] if spec.ring else interior.float()
    tiles = {(ty, tx): (ty * th, tx * tw, min(th, h - ty * th), min(tw, w - tx * tw))
             for ty in range(nty) for tx in range(ntx)}

    def around(r0, c0, eh, ew, kr, kc):
        return (torch.arange(r0 - kr, r0 + eh + kr) % h, torch.arange(c0 - kc, c0 + ew + kc) % w)

    local, edges = {}, {}
    for t, (r0, c0, eh, ew) in tiles.items():
        rr, cc = around(r0, c0, eh, ew, k, khw)
        local[t] = x[:, rr][:, :, cc].clone()
        rr, cc = around(r0, c0, eh, ew, k - 1, khw - hw)  # every cell a pass computes
        edges[t] = edge[rr][:, cc]
    # xrow[parity][plane][tile row][first k rows, last k][k][w], xcol
    # [parity][plane][tile column][first k hw columns, last][k hw][h]
    xrow = torch.zeros((2, planes, nty, 2, k, w), dtype=spec.state)
    xcol = torch.zeros((2, planes, ntx, 2, khw, h), dtype=spec.state)
    passes, done, made = 2 * (int(n) // 2), 0, 0
    while done < passes:
        g = min(k, passes - done)
        for d in range(g - 1, -1, -1):  # rows -d .. eh+d-1, columns -d hw .. ew+d hw-1
            for t, (r0, c0, eh, ew) in tiles.items():
                cur = local[t]
                vals = cur if spec.bf16_arith else cur.float()
                cols = ew + 2 * d * hw
                wide = slice(khw - d * hw - hw, khw + ew + d * hw + hw)
                vert = _stage(spec, vals[:, k - d + 1:k + eh + d + 1, wide],
                              vals[:, k - d:k + eh + d, wide], vals[:, k - d - 1:k + eh + d - 1, wide])
                acc = _stage(spec, vert[..., 2 * hw:2 * hw + cols], vert[..., hw:hw + cols],
                             vert[..., :cols])
                rim = k - 1 - d
                nxt = cur.clone()
                nxt[:, k - d:k + eh + d, khw - d * hw:khw + ew + d * hw] = _finish(
                    spec, acc, edges[t][rim:rim + eh + 2 * d, rim * hw:rim * hw + cols])
                local[t] = nxt
        done += g
        if done == passes:
            break
        made += 1
        par = made % 2
        for (ty, tx), (r0, c0, eh, ew) in tiles.items():
            cur = local[(ty, tx)]
            xrow[par, :, ty, 0, :, c0:c0 + ew] = cur[:, k:2 * k, khw:khw + ew]
            xrow[par, :, ty, 1, :, c0:c0 + ew] = cur[:, eh:eh + k, khw:khw + ew]
            xcol[par, :, tx, 0, :, r0:r0 + eh] = cur[:, k:k + eh, khw:2 * khw].transpose(1, 2)
            xcol[par, :, tx, 1, :, r0:r0 + eh] = cur[:, k:k + eh, ew:ew + khw].transpose(1, 2)
        for (ty, tx), (r0, c0, eh, ew) in tiles.items():
            cur = local[(ty, tx)]
            cc = torch.arange(c0 - khw, c0 + ew + khw) % w
            cur[:, :k] = xrow[par, :, (ty - 1) % nty, 1][:, :, cc]
            cur[:, k + eh:] = xrow[par, :, (ty + 1) % nty, 0][:, :, cc]
            cur[:, k:k + eh, :khw] = xcol[par, :, (tx - 1) % ntx, 1, :, r0:r0 + eh].transpose(1, 2)
            cur[:, k:k + eh, khw + ew:] = xcol[par, :, (tx + 1) % ntx, 0, :,
                                               r0:r0 + eh].transpose(1, 2)
    out = torch.empty_like(x)
    for t, (r0, c0, eh, ew) in tiles.items():
        out[:, r0:r0 + eh, c0:c0 + ew] = local[t][:, k:k + eh, khw:khw + ew]
    out = out[0] if spec.rank2 else out
    return out.to(img.dtype), made, (xrow.numel(), xcol.numel())


def inputs(variant, name, dname):
    """(image, interior) of a case in the variant's layout and type, its
    interior box, channels and tile."""
    shape, hw0, tile, tile_rank2 = CASES[name]
    img, interior = case(shape, hw0)
    x = torch.from_numpy(img).to(DTYPES[dname])
    m = torch.from_numpy(interior).to(DTYPES[dname])
    if bro.SPECS[variant].rank2:
        return bro.to_rank2(x).contiguous(), bro.rank2_interior(m, shape[0]), hw0, shape[0], \
            tile_rank2
    return x, m, hw0, shape[0], tile


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("variant", bro.VARIANTS)
def test_the_scheme_is_bit_equal_to_the_plain_version(variant, dname, name, k):
    x, m, hw0, c, tile = inputs(variant, name, dname)
    runs = {}  # an odd n runs n - 1 passes in the model as in the kernel
    for n in PASSES:
        if 2 * (n // 2) not in runs:
            runs[2 * (n // 2)] = model(variant, n, x, m, hw0, c, tile, k)
        got, made, _ = runs[2 * (n // 2)]
        assert made == bro.exchanges(2 * (n // 2), k)
        ref = bro.plain(variant, n, x, m, hw0, c)
        assert torch.equal(got, ref), f"{variant} {name} {dname} k={k} n={n}"


@pytest.mark.parametrize("variant", bro.VARIANTS)
def test_a_remainder_group_and_many_exchanges(variant):
    """Twenty passes at depth 3: six exchanges and a last group of two."""
    x, m, hw0, c, tile = inputs(variant, "odd", "float32")
    got, made, _ = model(variant, 20, x, m, hw0, c, tile, 3)
    assert made == 6
    assert torch.equal(got, bro.plain(variant, 20, x, m, hw0, c))


@pytest.mark.parametrize("variant", bro.VARIANTS)
@pytest.mark.parametrize("name", list(CASES))
def test_exchange_words_are_the_kernels_layout(variant, name):
    """`exchange_words`, which sizes the buffers a launch gets, counts the
    words of the layout the model writes and reads."""
    x, m, hw0, c, tile = inputs(variant, name, "float32")
    shape = CASES[name][0]
    for k in (1, 2, 4):
        _, _, words = model(variant, 2, x, m, hw0, c, tile, k)
        assert bro.exchange_words(variant, *shape, tile, k) == words


def test_the_exchange_counts():
    assert [bro.exchanges(n, 4) for n in (0, 2, 4, 6, 8, 9, 202)] == [0, 0, 0, 1, 1, 2, 50]
    assert [bro.exchanges(n, 1) for n in (0, 1, 2, 7)] == [0, 0, 1, 6]


def test_two_launches_in_a_row_get_distinct_tags(monkeypatch):
    """The stale-word guard: a stream's words are kept and zeroed when made,
    and each launch's tags continue where the last one's stopped, so no word
    an earlier launch left carries a tag the next one waits for. A launch
    that needs more words gets new zeroed ones; a count that would pass 32
    bits zeroes the words and starts again."""
    monkeypatch.setattr(bro, "_EXCHANGE", {})
    xrow, xcol, tag0 = bro.exchange("cpu", 7, 100, 40, 5)
    assert tag0 == 0 and xrow.numel() == 100 and xcol.numel() == 40
    assert xrow.dtype == torch.int64 and not xrow.any() and not xcol.any()
    xrow.fill_((5 << 32) | 123)  # the words the launch wrote, tags 1..5
    xrow2, _, tag1 = bro.exchange("cpu", 7, 60, 30, 3)
    assert tag1 == 5 and xrow2.data_ptr() == xrow.data_ptr()  # the same words, later tags
    assert (xrow2 >> 32).max() <= tag1
    _, _, other = bro.exchange("cpu", 8, 60, 30, 3)  # another stream
    assert other == 0
    xrow3, _, tag2 = bro.exchange("cpu", 7, 500, 40, 2)  # more words: new, zeroed
    assert tag2 == 0 and not xrow3.any()
    monkeypatch.setattr(bro, "TAG_LIMIT", 10)
    xrow3.fill_(-1)
    _, _, tag3 = bro.exchange("cpu", 7, 500, 40, 8)  # 2 + 8 <= 10
    assert tag3 == 2
    _, _, tag4 = bro.exchange("cpu", 7, 500, 40, 1)  # 10 + 1 > 10: zeroed, from 0
    assert tag4 == 0 and not xrow3.any()


@pytest.mark.parametrize("variant", bro.VARIANTS)
@pytest.mark.parametrize("image", list(FIT_TABLE))
def test_the_depth_rule_at_132_sms(image, variant):
    """At every image and variant of the fit table: the tile is the one the
    tiling rule gave before the depth existed, the depth lies in 1..the
    tile's sides (and its last tiles'), and the block's bytes at that depth
    fit a block's shared memory. v5 at leaf, 1,280 B short of a second row,
    runs depth 1."""
    shape, hw0 = {"bricks": ((4, 304, 512), (302, 499)),
                  "leaf": ((4, 1032, 896), (1024, 768))}[image]
    want = FIT_TABLE[image][variant]
    tile = bro.tiling(variant, *shape, 132, 232_448)
    if want is None:
        assert tile is None
        return
    assert tile == want[0]
    k = bro.choose_depth(variant, *shape, tile, 232_448)
    th, tw = tile
    c, h, w = shape
    hw = bro.halo_cols(variant, c)
    width = w * c if bro.SPECS[variant].rank2 else w
    assert 1 <= k <= min(th, tw, h - (-(-h // th) - 1) * th)
    assert k * hw <= width - (-(-width // tw) - 1) * tw
    assert k <= bro.max_depth(variant, *shape, tile, 232_448)
    assert bro.resident_bytes(variant, tile, c, k) <= stencil.SMEM_PER_BLOCK
    call, _ = bro.build(variant, torch.zeros(shape, dtype=BF16), hw0)
    assert call.depth == k and call.block_bytes == bro.resident_bytes(variant, tile, c, k)
    if (image, variant) == ("leaf", "v5-ringzero"):
        assert k == 1 and bro.resident_bytes(variant, tile, c, 2) > 232_448


def test_bytes_at_depth():
    """Two state buffers of the tile and a k-deep halo, the mask over a halo
    one cell less deep; depth 1 is the tiling rule's count."""
    for variant in bro.VARIANTS:
        assert bro.resident_bytes(variant, (28, 171), 4, 1) == bro.resident_bytes(
            variant, (28, 171), 4)
    assert bro.resident_bytes("v0-roll", (28, 171), 4, 3) == 4 * (2 * 34 * 177 + 32 * 175)
    assert bro.resident_bytes("v2-rank2", (7, 683), 4, 2) == 4 * (2 * 11 * 699 + 9 * 691)
    assert bro.resident_bytes("v6-bf16-fold", (94, 299), 4, 4) == 2 * 2 * 102 * 307
    assert stencil.resident_smem_bytes(28, 171, 3) == bro.resident_bytes("v0-roll", (28, 171),
                                                                          1, 3)


def test_a_harness_may_name_a_depth_the_tile_takes():
    x = torch.zeros((3, 37, 53))
    call, _ = bro.build("v0-roll", x, (33, 47), depth=1)
    assert call.depth == 1
    deepest = bro.max_depth("v0-roll", 3, 37, 53, call.tile)
    assert bro.build("v0-roll", x, (33, 47), depth=deepest)[0].depth == deepest
    for bad in (0, deepest + 1):
        with pytest.raises(ValueError, match="depth"):
            bro.build("v0-roll", x, (33, 47), depth=bad)


def test_the_ab_harness_imports_no_jax_and_no_lbm_tpu():
    """experiments/cuda-kstep-tiles/ab_resident.py runs on the card's host,
    which has no JAX: it imports the port of each copy it times and the
    sweep harness, nothing of the JAX package."""
    import ast
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "experiments" / "cuda-kstep-tiles" / \
        "ab_resident.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    assert "lbm_tpu_torch.ops" in names
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "lbm_tpu")]
