"""The schedule of kernel B9 (`blur_k_kernel` in lbm_tpu_torch/csrc/stencil.cu)
as a model on the CPU, held bit for bit against `stencil.blur_k_plain` and
against the TPU kernel, `lbm_tpu.ops.stencil.blur_k_pallas`, in interpret mode.

The model takes its windows, grid and ring from `stencil.k_plan`,
`stencil.k_grid` and `stencil.choose_path`, as the kernel's launch does,
and runs what each block does:
  * the producer: each row of the band (k halo rows above and below,
    wrapped mod h) as the block's span of columns, in bulk pieces that wrap
    at the array's edge, each a whole number of 16-byte pieces at a 16-byte
    boundary on the vector path;
  * each warp's window of 32 V columns: the row pipeline, pass j a stage
    that turns the rows above, in the middle and below (registers that
    start at zero) into its row one behind, the edge columns of a lane from
    its neighbours by shuffles (lane 0 and lane 31 read their own), the mask
    row from the ring, and pass k's row stored by the lanes whose columns
    lie the halo from the window's edges, once the pipeline is full.
Every output element must be stored exactly once. float32 arithmetic in the
kernel's order, one rounding to the storage type at the store; every factor
is a power of two, so the result is bit-equal to the plain version and to
the TPU kernel in both types.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import stencil as ref
from lbm_tpu_torch.ops import stencil

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (C, h, w), band: 40 rows in bands of 16 (the last one short); 256 columns
# are whole 16-byte pieces in both types (vector path), 250 float32 and 252
# bfloat16 columns are not (thread path). No window step divides any width.
VECTOR_SHAPE = (4, 40, 256)
THREAD_SHAPE = {"float32": (4, 40, 250), "bfloat16": (4, 40, 252)}
BAND = 16


@functools.lru_cache(maxsize=None)
def ringed(shape, seed=11):
    """Noise everywhere, the ring included, and a mask with holes: only the
    periodic wrap gives the reference's answer."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, size=shape).astype(np.float32)
    mask = (rng.uniform(size=shape[1:]) < 0.9).astype(np.float32)
    return img, mask


def row_pieces(col0: int, span: int, w: int) -> list[tuple[int, int, int]]:
    """The producer's copies of one row's span: (offset in the span, first
    column, columns), the end of the row and then its start, as often as
    the span wraps."""
    pieces, done, pos = [], 0, col0 % w
    while done < span:
        n = min(span - done, w - pos)
        pieces.append((done, pos, n))
        done, pos = done + n, 0
    return pieces


def emulate(img: torch.Tensor, interior: torch.Tensor, k: int, band: int,
            windows: int = stencil.K_WINDOWS) -> torch.Tensor:
    """B9's output, block by block, as the kernel computes it."""
    c, h, w = img.shape
    itemsize = img.element_size()
    plan = stencil.k_plan(w, img.dtype, k)
    v, halo, step = plan.values, plan.halo, plan.step
    width = 32 * v
    (chunks, groups, bands), cpb, wpb = stencil.k_grid(c, h, w, img.dtype, k, band, windows)
    assert cpb * wpb <= stencil.K_MAX_WARPS or cpb == 1
    vector = stencil.choose_path(h, w, img.dtype, k) == "vector"
    x, m = img.float(), interior.float()
    out = torch.zeros((c, h, w), dtype=torch.float32)
    stores = torch.zeros((c, h, w), dtype=torch.int64)
    local = torch.arange(width)
    writes = (local >= halo) & (local < width - halo)  # whole lanes: halo is V-aligned
    assert halo % v == 0 and halo >= k and step % v == 0
    for chunk, g, b in ((i, j, l) for i in range(chunks) for j in range(groups)
                        for l in range(bands)):
        ch = torch.arange(chunk * cpb, min(c, chunk * cpb + cpb))  # the block's channels
        r0 = b * band
        rows = min(band, h - r0) + 2 * k
        grow = (r0 - k + torch.arange(rows)) % h
        win0 = g * wpb
        active = min(wpb, plan.windows - win0)
        span = (active - 1) * step + width
        col0 = win0 * step - halo
        # the producer's ring rows: the span of the mask and of each of the
        # block's channels in every row, piece by piece
        ring_x = torch.empty((len(ch), rows, span))
        ring_m = torch.empty((rows, span))
        for off, first, n in row_pieces(col0, span, w):
            if vector:
                assert (off * itemsize) % 16 == 0 and (first * itemsize) % 16 == 0
                assert (n * itemsize) % 16 == 0
            ring_x[:, :, off:off + n] = x[ch][:, grow][:, :, first:first + n]
            ring_m[:, off:off + n] = m[grow][:, first:first + n]
        cols = torch.stack([wi * step + local for wi in range(active)])  # (active, width)
        win_x, win_m = ring_x[:, :, cols], ring_m[:, cols]  # (channels, rows, active, width)
        regs = tuple([torch.zeros((len(ch), active, width)) for _ in range(k)] for _ in range(3))
        for t in range(rows):
            above, mid, below = regs
            below[0] = win_x[:, t]
            for j in range(k):
                rsum = (above[j] + 2.0 * mid[j]) + below[j]
                # a lane's edge columns come from lane - 1 and lane + 1;
                # lane 0 and lane 31 get their own values back
                left = torch.roll(rsum, 1, -1)
                left[..., 0] = rsum[..., v - 1]
                right = torch.roll(rsum, -1, -1)
                right[..., -1] = rsum[..., width - v]
                su = 0 if t <= j else t - j - 1
                o = (((right + 2.0 * rsum) + left) * 0.0625) * win_m[su]
                if j + 1 < k:
                    below[j + 1] = o
                elif t >= 2 * k:
                    row = r0 + t - 2 * k
                    for wi in range(active):
                        gcol = col0 + wi * step + local[writes]
                        keep = gcol < w
                        assert bool((gcol >= 0).all())
                        for i, chan in enumerate(ch.tolist()):
                            out[chan, row, gcol[keep]] = o[i, wi][writes][keep]
                            stores[chan, row, gcol[keep]] += 1
            regs = (mid, below, above)
    assert bool((stores == 1).all()), "an output element was stored twice or never"
    return out.to(img.dtype)


def case(shape, dname):
    img, mask = ringed(shape)
    dtype = DTYPES[dname][0]
    return torch.from_numpy(img).to(dtype), torch.from_numpy(mask).to(dtype)


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("path", ["vector", "thread"])
def test_schedule_equals_plain(k, dname, path):
    shape = VECTOR_SHAPE if path == "vector" else THREAD_SHAPE[dname]
    x, m = case(shape, dname)
    assert stencil.choose_path(*shape[1:], x.dtype, k) == path
    assert torch.equal(emulate(x, m, k, BAND), stencil.blur_k_plain(x, m, k_passes=k))


# the TPU kernel in interpret mode at every k in both types: float32 at one
# path's shape and bfloat16 at the other's, swapped between odd and even k
@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("dname", list(DTYPES))
def test_schedule_equals_the_tpu_kernel(k, dname):
    vector = (k % 2 == 1) == (dname == "float32")
    shape = VECTOR_SHAPE if vector else THREAD_SHAPE[dname]
    x, m = case(shape, dname)
    img, mask = ringed(shape)
    jdtype = DTYPES[dname][1]
    expected = ref.blur_k_pallas(jnp.asarray(img, jdtype), jnp.asarray(mask, jdtype),
                                 k_passes=k, interpret=True)
    got = emulate(x, m, k, BAND)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(expected, np.float32))


@pytest.mark.parametrize("shape,band,windows", [
    ((4, 40, 256), 7, 1), ((4, 40, 256), 40, 2), ((4, 40, 256), 64, 8), ((5, 40, 256), 16, 2),
    ((3, 40, 256), 16, 3)])
def test_the_tiling_does_not_change_the_result(shape, band, windows):
    """Bands of 7 rows (six of them, the last short), one band as tall as
    the image, one taller; one window a channel in a block, or more than
    the row has (then one channel a block); five channels in blocks of four
    (the last block one), three in blocks of two windows and two channels."""
    x, m = case(shape, "float32")
    assert torch.equal(emulate(x, m, 3, band, windows), stencil.blur_k_plain(x, m, k_passes=3))


def test_a_span_wider_than_the_row_wraps_more_than_once():
    """128 float32 columns: two windows whose span of 248 columns holds the
    row almost twice, in three pieces."""
    shape = (2, 24, 128)
    x, m = case(shape, "float32")
    plan = stencil.k_plan(128, torch.float32, 2)
    assert plan.windows == 2
    span = stencil.k_span(plan, 2)
    assert len(row_pieces(-plan.halo, span, 128)) == 3
    assert torch.equal(emulate(x, m, 2, 8), stencil.blur_k_plain(x, m, k_passes=2))


@pytest.mark.parametrize("dname,k,values,halo,step", [
    ("float32", 1, 4, 4, 120), ("float32", 4, 4, 4, 120), ("float32", 5, 4, 8, 112),
    ("float32", 8, 4, 8, 112), ("bfloat16", 1, 8, 8, 240), ("bfloat16", 4, 8, 8, 240),
    ("bfloat16", 5, 4, 8, 112), ("bfloat16", 8, 4, 8, 112)])
def test_windows(dname, k, values, halo, step):
    """A lane owns one 16-byte vector (bfloat16 beyond k = 4: 8 bytes); the
    halo is k rounded up to 16 bytes, so windows start on 16 bytes."""
    dtype = DTYPES[dname][0]
    plan = stencil.k_plan(4224, dtype, k)
    assert (plan.values, plan.halo, plan.step) == (values, halo, step)
    assert plan.windows == math.ceil(4224 / step)
    assert plan.ring_rows == k + 1 + stencil.K_RING_LEAD
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert (plan.halo * itemsize) % 16 == 0 and (plan.step * itemsize) % 16 == 0


def test_grid_of_the_main_path():
    """4x4128x4224 float32 at k = 4: 36 windows of 120 columns, 65 bands of
    64 rows (the last 32); one window (K_WINDOWS) and all four channels a
    block, or two windows and all four (eight consumer warps)."""
    assert stencil.k_grid(4, 4128, 4224, torch.float32, 4, 64) == ((1, 36, 65), 4, 1)
    assert stencil.k_grid(4, 4128, 4224, torch.float32, 4, 64, 2) == ((1, 18, 65), 4, 2)
    # fewer windows than asked: the block takes as many as the row has
    assert stencil.k_grid(4, 40, 128, torch.float32, 4, 16, 4) == ((1, 1, 3), 4, 2)
    # eight windows a channel leave room for one channel a block; three for two
    assert stencil.k_grid(4, 4128, 4224, torch.float32, 4, 64, 8) == ((4, 5, 65), 1, 8)
    assert stencil.k_grid(4, 4128, 4224, torch.bfloat16, 4, 64, 3) == ((2, 6, 65), 2, 3)


@pytest.mark.parametrize("w,dname,aligned,path", [
    (4224, "float32", True, "vector"), (4224, "bfloat16", True, "vector"),
    (256, "bfloat16", True, "vector"), (252, "float32", True, "vector"),
    (250, "float32", True, "thread"), (252, "bfloat16", True, "thread"),
    (4224, "float32", False, "thread"), (1001, "bfloat16", True, "thread")])
def test_choose_path(w, dname, aligned, path):
    for k in (1, 4, 8):
        assert stencil.choose_path(40, w, DTYPES[dname][0], k, aligned) == path


def test_every_main_path_shape_is_on_the_vector_path():
    """pad_to_tile makes widths multiples of 128."""
    from lbm_tpu_torch.utils import image

    for w in (5, 499, 4096):
        _, interior, _ = image.pad_to_tile(np.zeros((4, 30, w), np.float32), row_mult=32)
        for dtype in (torch.float32, torch.bfloat16):
            assert stencil.choose_path(*interior.shape, dtype, 4) == "vector"


@pytest.mark.parametrize("channels,windows,k,dname,expected", [
    (4, 2, 4, "float32", 9 * (2 * 8 + 5 * (120 + 128) * 4)),
    (4, 2, 4, "bfloat16", 9 * (2 * 8 + 5 * (240 + 256) * 2)),
    (4, 2, 8, "bfloat16", 13 * (2 * 8 + 5 * (112 + 128) * 2)),
    (4, 1, 8, "float32", 13 * (2 * 8 + 5 * 128 * 4)),
    (1, 1, 1, "float32", 6 * (2 * 8 + 2 * 128 * 4)),
    (1, 8, 8, "float32", 13 * (2 * 8 + 2 * (7 * 112 + 128) * 4))])
def test_smem_bytes(channels, windows, k, dname, expected):
    """The ring's rows (k + 1 + K_RING_LEAD), each with two barriers and the
    block's span of the mask row and of each channel's image row."""
    got = stencil.blur_k_smem_bytes(channels, windows, k, DTYPES[dname][0])
    assert got == expected
    assert got <= stencil.SMEM_PER_BLOCK
