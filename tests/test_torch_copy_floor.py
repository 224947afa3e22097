"""The copy floor of the port (lbm_tpu_torch.ops.copy_floor, kernel B12) on the
CPU, against the TPU kernel it replaces: `_copy_kernel` of
experiments/d2q9-blocked-floor/run.py, loaded from that file by its path and
run through `pl.pallas_call(..., interpret=True)` over the same (9, by, bx)
blocks, one call per pass. A copy changes no value: the results must be
bit-equal.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lbm_tpu_torch.ops import copy_floor

REPO = Path(__file__).resolve().parent.parent


def experiment_module():
    path = REPO / "experiments" / "d2q9-blocked-floor" / "run.py"
    spec = importlib.util.spec_from_file_location("d2q9_blocked_floor_run", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pallas_copy(f, n, by, bx):
    """n passes of the experiment's kernel, as its `run_copy` chains them."""
    kernel = experiment_module()._copy_kernel
    _, ny, nx = f.shape
    spec = pl.BlockSpec((9, by, bx), lambda i, j: (0, i, j))
    call = pl.pallas_call(kernel, grid=(ny // by, nx // bx), in_specs=[spec], out_specs=spec,
                          out_shape=jax.ShapeDtypeStruct(f.shape, f.dtype), interpret=True)
    for _ in range(n):
        f = call(f)
    return np.asarray(f)


@pytest.mark.parametrize("shape, by, bx, n", [
    ((9, 16, 128), 8, 128, 1),   # full-width bands
    ((9, 32, 64), 16, 32, 3),    # the K-step kernels' tile
])
def test_run_copy_plain_matches_the_tpu_kernel(shape, by, bx, n):
    f = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = pallas_copy(jnp.asarray(f), n, by, bx)
    got = copy_floor.run_copy(torch.from_numpy(f), n, by, bx)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, f)


def test_run_copy_on_the_cpu_is_the_plain_version_and_leaves_f():
    f = torch.from_numpy(np.random.default_rng(1).standard_normal((9, 12, 20)))
    before = copy_floor.launches
    out = copy_floor.run_copy(f, 2, 5, 7)  # blocks that do not divide the grid
    assert out is not f and torch.equal(out, f) and out.dtype == torch.float64
    assert torch.equal(copy_floor.run_copy_plain(f, 1, 5, 7), f)
    assert copy_floor.launches == before


@pytest.mark.parametrize("args, match", [
    (((9, 8), 1, 8, 8), "shape"),
    (((8, 8, 8), 1, 8, 8), "shape"),
    (((9, 8, 8), 0, 8, 8), "positive"),
    (((9, 8, 8), 1, 0, 8), "positive"),
])
def test_run_copy_refuses_bad_arguments(args, match):
    shape, n, by, bx = args
    with pytest.raises(ValueError, match=match):
        copy_floor.run_copy(torch.zeros(shape), n, by, bx)


# ------------------------------------------------------- the kernel's plan ----

@pytest.mark.parametrize("nx, bx, itemsize, aligned, path", [
    (1024, 32, 4, True, "tma"),      # the main path's tile
    (1000, 32, 4, True, "tma"),      # nx % 4 == 0: edge tiles, TMA clips them
    (1002, 32, 4, True, "scalar"),   # nx % 4 == 2: rows are not whole 16-byte pieces
    (1001, 32, 4, True, "scalar"),
    (1002, 32, 8, True, "tma"),      # float64 needs nx % 2 == 0 only
    (1001, 32, 8, True, "scalar"),
    (1024, 7, 4, True, "scalar"),    # tile rows are not whole 16-byte pieces
    (1024, 6, 8, True, "tma"),
    (1024, 32, 4, False, "scalar"),  # a buffer off 16 bytes
])
def test_choose_path_by_width_type_and_alignment(nx, bx, itemsize, aligned, path):
    assert copy_floor.choose_path(nx, bx, itemsize, aligned) == path


def offset_state(shape, offset, dtype=torch.float32):
    """A contiguous state `offset` values past the start of its storage."""
    n = shape[0] * shape[1] * shape[2]
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


# Blocks of a float32 TMA ring resident on an SM of an H100 (228 KB of shared
# memory, 1 KB of it kept a block), as the kernel's occupancy query,
# copy_floor.blocks_per_sm, reports them (ab_copy.py --probe prints them):
# {(chunk, stages): blocks}.
H100_BLOCKS = {
    ((9, 16, 32), 1): 11,
    ((9, 8, 128), 2): 3,
    ((9, 4, 128), 2): 6,
    ((9, 4, 256), 2): 3,
    ((9, 2, 256), 2): 6,
    ((9, 4, 256), 4): 1,
    ((9, 2, 256), 4): 3,
}


def h100(chunk, stages):
    return H100_BLOCKS[(chunk, stages)]


def test_plan_takes_tma_where_it_can_and_scalar_elsewhere():
    f = offset_state((9, 64, 1024), 0)
    assert copy_floor.plan(f, f, 16, 32, 132, h100) == ("tma", (9, 16, 32), 1)
    odd = offset_state((9, 64, 1001), 0)
    assert copy_floor.plan(odd, odd, 16, 32) == ("scalar", (0, 0, 0), 0)
    off = offset_state((9, 64, 1024), 1)  # 4 bytes off 16
    assert copy_floor.plan(off, f, 16, 32)[0] == "scalar"
    assert copy_floor.plan(f, off, 16, 32)[0] == "scalar"


@pytest.mark.parametrize("shape, offset, by, bx", [
    ((9, 64, 1002), 0, 16, 32),  # rows of 4,008 B
    ((9, 64, 1024), 0, 16, 30),  # tile rows of 120 B
    ((9, 64, 1024), 1, 16, 32),  # the state 4 bytes off 16
])
def test_plan_refuses_16_byte_paths_the_layout_does_not_allow(shape, offset, by, bx):
    """TMA is never planned where the layout does not allow it: no occupancy
    is asked for, the one-value path runs."""
    def no_query(chunk, stages):
        raise AssertionError("the scalar path needs no occupancy")
    f = offset_state(shape, offset)
    assert copy_floor.plan(f, torch.zeros(shape), by, bx, 132, no_query) == (
        "scalar", (0, 0, 0), 0)


@pytest.mark.parametrize("make, match", [
    (lambda: torch.zeros((9, 8, 8), dtype=torch.float16), "float32 or float64"),
    (lambda: torch.zeros((9, 8, 8), dtype=torch.int32), "float32 or float64"),
    (lambda: torch.zeros((9, 8, 16)).transpose(1, 2), "contiguous"),
])
def test_plan_refuses_what_the_kernel_cannot_take(make, match):
    f = make()
    with pytest.raises(ValueError, match=match):
        copy_floor.plan(f, torch.zeros((9, 8, 8)), 8, 8, 132, h100)


@pytest.mark.parametrize("by, bx, itemsize, chunk", [
    (16, 32, 4, (9, 16, 32)),    # the K-step tile: one box of 18,432 B
    (16, 32, 8, (9, 16, 32)),    # 36,864 B in float64
    (16, 64, 4, (9, 16, 64)),
    (32, 128, 4, (9, 8, 128)),   # 147,456 B: four boxes of 36,864
    (16, 1024, 4, (9, 4, 256)),  # a full-width band: boxes of 256 values a row
    (8, 12, 4, (9, 8, 12)),
    (16, 130, 8, (3, 8, 130)),
])
def test_chunk_of(by, bx, itemsize, chunk):
    assert copy_floor.chunk_of(by, bx, itemsize) == chunk


@pytest.mark.parametrize("limit", [copy_floor.MAX_CHUNK_BYTES, copy_floor.SMALL_CHUNK_BYTES])
@pytest.mark.parametrize("by", [1, 5, 16, 64, 300])
@pytest.mark.parametrize("bx", [4, 12, 32, 1000, 4096])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_chunks_divide_the_tile_and_fit_a_stage(by, bx, itemsize, limit):
    cq, cy, cx = copy_floor.chunk_of(by, bx, itemsize, limit)
    assert 9 % cq == 0 and by % cy == 0 and bx % cx == 0
    assert max(cy, cx) <= copy_floor.MAX_BOX and (cx * itemsize) % 16 == 0
    assert cq * cy * cx * itemsize <= limit


def test_stages_of():
    assert copy_floor.stages_of(16, 32, (9, 16, 32), 2048, 132) == 1  # one chunk a tile
    assert copy_floor.stages_of(32, 128, (9, 8, 128), 256, 132) == 2
    assert copy_floor.stages_of(64, 1024, (9, 4, 256), 16, 132) == 4  # few tiles: deep ring
    assert copy_floor.stages_of(16, 256, (9, 8, 256), 4, 132) == 2    # no more than the chunks


@pytest.mark.parametrize("n, by, bx, itemsize, ring", [
    (1024, 16, 32, 4, ((9, 16, 32), 1)),       # the main path: one chunk, 11 blocks an SM
    (4096, 32, 128, 4, ((9, 8, 128), 2)),      # 11 waves either way: the large chunks
    (1024, 32, 128, 4, ((9, 8, 128), 2)),      # 256 tiles, one wave of 3 blocks an SM
    (8192, 16, 8192, 4, ((9, 2, 256), 2)),     # 512 long tiles: one wave of small chunks,
    (4096, 16, 4096, 4, ((9, 4, 256), 2)),     # ... 256 fit one wave of large ones
    (1024, 64, 1024, 4, ((9, 4, 256), 4)),     # 16 tiles: a deep ring each
])
def test_ring_of_keeps_large_chunks_unless_small_ones_save_a_wave(n, by, bx, itemsize, ring):
    tiles = (n // by) * (n // bx)
    assert copy_floor.ring_of(by, bx, itemsize, tiles, 132, h100) == ring


def test_waves_count_the_blocks_that_shared_memory_leaves_an_sm():
    assert copy_floor.waves(2048, 132, h100((9, 16, 32), 1)) == 2  # 11 blocks an SM
    assert copy_floor.waves(512, 132, h100((9, 4, 256), 2)) == 2   # 3 an SM
    assert copy_floor.waves(512, 132, h100((9, 2, 256), 2)) == 1   # 6 an SM
    assert copy_floor.waves(132 * 6, 132, 6) == 1 and copy_floor.waves(132 * 6 + 1, 132, 6) == 2


def test_ring_of_asks_the_card_only_when_two_rings_compete():
    asked = []

    def occupancy(chunk, stages):
        asked.append((chunk, stages))
        return h100(chunk, stages)
    # a (9, 16, 32) float32 tile is one chunk of either size: nothing to compare
    assert copy_floor.ring_of(16, 32, 4, 2048, 132, occupancy) == ((9, 16, 32), 1)
    assert asked == []
    copy_floor.ring_of(16, 8192, 4, 512, 132, occupancy)
    assert asked == [((9, 4, 256), 2), ((9, 2, 256), 2)]
