"""The port's host-side planners and A10 functions against the JAX package's,
on the CPU, with no process group.

* `core.state.average_velocity` and `ops.d2q9.collide` against
  `lbm_tpu.core.state.average_velocity` and `lbm_tpu.ops.d2q9.collide` on
  the same seeded inputs: float64 within 1e-12 relative, float32 within 1e-6
  (the same operations in the same grouping; XLA may contract or reorder
  the last digits, and Sum|u| is reduced in another order).
* `parallel.mesh` (best_factorisation, shard_padding, pad_grid),
  `parallel.kstep_sharded` (plan_rows, extended_mask) and
  `parallel.partition` (every planner, stats, and the JSON text) equal the
  JAX package's exactly, errors included, at 128^2, 1,024^2, 64x1,001 and
  1,000x777 over 1-8 devices.
* The refusals of the ghost-band engine that need no ranks: K > 8, and
  scheme='full2d' without overlap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.core import state as jstate
from lbm_tpu.core.params import Params as JParams
from lbm_tpu.ops import d2q9 as jd2q9
from lbm_tpu.parallel import mesh as jmesh, pallas_sharded as jpallas_sharded
from lbm_tpu.parallel import partition as jpartition
from lbm_tpu_torch.core import state
from lbm_tpu_torch.core.params import Params
from lbm_tpu_torch.ops import d2q9
from lbm_tpu_torch.parallel import kstep_sharded, mesh, partition

GRIDS = [(128, 128), (1024, 1024), (64, 1001), (1000, 777)]
DEVICES = range(1, 9)
BARS = {np.float64: 1e-12, np.float32: 1e-6}


def seeded_state(dtype, ny=24, nx=40, seed=5):
    rng = np.random.default_rng(seed)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None]
    f = (0.1 * w * (1.0 + 0.2 * rng.uniform(-1, 1, (9, ny, nx)))).astype(dtype)
    mask = rng.uniform(size=(ny, nx)) < 0.1
    mask[0, :] = True
    return f, mask


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_average_velocity_matches_jax(dtype):
    f, mask = seeded_state(dtype)
    got = state.average_velocity(f, mask)
    want = jstate.average_velocity(f, mask)
    assert abs(got - want) <= BARS[dtype] * abs(want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("accel", [True, False])
def test_collide_matches_jax(dtype, accel):
    f, mask = seeded_state(dtype)
    ny, nx = mask.shape
    kw = dict(omega=1.85, accel_w1=0.1 * 0.005 / 9, accel_w2=0.1 * 0.005 / 36)
    amask = d2q9.accel_row_mask(ny, nx, ny - 2, dtype=torch.from_numpy(f).dtype) if accel else None
    f_new, tot = d2q9.collide(d2q9.stream_pull(torch.from_numpy(f)), torch.from_numpy(mask),
                              amask, **kw)
    with jax.enable_x64(dtype == np.float64):
        jamask = jd2q9.accel_row_mask(ny, nx, ny - 2, dtype=jnp.dtype(dtype)) if accel else None
        jf, jtot = jd2q9.collide(jd2q9.stream_pull(jnp.asarray(f)), jnp.asarray(mask), jamask,
                                 **kw)
        jf, jtot = np.asarray(jf), float(jtot)
    assert f_new.dtype == torch.from_numpy(f).dtype and f_new.shape == (9, ny, nx)
    assert rel(f_new.numpy(), jf) <= BARS[dtype]
    assert abs(float(tot) - jtot) <= BARS[dtype] * abs(jtot)
    # collide is collide_fields with the plane summed
    f2, u = d2q9.collide_fields(d2q9.stream_pull(torch.from_numpy(f)), torch.from_numpy(mask),
                                amask, **kw)
    assert torch.equal(f2, f_new) and torch.equal(u.sum(), tot)


def outcome(fn, *args, **kwargs):
    """fn's result, or ('raises', its message)."""
    try:
        return fn(*args, **kwargs)
    except ValueError as err:
        return ("raises", str(err))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("flags", [dict(), dict(require_even=False),
                                   dict(require_even=False, for_padding=True)])
def test_best_factorisation_and_shard_padding_match_jax(grid, flags):
    ny, nx = grid
    for n in DEVICES:
        got = outcome(mesh.best_factorisation, n, ny, nx, **flags)
        assert got == outcome(jmesh.best_factorisation, n, ny, nx, **flags), n
        if got[0] != "raises":
            assert outcome(mesh.shard_padding, ny, nx, *got) == \
                outcome(jmesh.shard_padding, ny, nx, *got)


@pytest.mark.parametrize("grid,pads", [((37, 52), (1, 0)), ((36, 54), (0, 2)),
                                       ((37, 54), (3, 2)), ((64, 1001), (0, 7))])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pad_grid_matches_jax(grid, pads, dtype):
    ny, nx = grid
    p = Params(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    f, mask = seeded_state(dtype, ny, nx)
    got = mesh.pad_grid(p, f, mask, *pads)
    want = jmesh.pad_grid(JParams(**dataclasses.asdict(p)), f, mask, *pads)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("grid", GRIDS + [(60, 64), (232, 64)])
def test_plan_rows_matches_jax(grid):
    ny, _ = grid
    for n in DEVICES:
        assert outcome(kstep_sharded.plan_rows, ny, n) == \
            outcome(jpallas_sharded.plan_rows, ny, n), n


@pytest.mark.parametrize("grid,shapes", [
    ((128, 128), [(1, 1), (4, 1), (8, 1)]),
    ((60, 256), [(4, 1), (2, 2), (3, 2)]),
    ((64, 1001), [(1, 1), (2, 1), (1, 7)]),
    ((1000, 777), [(5, 1), (8, 1)]),
    ((32, 512), [(2, 4), (1, 4), (2, 3)]),
])
def test_extended_mask_matches_jax(grid, shapes):
    ny, nx = grid
    rng = np.random.default_rng(ny * nx)
    mask = rng.uniform(size=grid) < 0.2
    for r, c in shapes:
        got = outcome(kstep_sharded.extended_mask, mask, r, c)
        want = outcome(jpallas_sharded.extended_mask, mask, r, c)
        if isinstance(want, tuple):
            assert got == want
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want), (r, c)


def test_ghost_widths_and_overlap_scheme_match_jax():
    assert (kstep_sharded.GHOST, kstep_sharded.GHOST_COLS) == \
        (jpallas_sharded.GHOST, jpallas_sharded.GHOST_COLS)
    for args in [(1, 4096), (4, 1024), (4, 1024, "row"), (2, 384, "full2d"),
                 (1, 4096, "full2d"), (4, 256, "full2d"), (4, 1024, "bogus")]:
        assert outcome(kstep_sharded.overlap_scheme, *args) == \
            outcome(jpallas_sharded.overlap_scheme, *args), args


@pytest.mark.parametrize("grid", GRIDS + [(20, 140)])
def test_partitions_and_json_match_jax(grid, tmp_path):
    ny, nx = grid
    for n in DEVICES:
        part = partition.partition_for_devices(ny, nx, n)
        jpart = jpartition.partition_for_devices(ny, nx, n)
        text = partition.serialize_to_json(part, tmp_path / "port.json")
        assert text == jpartition.serialize_to_json(jpart, tmp_path / "jax.json")
        assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
        assert partition.stats(part).as_dict() == jpartition.stats(jpart).as_dict()
        for band in (8, 64):
            assert partition.serialize_to_json(partition.to_band_partitions(part, band)) == \
                jpartition.serialize_to_json(jpartition.to_band_partitions(jpart, band))
        for blocks in (1, 4, 6):
            for strategy in ("auto", "rows", "cols", "grid", "single"):
                assert partition.serialize_to_json(partition.to_block_partitions(
                    part, blocks, strategy=strategy)) == jpartition.serialize_to_json(
                        jpartition.to_block_partitions(jpart, blocks, strategy=strategy))
        assert partition.serialize_to_json(partition.fixed_overlay_partitions(part, 38, 32)) == \
            jpartition.serialize_to_json(jpartition.fixed_overlay_partitions(jpart, 38, 32))
        for sl in part.values():
            assert partition.dispatch_strategy(sl, 6) == jpartition.dispatch_strategy(
                jpartition.Slice2D(sl.row_start, sl.row_end, sl.col_start, sl.col_end), 6)


def test_ghost_band_refusals_need_no_ranks():
    kw = dict(omega=1.85, accel_w1=1e-4, accel_w2=1e-5, accel_row=6, ny=64)
    with pytest.raises(ValueError, match="k_steps"):
        kstep_sharded.make_chunk_fn(None, k_steps=9, **kw)
    with pytest.raises(ValueError, match="k_steps"):
        kstep_sharded.make_overlap_chunk_fn(None, k_steps=9, **kw)
    with pytest.raises(ValueError, match="full2d"):
        kstep_sharded.run(None, None, mesh=None, num_steps=8, k_steps=4, scheme="full2d", **kw)
    with pytest.raises(ValueError, match="multiple of k_steps"):
        kstep_sharded.run(None, None, mesh=None, num_steps=6, k_steps=4, **kw)
    with pytest.raises(ValueError, match="local_engine"):
        kstep_sharded._local_stepk("bogus")
