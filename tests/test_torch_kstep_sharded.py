"""The port's ghost-band engine (lbm_tpu_torch.parallel.kstep_sharded) on
gloo ranks against `lbm_tpu.parallel.pallas_sharded` on the JAX package's 8
virtual CPU devices, the TPU kernel in interpret mode, as the JAX package's
own tests run it.

On the CPU the port's local kernels (B1 in place, B2 two-stream) run their
plain version, `d2q9_kstep.stepk_plain`, on the ghost-extended blocks, with
the same windows the card gets (row_offset, valid rows and columns,
global_ny). Every case runs `kstep_sharded.simulate` from a seeded float64
state in one group of 4 ranks (`parallel.launch.run_each`), and the JAX
path runs with x64 in float64: the state and av_vels agree to 1e-12
relative. On the ranks: a row mesh of 4 at K = 2 and 4, a (2, 2) mesh, and
uneven rows (pad-and-mask); B1 (inplace) equals B2 (two-stream) bit for bit;
the overlapped chunk equals the fused one bit for bit in state (row mesh,
(2, 2) with the 'row' scheme, and 'full2d'), its av_vels to 1e-12 (three or
five partial sums a chunk in place of one).
"""

import dataclasses

import jax
import numpy as np
import pytest

from lbm_tpu.core.params import Params as JParams
from lbm_tpu.parallel import pallas_sharded as jps
from lbm_tpu_torch.core.params import Params
from lbm_tpu_torch.parallel import kstep_sharded, launch

STEPS = 8
BAR = 1e-12
# (mesh shape, grid, K) held against the JAX package
JAX_CASES = (((4, 1), (64, 128), 2), ((4, 1), (64, 128), 4), ((2, 2), (32, 256), 4),
             ((4, 1), (60, 128), 4))
# (mesh shape, grid, scheme) of the overlapped chunk, against the fused one
OVERLAP_CASES = (((4, 1), (96, 128), "auto"), ((2, 2), (48, 256), "row"),
                 ((2, 2), (48, 768), "full2d"))


def params(ny, nx):
    return Params(nx=nx, ny=ny, max_iters=STEPS, reynolds_dim=10, density=0.1, accel=0.005,
                  omega=1.85)


def seeded_case(ny, nx, seed=23):
    rng = np.random.default_rng(seed)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None]
    f = 0.1 * w * (1.0 + 0.02 * rng.uniform(-1, 1, (9, ny, nx)))
    mask = np.zeros((ny, nx), bool)
    mask[0, :] = True
    mask[ny // 3:ny // 3 + 3, nx // 4:nx // 2] = True
    mask[ny // 2, :] = rng.uniform(size=nx) < 0.3
    return f, mask


def call(shape, grid, **kw):
    p = params(*grid)
    return (launch.on_mesh, (shape, kstep_sharded.simulate, p, *seeded_case(*grid)), kw)


@pytest.fixture(scope="module")
def results():
    todo = {}
    for shape, grid, k in JAX_CASES:
        for engine in ("inplace", "two-stream"):
            todo[("jax", shape, grid, k, engine)] = call(shape, grid, k_steps=k,
                                                         local_engine=engine)
    for shape, grid, scheme in OVERLAP_CASES:
        for overlap in (False, True):
            for engine in ("inplace", "two-stream"):
                todo[("overlap", shape, grid, scheme, overlap, engine)] = call(
                    shape, grid, k_steps=4, local_engine=engine, overlap=overlap,
                    scheme=scheme if overlap else "auto")
    got = launch.run_each(list(todo.values()), 4, timeout=240)
    return {k: (f.numpy(), av.numpy()) for k, (f, av) in zip(todo, got)}


def rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("shape,grid,k", JAX_CASES)
def test_matches_the_jax_ghost_band_engine(results, shape, grid, k):
    ny, nx = grid
    f0, mask = seeded_case(ny, nx)
    got_f, got_av = results[("jax", shape, grid, k, "inplace")]
    with jax.enable_x64(True):
        mesh = jps.make_mesh2d(*shape)
        want_f, want_av = jps.simulate(JParams(**dataclasses.asdict(params(ny, nx))), f0, mask,
                                       mesh, k_steps=k, band=8)
        want_f, want_av = np.asarray(want_f), np.asarray(want_av)
    assert got_f.shape == (9, ny, nx) and got_f.dtype == np.float64
    assert got_av.shape == (STEPS,)
    assert rel(got_f, want_f) <= BAR
    assert rel(got_av, want_av) <= BAR


@pytest.mark.parametrize("shape,grid,k", JAX_CASES)
def test_inplace_equals_two_stream(results, shape, grid, k):
    ip = results[("jax", shape, grid, k, "inplace")]
    ts = results[("jax", shape, grid, k, "two-stream")]
    np.testing.assert_array_equal(ip[0], ts[0])
    np.testing.assert_array_equal(ip[1], ts[1])


@pytest.mark.parametrize("engine", ["inplace", "two-stream"])
@pytest.mark.parametrize("shape,grid,scheme", OVERLAP_CASES)
def test_overlap_equals_fused(results, shape, grid, scheme, engine):
    fused = results[("overlap", shape, grid, scheme, False, engine)]
    over = results[("overlap", shape, grid, scheme, True, engine)]
    np.testing.assert_array_equal(over[0], fused[0])
    assert rel(over[1], fused[1]) <= BAR
    # and both local kernels give the same overlapped state
    other = results[("overlap", shape, grid, scheme, True,
                     "two-stream" if engine == "inplace" else "inplace")]
    np.testing.assert_array_equal(over[0], other[0])


def test_overlap_refuses_thin_and_padded_blocks():
    kw = dict(k_steps=4, omega=1.85, accel_w1=1e-4, accel_w2=1e-5, accel_row=6)

    class Mesh:  # what the checks before any exchange read of a mesh
        def __init__(self, rows):
            self.shape = (rows, 1)

        def get_coordinate(self):
            return [0, 0]

    with pytest.raises(ValueError, match="rows per shard"):
        kstep_sharded.make_overlap_chunk_fn(Mesh(8), ny=128, **kw)  # h=16
    with pytest.raises(ValueError, match="evenly-sharded"):
        kstep_sharded.make_overlap_chunk_fn(Mesh(8), ny=232, **kw)  # 24 pad rows
    with pytest.raises(ValueError, match="k_steps"):
        kstep_sharded.make_chunk_fn(Mesh(2), ny=64, **{**kw, "k_steps": 9})


@pytest.mark.parametrize("ny,nx,tile,k,rows,cols", [
    (40, 64, (16, 32), 4, [*range(8), *range(32, 40)], []),           # a row mesh's bands
    (40, 96, (8, 32), 2, [*range(8), *range(24, 40)], [*range(16), *range(80, 96)]),
    (72, 130, (16, 32), 4, [0, 1, 71], [0, 129]),                      # edge tiles
    (1040, 1024, (16, 32), 4, [*range(8), *range(1032, 1040)], []),    # the flagship's block
])
def test_snapshot_patch_gives_a_fresh_snapshot(ny, nx, tile, k, rows, cols):
    """B1's chained passes on a ghost-extended block (`d2q9_kstep_inplace.
    Chain`) copy the rewritten ghost cells into the snapshot the next pass
    reads: it must equal a snapshot taken afresh, in the kernel's layout."""
    import torch

    from lbm_tpu_torch.ops import d2q9_kstep_inplace as ip

    g = torch.Generator().manual_seed(ny + nx)
    f = torch.rand(9, ny, nx, generator=g, dtype=torch.float64)
    snap = ip.snapshot_plain(f, tile, k)
    assert tuple(snap[0].shape) == (-(-ny // tile[0]), 9, 2 * k, nx)
    assert tuple(snap[1].shape) == (-(-nx // tile[1]), 9, ny, 2 * k)
    if rows:
        f[:, rows] = torch.rand(9, len(rows), nx, generator=g, dtype=torch.float64)
    if cols:
        f[:, :, cols] = torch.rand(9, ny, len(cols), generator=g, dtype=torch.float64)
    ip.SnapshotPatch(ny, nx, tile, k, rows, cols, f.device)(snap, f)
    for got, want in zip(snap, ip.snapshot_plain(f, tile, k)):
        assert torch.equal(got, want)
