"""The port's 3-D ghost-plane engines (lbm_tpu_torch.parallel.kstep_sharded_3d)
on gloo ranks against `lbm_tpu.parallel.pallas_sharded_3d` on the JAX
package's 8 virtual CPU devices, its TPU kernels in interpret mode, as the JAX
package's own tests run them (tests/test_d3q19.py:107-160).

On the CPU the port's local kernels (B4 in place, B6 two-stream) run their
plain version, `d3q19_kstep.stepk_plain`, on the ghost-extended blocks, with
the windows the card gets (plane_offset < 0 on shard 0, valid planes and
rows, global_nz). The runs go in one group of ranks per world size (2, 4 and
6; `parallel.launch.run_each`).

* `plan_planes`, `extended_mask`, `plan_rows_y` and `extended_mask_zy` equal
  the JAX functions' bit for bit over a sweep of shapes, refusals included.
* float32 'sharded-cuda' (z-mesh of 2 and 4 at K = 2, and nz = 22 on 4 at
  K = 3, pad-and-mask) against `pallas_sharded_3d.simulate`: the state at
  rtol 2e-5 / atol 1e-7 and av_vels at 2e-5, the reference's own bars. The
  accelerated plane (nz - 2) lies within K planes of a shard's edge.
* The overlapped chunk at 6n planes equals the fused one bit for bit in state
  (av_vels to 1e-6 in float32: three partial sums a step), B4 == B6.
* float32 'sharded-cuda-zy' on (2, 2) at 16x32 and (2, 3) at 22x40 (uneven on
  both axes) against `simulate_zy`: av_vels at 5e-5 (the reference's bar),
  the state at 2e-5 / 1e-7. The reference holds its state to its own
  single-device run bit for bit; XLA's CPU code rounds differently from the
  port's in the last bit, so the port's state is held bit for bit to the
  port's own single-device engine, B4's plain version.
* float64 runs of every case against `lbm_tpu.ops.d3q19.simulate` (engine
  'jax') in float64, to 1e-12 relative (the 3-D Pallas kernels do not run in
  float64).
* The local kernel is decided before any launch: 'inplace' names B4, or B5
  where the rule names the blocked kind, never B6.
"""

import jax
import numpy as np
import pytest
import torch

from lbm_tpu.ops import d3q19 as jd3q19
from lbm_tpu.parallel import pallas_sharded_3d as jps3
from lbm_tpu_torch.ops import d3q19, d3q19_kstep, d3q19_kstep_inplace
from lbm_tpu_torch.parallel import kstep_sharded_3d as ks3
from lbm_tpu_torch.parallel import launch

NX = 128
BAR64 = 1e-12
F32_STATE = dict(rtol=2e-5, atol=1e-7)
# (shards, nz, ny, K, steps) of the z-mesh, against pallas_sharded_3d.simulate
Z_CASES = ((2, 16, 16, 2, 8), (4, 16, 16, 2, 8), (4, 22, 16, 3, 6))
# (shards, nz) of the overlap (6 planes a shard at K = 2, the least it takes)
OVERLAP_CASES = ((2, 12), (4, 24))
# (mesh shape, nz, ny) of the (z, y) mesh, K = 2, 4 steps
ZY_CASES = (((2, 2), 16, 32), ((2, 3), 22, 40))
ZY_STEPS = 4


def z_call(nz, ny, steps, k, dtype, **kw):
    return (ks3.simulate, (nz, ny, NX), dict(num_steps=steps, k_steps=k, dtype=dtype, **kw))


def zy_call(shape, nz, ny, dtype, **kw):
    return (launch.on_mesh, (shape, ks3.simulate_zy, nz, ny, NX),
            dict(num_steps=ZY_STEPS, k_steps=2, dtype=dtype, **kw))


@pytest.fixture(scope="module")
def results():
    by_world = {}
    for n, nz, ny, k, steps in Z_CASES:
        for dtype in (torch.float32, torch.float64):
            by_world.setdefault(n, {})[("z", n, nz, k, dtype)] = z_call(nz, ny, steps, k, dtype)
        by_world[n][("z", n, nz, k, "two-stream")] = z_call(nz, ny, steps, k, torch.float32,
                                                            local_engine="two-stream")
    for n, nz in OVERLAP_CASES:
        for overlap in (False, True):
            for engine in ks3.LOCAL_ENGINES:
                by_world.setdefault(n, {})[("overlap", n, overlap, engine)] = z_call(
                    nz, 16, 8, 2, torch.float32, overlap=overlap, local_engine=engine)
        by_world[n][("overlap", n, True, torch.float64)] = z_call(nz, 16, 8, 2, torch.float64,
                                                                  overlap=True)
    for shape, nz, ny in ZY_CASES:
        n = shape[0] * shape[1]
        for dtype in (torch.float32, torch.float64):
            by_world.setdefault(n, {})[("zy", shape, dtype)] = zy_call(shape, nz, ny, dtype)
        by_world[n][("zy", shape, "two-stream")] = zy_call(shape, nz, ny, torch.float32,
                                                           local_engine="two-stream")
    out = {}
    for n, todo in by_world.items():
        got = launch.run_each(list(todo.values()), n, timeout=300)
        out.update({key: (f.numpy(), av.numpy()) for key, (f, av) in zip(todo, got)})
    return out


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def plain(nz, ny, steps, dtype):
    """The port's single-device in-place engine (B4's plain version)."""
    f, av = d3q19.simulate(nz, ny, NX, num_steps=steps, engine="cuda-inplace", dtype=dtype,
                           device="cpu")
    return f.numpy(), av.numpy()


def jax_f64(nz, ny, steps):
    with jax.enable_x64(True):
        f, av = jd3q19.simulate(nz, ny, NX, num_steps=steps, dtype=np.float64)
        return np.asarray(f), np.asarray(av)


def hold_f32(got, want, av_rtol):
    np.testing.assert_allclose(got[0], want[0], **F32_STATE)
    np.testing.assert_allclose(got[1], want[1], rtol=av_rtol)


def hold_f64(got, nz, ny, steps):
    f, av = jax_f64(nz, ny, steps)
    assert got[0].dtype == np.float64 and got[0].shape == (19, nz, ny, NX)
    assert rel(got[0], f) <= BAR64 and rel(got[1], av) <= BAR64


@pytest.mark.parametrize("n,nz,ny,k,steps", Z_CASES)
def test_z_mesh_matches_the_jax_ghost_plane_engine(results, n, nz, ny, k, steps):
    got = results[("z", n, nz, k, torch.float32)]
    assert got[0].shape == (19, nz, ny, NX) and got[1].shape == (steps,)
    want = jps3.simulate(nz, ny, NX, num_steps=steps, mesh=jps3.make_z_mesh(n), k_steps=k)
    hold_f32(got, (np.asarray(want[0]), np.asarray(want[1])), 2e-5)
    # B4 == B6 on the blocks, and both == the single-device engine's state
    np.testing.assert_array_equal(results[("z", n, nz, k, "two-stream")][0], got[0])
    np.testing.assert_array_equal(got[0], plain(nz, ny, steps, torch.float32)[0])


@pytest.mark.parametrize("n,nz,ny,k,steps", Z_CASES)
def test_z_mesh_float64_matches_jax(results, n, nz, ny, k, steps):
    hold_f64(results[("z", n, nz, k, torch.float64)], nz, ny, steps)


@pytest.mark.parametrize("n,nz", OVERLAP_CASES)
@pytest.mark.parametrize("engine", ks3.LOCAL_ENGINES)
def test_overlap_equals_fused(results, n, nz, engine):
    fused = results[("overlap", n, False, engine)]
    over = results[("overlap", n, True, engine)]
    np.testing.assert_array_equal(over[0], fused[0])
    assert rel(over[1], fused[1]) <= 1e-6
    other = results[("overlap", n, True, "two-stream" if engine == "inplace" else "inplace")]
    np.testing.assert_array_equal(over[0], other[0])


@pytest.mark.parametrize("n,nz", OVERLAP_CASES)
def test_overlap_float64_matches_jax(results, n, nz):
    hold_f64(results[("overlap", n, True, torch.float64)], nz, 16, 8)


@pytest.mark.parametrize("shape,nz,ny", ZY_CASES)
def test_zy_mesh_matches_the_jax_zy_engine(results, shape, nz, ny):
    got = results[("zy", shape, torch.float32)]
    assert got[0].shape == (19, nz, ny, NX) and got[1].shape == (ZY_STEPS,)
    want = jps3.simulate_zy(nz, ny, NX, num_steps=ZY_STEPS, mesh=jps3.make_zy_mesh(*shape),
                            k_steps=2)
    hold_f32(got, (np.asarray(want[0]), np.asarray(want[1])), 5e-5)
    np.testing.assert_array_equal(got[0], plain(nz, ny, ZY_STEPS, torch.float32)[0])
    np.testing.assert_array_equal(results[("zy", shape, "two-stream")][0], got[0])


@pytest.mark.parametrize("shape,nz,ny", ZY_CASES)
def test_zy_mesh_float64_matches_jax(results, shape, nz, ny):
    hold_f64(results[("zy", shape, torch.float64)], nz, ny, ZY_STEPS)


PLAN_SHAPES = [(nz, n, g) for nz in (1, 2, 5, 7, 8, 16, 22, 23, 64) for n in (1, 2, 3, 4, 8)
               for g in (1, 2, 3, 4)]


def outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as err:
        return ("ValueError", str(err))


@pytest.mark.parametrize("nz", sorted({s[0] for s in PLAN_SHAPES}))
def test_plan_planes_equals_the_reference(nz):
    for _, n, g in (s for s in PLAN_SHAPES if s[0] == nz):
        assert outcome(ks3.plan_planes, nz, n, g) == outcome(jps3.plan_planes, nz, n, g)


@pytest.mark.parametrize("ny", [1, 7, 8, 9, 16, 22, 40, 41, 64, 100])
def test_plan_rows_y_equals_the_reference(ny):
    for n in (1, 2, 3, 4, 5, 8):
        assert outcome(ks3.plan_rows_y, ny, n) == outcome(jps3.plan_rows_y, ny, n)


def random_mask(nz, ny, nx, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(nz, ny, nx)) < 0.3


@pytest.mark.parametrize("nz,n,g", [(16, 2, 2), (16, 4, 2), (22, 4, 3), (22, 2, 3), (7, 3, 2),
                                    (9, 2, 4), (8, 1, 1), (24, 8, 3)])
def test_extended_mask_equals_the_reference(nz, n, g):
    mask = random_mask(nz, 5, 8, nz * n * g)
    got = outcome(ks3.extended_mask, mask, n, g)
    want = outcome(jps3.extended_mask, mask, n, g)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nz,ny,n_z,n_y,g", [(16, 32, 2, 2, 2), (22, 40, 2, 3, 2),
                                             (10, 16, 2, 2, 2), (9, 17, 3, 2, 3),
                                             (16, 30, 1, 4, 4), (8, 8, 2, 2, 2)])
def test_extended_mask_zy_equals_the_reference(nz, ny, n_z, n_y, g):
    mask = random_mask(nz, ny, 4, nz + ny)
    got = outcome(ks3.extended_mask_zy, mask, n_z, n_y, g)
    want = outcome(jps3.extended_mask_zy, mask, n_z, n_y, g)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_choose_k_takes_the_preferred_k_the_plan_admits():
    # 64 planes on 1, 2 or 4 shards: K = 4 (d3q19_kstep.PREFERRED_K)
    for n in (1, 2, 4):
        assert ks3.choose_k(64, n, 1200) == d3q19_kstep.PREFERRED_K
    # 7 planes on 2 shards: K = 4 leaves the last shard < 4 planes; K = 3 too
    assert ks3.choose_k(7, 2, 1200) == 2
    # 24 planes on 4 shards at K = 4 leave the last none
    assert ks3.choose_k(24, 4, 8) == 2
    # the overlap needs an even split of >= 3K planes: 32 planes on 4 -> K = 2
    assert ks3.choose_k(32, 4, 8) == 4
    assert ks3.choose_k(32, 4, 8, overlap=True) == 2
    # the counts still rule: 6 steps
    assert ks3.choose_k(64, 1, 6) == d3q19_kstep.choose_k(6)
    # nothing admitted: 1, and the run raises plan_planes' refusal
    assert ks3.choose_k(3, 4, 8) == 1


class Mesh:  # what the chunks read of a mesh before any exchange
    def __init__(self, *shape):
        self.shape = shape
        self.mesh_dim_names = ("ry", "rx")[:len(shape)]

    def size(self, dim):
        return self.shape[dim]

    def get_coordinate(self):
        return [0] * len(self.shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_local_kernel_is_decided_before_any_launch(dtype):
    """'inplace' is B4 and 'two-stream' B6, the same arithmetic out of
    place, on every block of every chunk: a chunk takes its kernel when it
    lays out its slab, before any launch, and the kernels take any shape, so
    nothing is caught and no block falls back to another kernel."""
    kw = dict(k_steps=2, omega=1.85, density=0.1, accel=0.005, accel_plane=14, nz=16)
    for local_engine, stepk in (("inplace", d3q19_kstep_inplace.stepk),
                                ("two-stream", d3q19_kstep.stepk)):
        assert ks3.local_kernel(local_engine) is stepk
        for chunk, (hz, hy, nx) in (
                (ks3.make_chunk_fn(Mesh(1), local_engine=local_engine, **kw), (16, 5, 7)),
                (ks3.make_overlap_chunk_fn(Mesh(1), local_engine=local_engine, **kw),
                 (16, 16, 32)),
                (ks3.make_zy_chunk_fn(Mesh(1, 1), ny=16, local_engine=local_engine, **kw),
                 (16, 16, 32))):
            chunk.start(torch.zeros((19, hz, hy, nx), dtype=dtype),
                        torch.zeros((hz + 4, hy + 2 * ks3.GHOST_Y, nx), dtype=torch.bool))
            kernels = [getattr(chunk, name) for name in ("stepk", "interior_kernel",
                                                         "strip_kernel") if hasattr(chunk, name)]
            assert kernels and all(k is stepk for k in kernels)
    with pytest.raises(ValueError, match="local_engine"):
        ks3.local_kernel("fallback")


def test_chunks_refuse_what_the_reference_refuses():
    kw = dict(k_steps=2, omega=1.85, density=0.1, accel=0.005, accel_plane=14)
    with pytest.raises(ValueError, match="evenly-sharded nz only"):
        ks3.make_overlap_chunk_fn(Mesh(4), nz=22, **kw)
    with pytest.raises(ValueError, match=r"needs >= 3\*K planes per shard"):
        ks3.make_overlap_chunk_fn(Mesh(4), nz=16, **kw)
    with pytest.raises(ValueError, match="last shard would hold"):
        ks3.make_chunk_fn(Mesh(4), nz=7, **kw)
    with pytest.raises(ValueError, match="k_steps must be <= 8"):
        ks3.make_zy_chunk_fn(Mesh(2, 2), nz=16, ny=32, **{**kw, "k_steps": 9})
    with pytest.raises(ValueError, match="k_steps must be in 1..4"):
        ks3.make_chunk_fn(Mesh(2), nz=16, **{**kw, "k_steps": 5})
    with pytest.raises(ValueError, match="y-shards"):
        ks3.make_zy_chunk_fn(Mesh(2, 3), nz=16, ny=17, **kw)
