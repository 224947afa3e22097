"""The port's halo strategies (lbm_tpu_torch.parallel.halo) on gloo ranks
against the JAX package on the CPU.

Every strategy (implicit, ppermute, manytensors, allgather, naive) runs
`halo.simulate_sharded` on spawned ranks (one group of 4 and one of 2, each
running every case of this file once, `parallel.launch.run_each`) on the
meshes (4, 1), (1, 4), (2, 2) and (2, 1), one step and five, from a seeded
float64 state; the result is held against `lbm_tpu.ops.d2q9.first_accelerate`
and `run` on one device in float64 to 1e-12 relative (state and av_vels).
The NE speed at a (2, 2) block corner must cross to the diagonal block in
one step. Uneven grids run by pad-and-mask against
`lbm_tpu.parallel.halo.simulate_sharded` on the JAX package's 8 virtual CPU
devices (float64, 1e-12). The refusals need no ranks.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbm_tpu.ops import d2q9 as jd2q9
from lbm_tpu.parallel import halo as jhalo
from lbm_tpu.parallel import mesh as jmesh
from lbm_tpu.core.params import Params as JParams
from lbm_tpu_torch.core.params import Params
from lbm_tpu_torch.parallel import halo, launch

STRATEGIES = ("implicit", "ppermute", "manytensors", "allgather", "naive")
MESHES4 = ((4, 1), (1, 4), (2, 2))
NY, NX = 32, 48
STEPS = (1, 5)
UNEVEN4 = (((4, 1), (37, 20)), ((2, 2), (37, 54)), ((1, 4), (16, 50)))
UNEVEN2 = (((2, 1), (37, 20)),)
TIMEOUT = 240
BAR = 1e-12


def params(ny, nx, steps, omega=1.85, accel=0.005):
    return Params(nx=nx, ny=ny, max_iters=steps, reynolds_dim=10, density=0.1, accel=accel,
                  omega=omega)


def seeded_case(ny, nx, seed=11):
    """A stable float64 state (equilibrium weights, 20% noise) and a mask
    with obstacles on block boundaries and the wrap-around edge."""
    rng = np.random.default_rng(seed)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None]
    f = 0.1 * w * (1.0 + 0.2 * rng.uniform(-1, 1, (9, ny, nx)))
    mask = np.zeros((ny, nx), bool)
    mask[ny // 3:ny // 2, nx // 3:nx // 2] = True
    mask[0, :] = True
    mask[:, 0] = True
    return f, mask


def corner_case():
    f = np.full((9, 32, 32), 0.1)
    f[5, 15, 15] = 3.0  # NE speed at the corner of block (0, 0) of a 2x2 mesh
    return f, np.zeros((32, 32), bool)


def call(shape, p, f, mask, strategy):
    return (launch.on_mesh, (shape, halo.simulate_sharded, p, f, mask), {"strategy": strategy})


def cases(meshes, uneven):
    out = {}
    f, mask = seeded_case(NY, NX)
    for shape in meshes:
        for strategy in STRATEGIES:
            for steps in STEPS:
                out[("even", shape, strategy, steps)] = call(shape, params(NY, NX, steps), f,
                                                             mask, strategy)
    for shape, (ny, nx) in uneven:
        out[("uneven", shape, ny, nx)] = call(shape, params(ny, nx, 5), *seeded_case(ny, nx),
                                              "ppermute")
    if (2, 2) in meshes:
        for strategy in STRATEGIES:
            out[("corner", strategy)] = call((2, 2), params(32, 32, 1, omega=1.0, accel=0.0),
                                             *corner_case(), strategy)
    return out


@pytest.fixture(scope="module")
def results():
    """Every case of this file, in one group of 4 ranks and one of 2."""
    out = {}
    for world, meshes, uneven in ((4, MESHES4, UNEVEN4), (2, ((2, 1),), UNEVEN2)):
        todo = cases(meshes, uneven)
        got = launch.run_each(list(todo.values()), world, timeout=TIMEOUT)
        out.update({k: (f.numpy(), av.numpy()) for k, (f, av) in zip(todo, got)})
    return out


def jax_reference(p, f, mask):
    """first_accelerate, then max_iters global steps, in float64."""
    aw = jd2q9.AccelWeights.from_params(p)
    with jax.enable_x64(True):
        fj = jd2q9.first_accelerate(jnp.asarray(f), jnp.asarray(mask), accel_row=p.ny - 2,
                                    accel_w1=aw.w1, accel_w2=aw.w2)
        amask = jd2q9.accel_row_mask(p.ny, p.nx, p.ny - 2, dtype=jnp.float64)
        fj, tot = jd2q9.run(fj, jnp.asarray(mask), amask, num_steps=p.max_iters, omega=p.omega,
                            accel_w1=aw.w1, accel_w2=aw.w2)
        return np.asarray(fj), np.asarray(tot) / float((~mask).sum())


def rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("shape", MESHES4 + ((2, 1),))
def test_strategy_matches_the_global_step(results, shape, strategy, steps):
    f, mask = seeded_case(NY, NX)
    got_f, got_av = results[("even", shape, strategy, steps)]
    want_f, want_av = jax_reference(params(NY, NX, steps), f, mask)
    assert got_f.shape == (9, NY, NX) and got_f.dtype == np.float64
    assert got_av.shape == (steps,)
    assert rel(got_f, want_f) <= BAR
    assert rel(got_av, want_av) <= BAR


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_corner_speed_crosses_the_block_boundary_diagonally(results, strategy):
    got_f, _ = results[("corner", strategy)]
    f, mask = corner_case()
    want_f, _ = jax_reference(params(32, 32, 1, omega=1.0, accel=0.0), f, mask)
    assert rel(got_f, want_f) <= BAR
    # the streamed mass landed at (16, 16), on block (1, 1)
    assert got_f[5, 16, 16] > 1.0


@pytest.mark.parametrize("shape,grid", UNEVEN4 + UNEVEN2)
def test_uneven_grids_match_jax_pad_and_mask(results, shape, grid):
    ny, nx = grid
    f, mask = seeded_case(ny, nx)
    got_f, got_av = results[("uneven", shape, ny, nx)]
    p = params(ny, nx, 5)
    with jax.enable_x64(True):
        jm = jax.sharding.Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                               (jmesh.ROW_AXIS, jmesh.COL_AXIS))
        want_f, want_av = jhalo.simulate_sharded(JParams(**dataclasses.asdict(p)), f, mask, jm,
                                                 strategy="ppermute")
        want_f, want_av = np.asarray(want_f), np.asarray(want_av)
    assert got_f.shape == (9, ny, nx)
    assert rel(got_f, want_f) <= BAR
    assert rel(got_av, want_av) <= BAR
    # and the global step
    ref_f, _ = jax_reference(p, f, mask)
    assert rel(got_f, ref_f) <= BAR


def fake_mesh(rows, cols):
    """What the checks before any exchange read of a mesh: its shape."""
    return types.SimpleNamespace(shape=(rows, cols))


def test_refusals():
    p = params(37, 54, 2)
    f, mask = seeded_case(37, 54)
    with pytest.raises(ValueError, match="wrong physics"):
        halo.simulate_sharded(p, f, mask, None, strategy="none")
    with pytest.raises(ValueError, match="unknown strategy"):
        halo.simulate_sharded(p, f, mask, None, strategy="bogus")
    with pytest.raises(ValueError, match="'implicit' strategy cannot lay out uneven"):
        halo.prepare_sharded(p, f, mask, fake_mesh(2, 2), "implicit")
    for strategy in ("manytensors", "allgather", "naive", "none"):
        with pytest.raises(ValueError, match="support only the 'ppermute'"):
            halo.make_sharded_step(None, omega=1.85, accel_w1=0.0, accel_w2=0.0,
                                   exchange=strategy, pad_rows=1)
    with pytest.raises(ValueError, match="a whole shard would be padding"):
        halo.prepare_sharded(params(9, 10, 1), *seeded_case(9, 10), fake_mesh(4, 1))


def test_a_rank_body_must_be_of_the_port():
    with pytest.raises(ValueError, match="function of lbm_tpu_torch"):
        launch.run(rel, 2)
    with pytest.raises(ValueError, match="function of lbm_tpu_torch"):
        launch.run_each([(launch.on_mesh, ((2, 1), rel), {})], 2)
