"""The port's plain PyTorch engine (lbm_tpu_torch.ops.d2q9) against the JAX
reference (lbm_tpu.ops.d2q9), on the CPU.

Inputs come from numpy with a fixed seed and go through both. Tolerances:
  * float64: <= 1e-12 relative (max abs difference over max abs value) — the
    two engines do the same operations in the same grouping; XLA may contract
    a product and a sum into one FMA where PyTorch rounds each, which moves
    the last bit, and 40 steps do not amplify that beyond ~1e-14;
  * float32: <= 2e-6 relative on the state — the same last-bit differences
    at float32's 6e-8 unit round-off, a few ulp after tens of steps on a
    near-equilibrium state; <= 2e-5 on Sum|u| and av_vels, because u comes
    from differences of nearly equal populations (~1e-2 each, u ~ 1e-4), so
    one ulp of a population is ~1e-5 of u (measured: 6.6e-6 after 40 steps).
The unit cases mirror tests/test_d2q9_step.py: rebound swap, accelerate
guard, streaming corners.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.core.params import Params as JParams
from lbm_tpu.ops import d2q9 as jd2q9
from lbm_tpu_torch.core import state
from lbm_tpu_torch.core.params import Params
from lbm_tpu_torch.ops import d2q9

NY, NX = 32, 64
BARS = {np.float64: 1e-12, np.float32: 2e-6}  # state
U_BARS = {np.float64: 1e-12, np.float32: 2e-5}  # Sum|u|, av_vels
KW = dict(omega=1.85, accel_w1=0.1 * 0.005 / 9, accel_w2=0.1 * 0.005 / 36)
DTYPES = [np.float64, np.float32]


def make_case(dtype, seed=0):
    """Near-equilibrium state (rest weights perturbed by up to 20%) and a box
    obstacle with a wall row."""
    rng = np.random.default_rng(seed)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None]
    f = (0.1 * w * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (9, NY, NX)))).astype(dtype)
    mask = np.zeros((NY, NX), bool)
    mask[8:16, 16:32] = True
    mask[0, :] = True
    return f, mask


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_step_matches_jax(dtype):
    f, mask = make_case(dtype)
    with jax.enable_x64(dtype == np.float64):
        amask = jd2q9.accel_row_mask(NY, NX, NY - 2, dtype=jnp.dtype(dtype))
        jf, jt = jd2q9.step(jnp.asarray(f), jnp.asarray(mask), amask, **KW)
        jf, jt = np.asarray(jf), float(jt)
    tf, tm = state.to_torch(f, mask, device="cpu")
    tamask = d2q9.accel_row_mask(NY, NX, NY - 2, dtype=tf.dtype)
    pf, pt = d2q9.step(tf, tm, tamask, **KW)
    assert pf.dtype == tf.dtype
    assert rel(pf.numpy(), jf) <= BARS[dtype]
    assert rel(pt.item(), jt) <= U_BARS[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_run_10_steps_matches_jax(dtype):
    f, mask = make_case(dtype, seed=1)
    with jax.enable_x64(dtype == np.float64):
        amask = jd2q9.accel_row_mask(NY, NX, NY - 2, dtype=jnp.dtype(dtype))
        jf, jt = jd2q9.run(jnp.asarray(f), jnp.asarray(mask), amask, num_steps=10, **KW)
        jf, jt = np.asarray(jf), np.asarray(jt)
    tf, tm = state.to_torch(f, mask, device="cpu")
    pf, pt = d2q9.run(tf, tm, d2q9.accel_row_mask(NY, NX, NY - 2, dtype=tf.dtype),
                      num_steps=10, **KW)
    assert pt.shape == (10,)
    assert rel(pf.numpy(), jf) <= BARS[dtype]
    assert rel(pt.numpy(), jt) <= U_BARS[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_first_accelerate_matches_jax(dtype):
    f, mask = make_case(dtype, seed=2)
    # one guarded cell: its west-side density would go negative
    f[3, NY - 2, 5] = 1e-9
    aw = dict(accel_row=NY - 2, accel_w1=KW["accel_w1"], accel_w2=KW["accel_w2"])
    with jax.enable_x64(dtype == np.float64):
        jf = np.asarray(jd2q9.first_accelerate(jnp.asarray(f), jnp.asarray(mask), **aw))
    tf, tm = state.to_torch(f, mask, device="cpu")
    pf = d2q9.first_accelerate(tf, tm, **aw)
    np.testing.assert_array_equal(pf.numpy(), jf)
    np.testing.assert_array_equal(tf.numpy(), f)  # the input is left as it was


@pytest.mark.parametrize("dtype", DTYPES)
def test_simulate_matches_jax(dtype):
    p = Params(nx=NX, ny=NY, max_iters=40, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    _, mask = make_case(dtype)
    f = state.initial_distributions(p, dtype)
    with jax.enable_x64(dtype == np.float64):
        jp = JParams(**{k: getattr(p, k) for k in ("nx", "ny", "max_iters", "reynolds_dim",
                                                    "density", "accel", "omega")})
        jf, jav = jd2q9.simulate(jp, jnp.asarray(f), jnp.asarray(mask))
        jf, jav = np.asarray(jf), np.asarray(jav)
    tf, tm = state.to_torch(f, mask, device="cpu")
    pf, pav = d2q9.simulate(p, tf, tm)
    assert pav.shape == (40,)
    assert rel(pf.numpy(), jf) <= BARS[dtype]
    assert rel(pav.numpy(), jav) <= U_BARS[dtype]


def test_equilibrium_matches_jax():
    rng = np.random.default_rng(4)
    rho = rng.uniform(0.09, 0.11, (4, 6))
    ux, uy = rng.uniform(-0.05, 0.05, (2, 4, 6))
    with jax.enable_x64(True):
        je = np.asarray(jd2q9.equilibrium(jnp.asarray(rho), jnp.asarray(ux), jnp.asarray(uy)))
    pe = d2q9.equilibrium(torch.tensor(rho), torch.tensor(ux), torch.tensor(uy)).numpy()
    assert rel(pe, je) <= 1e-15


def np_stream_pull(f):
    """Independent numpy pull streaming: s_k(x) = f_k(x - e_k), periodic."""
    out = np.empty_like(f)
    for k, (dy, dx) in enumerate(state.SPEED_VECTORS):
        out[k] = np.roll(f[k], (dy, dx), axis=(0, 1))
    return out


def test_streaming_all_nine_speeds_and_corners():
    f = np.random.default_rng(5).uniform(0.01, 1.0, (9, 5, 7)).astype(np.float32)
    s = torch.stack(d2q9.stream_pull(torch.tensor(f))).numpy()
    np.testing.assert_array_equal(s, np_stream_pull(f))
    # a marker in any corner moves with its speed, wrapping around the edges
    for h, w in ((4, 4), (3, 5)):
        for k, (dy, dx) in enumerate(state.SPEED_VECTORS):
            for y, x in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1)):
                g = np.zeros((9, h, w), np.float32)
                g[k, y, x] = 7.0
                s = torch.stack(d2q9.stream_pull(torch.tensor(g))).numpy()
                assert s[k, (y + dy) % h, (x + dx) % w] == 7.0
                assert s.sum() == 7.0


def test_rebound_swaps_opposite_speeds_and_zeroes_u():
    f = np.random.default_rng(6).uniform(0.01, 1.0, (9, 3, 3)).astype(np.float32)
    mask = np.zeros((3, 3), bool)
    mask[1, 1] = True
    f_new, u = d2q9.collide_fields(tuple(torch.tensor(f)), torch.tensor(mask),
                                   torch.zeros(3, 1), omega=1.85, accel_w1=0.0, accel_w2=0.0)
    for k in range(9):
        assert f_new[k, 1, 1].item() == f[state.OPPOSITE[k], 1, 1]
    assert u[1, 1].item() == 0.0 and (u.numpy() > 0).sum() == 8


class TestAccelerateGuard:
    params = Params(nx=4, ny=4, max_iters=1, reynolds_dim=10, density=0.1, accel=0.005,
                    omega=1.85)
    w1, w2 = 0.1 * 0.005 / 9, 0.1 * 0.005 / 36

    def accelerate(self, f, mask):
        return d2q9.first_accelerate(torch.tensor(f), torch.tensor(mask), accel_row=2,
                                     accel_w1=self.w1, accel_w2=self.w2).numpy()

    def test_modifies_target_row_only(self):
        f = state.initial_distributions(self.params, np.float32)
        f2 = self.accelerate(f, np.zeros((4, 4), bool))
        np.testing.assert_allclose(f2[1, 2], 0.1 / 9 + self.w1, rtol=1e-6)
        np.testing.assert_allclose(f2[3, 2], 0.1 / 9 - self.w1, rtol=1e-6)
        np.testing.assert_allclose(f2[5, 2], 0.1 / 36 + self.w2, rtol=1e-6)
        np.testing.assert_allclose(f2[7, 2], 0.1 / 36 - self.w2, rtol=1e-6)
        np.testing.assert_array_equal(f2[:, 0], f[:, 0])
        np.testing.assert_array_equal(f2[0, 2], f[0, 2])

    def test_negative_density_guard_and_obstacle_skip(self):
        f = state.initial_distributions(self.params, np.float32)
        f[3, 2, 1] = 1e-9  # west density too small at (row 2, col 1)
        mask = np.zeros((4, 4), bool)
        mask[2, 3] = True
        f2 = self.accelerate(f, mask)
        np.testing.assert_array_equal(f2[:, 2, 1], f[:, 2, 1])  # guarded cell
        np.testing.assert_array_equal(f2[:, 2, 3], f[:, 2, 3])  # obstacle
        assert f2[1, 2, 0] > f[1, 2, 0]  # neighbour still accelerated
