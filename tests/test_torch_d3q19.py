"""The port's plain D3Q19 engine (lbm_tpu_torch.ops.d3q19, d3q19_lattice)
against the JAX engine (lbm_tpu.ops.d3q19), on the CPU, from the same
numpy-seeded inputs.

Tolerances (max abs difference over max abs value): float64 <= 1e-12 (both
engines do the same operations in the same grouping; only XLA's last-bit
contraction differences remain), float32 <= 1e-5 (the same, at float32's
rounding; Sum|u| adds the reduction order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import d3q19 as j3
from lbm_tpu.ops import d3q19_lattice as jlattice
from lbm_tpu_torch.core import state
from lbm_tpu_torch.ops import d3q19, d3q19_lattice

NZ, NY, NX = 6, 8, 16
KW = dict(omega=1.85, density=0.1, accel=0.005)
BARS = {np.float64: 1e-12, np.float32: 1e-5}
TORCH_DTYPES = {np.float64: torch.float64, np.float32: torch.float32}


def make_case(dtype, seed=0):
    rng = np.random.default_rng(seed)
    f = d3q19_lattice.initial_distributions(NZ, NY, NX, 0.1, np.float64)
    f = (f * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, f.shape))).astype(dtype)
    mask = rng.uniform(size=(NZ, NY, NX)) < 0.08
    mask[0] = mask[-1] = True
    return f, mask


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_lattice_constants_equal_the_reference():
    np.testing.assert_array_equal(d3q19_lattice.E, jlattice.E)
    np.testing.assert_array_equal(d3q19_lattice.W, jlattice.W)
    np.testing.assert_array_equal(d3q19_lattice.OPPOSITE, jlattice.OPPOSITE)
    assert d3q19_lattice.NUM_SPEEDS == jlattice.NUM_SPEEDS == 19
    assert d3q19.E is d3q19_lattice.E


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_initial_distributions_bit_equal(dtype):
    ours = d3q19_lattice.initial_distributions(NZ, NY, NX, 0.1, dtype)
    theirs = jlattice.initial_distributions(NZ, NY, NX, 0.1, dtype)
    assert ours.dtype == theirs.dtype == dtype
    np.testing.assert_array_equal(ours, theirs)


def test_stream_pull_equals_the_reference():
    f, _ = make_case(np.float32)
    ours = d3q19.stream_pull(torch.tensor(f))
    theirs = j3.stream_pull(jnp.asarray(f))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_collide_fields_matches_jax(dtype):
    f, mask = make_case(dtype, seed=1)
    with jax.enable_x64(dtype == np.float64):
        amask = j3.accel_plane_mask(NZ, NY, NX, NZ - 2, dtype=dtype)
        jf, ju = j3.collide_fields(list(jnp.asarray(f)), jnp.asarray(mask), amask, **KW)
        jf, ju = np.asarray(jf), np.asarray(ju)
    tf, tm = state.to_torch3d(f, mask, device="cpu")
    tamask = d3q19.accel_plane_mask(NZ, NY, NX, NZ - 2, dtype=tf.dtype)
    np.testing.assert_array_equal(tamask.numpy(), np.asarray(amask))
    of, ou = d3q19.collide_fields(list(tf), tm, tamask, **KW)
    assert of.shape == (19, NZ, NY, NX) and of.dtype == tf.dtype
    assert rel(of.numpy(), jf) <= BARS[dtype]
    assert rel(ou.numpy(), ju) <= BARS[dtype]
    assert (ou.numpy()[mask] == 0).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_step_and_run_match_jax(dtype):
    f, mask = make_case(dtype, seed=2)
    with jax.enable_x64(dtype == np.float64):
        amask = j3.accel_plane_mask(NZ, NY, NX, NZ - 2, dtype=dtype)
        jf1, jt1 = j3.step(jnp.asarray(f), jnp.asarray(mask), amask, **KW)
        jf, jt = j3.run(jnp.asarray(f), jnp.asarray(mask), amask, num_steps=6, **KW)
        jf1, jt1, jf, jt = (np.asarray(a) for a in (jf1, jt1, jf, jt))
    tf, tm = state.to_torch3d(f, mask, device="cpu")
    tamask = d3q19.accel_plane_mask(NZ, NY, NX, NZ - 2, dtype=tf.dtype)
    of1, ot1 = d3q19.step(tf, tm, tamask, **KW)
    assert rel(of1.numpy(), jf1) <= BARS[dtype] and rel(ot1.numpy(), jt1) <= BARS[dtype]
    of, ot = d3q19.run(tf, tm, tamask, num_steps=6, **KW)
    assert ot.shape == (6,)
    assert rel(of.numpy(), jf) <= BARS[dtype] and rel(ot.numpy(), jt) <= BARS[dtype]
    empty_f, empty_t = d3q19.run(tf, tm, tamask, num_steps=0, **KW)
    assert empty_f is tf and empty_t.shape == (0,)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_equilibrium_matches_jax_and_is_stationary(dtype):
    rng = np.random.default_rng(3)
    rho = (0.1 * (1 + 0.1 * rng.uniform(-1, 1, (NZ, NY, NX)))).astype(dtype)
    u = [(0.05 * rng.uniform(-1, 1, (NZ, NY, NX))).astype(dtype) for _ in range(3)]
    with jax.enable_x64(dtype == np.float64):
        jeq = np.asarray(j3.equilibrium(jnp.asarray(rho), *(jnp.asarray(a) for a in u)))
    eq = d3q19.equilibrium(torch.tensor(rho), *(torch.tensor(a) for a in u))
    assert rel(eq.numpy(), jeq) <= BARS[dtype]
    # a collision with no force and no obstacle leaves an equilibrium alone
    none = torch.zeros((NZ, NY, NX), dtype=torch.bool)
    out, _ = d3q19.collide_fields(list(eq), none, torch.zeros((), dtype=eq.dtype), **KW)
    assert rel(out.numpy(), eq.numpy()) <= (1e-12 if dtype == np.float64 else 1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_simulate_matches_jax(dtype):
    with jax.enable_x64(dtype == np.float64):
        jf, jav = j3.simulate(NZ, NY, NX, num_steps=12, dtype=dtype, **KW)
        jf, jav = np.asarray(jf), np.asarray(jav)
    f, av = d3q19.simulate(NZ, NY, NX, num_steps=12, dtype=TORCH_DTYPES[dtype], device="cpu",
                           **KW)
    assert av.shape == (12,) and av.dtype == TORCH_DTYPES[dtype]
    assert rel(f.numpy(), jf) <= BARS[dtype]
    assert rel(av.numpy(), jav) <= BARS[dtype]


@pytest.mark.parametrize("engine", ["cuda", "cuda-inplace"])
def test_kernel_engines_equal_the_plain_engine_on_the_cpu(engine):
    """On the CPU the kernel engines run their plain version, K plain steps
    per pass: all three engines give the same bits, with a custom mask too."""
    _, mask = make_case(np.float32, seed=4)
    ref_f, ref_av = d3q19.simulate(NZ, NY, NX, num_steps=6, obstacle_mask=mask, device="cpu")
    for k_steps in (None, 1, 3):
        f, av = d3q19.simulate(NZ, NY, NX, num_steps=6, obstacle_mask=mask, engine=engine,
                               k_steps=k_steps, device="cpu")
        assert torch.equal(f, ref_f) and torch.equal(av, ref_av)


def test_simulate_rejects_what_it_cannot_run():
    with pytest.raises(ValueError, match="no feasible kernel configuration"):
        d3q19.simulate(NZ, NY, NX, num_steps=6, engine="cuda-inplace", k_steps=4, device="cpu")
    with pytest.raises(ValueError, match="no feasible kernel configuration"):
        d3q19.simulate(NZ, NY, NX, num_steps=10, engine="cuda", k_steps=5, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        d3q19.simulate(NZ, NY, NX, num_steps=2, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        d3q19.simulate(NZ, NY, NX, num_steps=2, dtype=torch.float16, device="cpu")


def test_to_torch3d_checks_shapes():
    f, mask = make_case(np.float32)
    tf, tm = state.to_torch3d(f, mask, device="cpu", dtype=torch.float64)
    assert tf.dtype == torch.float64 and tm.dtype == torch.bool and tf.is_contiguous()
    np.testing.assert_array_equal(tf.numpy(), f.astype(np.float64))
    with pytest.raises(ValueError, match="shape"):
        state.to_torch3d(f[:9], mask, device="cpu")
    with pytest.raises(ValueError, match="mask shape"):
        state.to_torch3d(f, mask[1:], device="cpu")
