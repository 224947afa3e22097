"""The diagnostic modes of the two-stream D3Q19 kernel B6
(lbm_tpu_torch.ops.d3q19_kstep, `mode="stream_only"`, `"copy"` and
`"collide_no_roll"`) on the CPU, against the JAX Pallas z-slab kernel they
port (lbm_tpu.ops.d3q19_pallas.stepk(mode=...)) run in interpret mode, at the
sizes of tests/test_torch_d3q19_kstep.py: 8x8x128, bz 4, K = 1 and 2, one
cached interpret run per (mode, K).

On the CPU the wrapper runs the plain version, `d3q19_kstep.stepk_plain(mode=)`;
the CUDA kernel runs the modes on its wave path and is held against the plain
version on the card by experiments/cuda-kstep-tiles/wave3d.py `check_paths`.

Tolerances: the state within 1e-5 of the largest value in float32 (stream_only
and copy only move values and are held bit for bit too). stream_only's
Sum|u| is the window sum of the rest-speed plane, which the TPU kernel adds
a slab at a time and the plain version in one sum: 1e-6 relative;
collide_no_roll's Sum|u| 1e-5. copy's Sum|u| is zeros in the port and a
token in the TPU kernel (one value a slab), never compared. The Pallas
kernel does not run in float64 (its Sum|u| is a float32 output), so the
float64 state is held to K steps of the JAX engine's own functions: pull
streams (`lbm_tpu.ops.d3q19.stream_pull`) bit for bit, and for
collide_no_roll `collide_fields` on the pull along z at 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import d3q19 as j3
from lbm_tpu.ops import d3q19_pallas
from lbm_tpu_torch.core import state
from lbm_tpu_torch.ops import d3q19_kstep, d3q19_kstep_inplace, d3q19_lattice

SHAPE = (8, 8, 128)
KW = dict(omega=1.85, density=0.1, accel=0.005, accel_plane=6)
MODES = ("stream_only", "copy", "collide_no_roll")


def make_case(dtype, seed=0):
    rng = np.random.default_rng(seed)
    f = d3q19_lattice.initial_distributions(*SHAPE, 0.1, np.float64)
    f = (f * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, f.shape))).astype(dtype)
    mask = rng.uniform(size=SHAPE) < 0.05
    mask[0] = mask[-1] = True
    return f, mask


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@functools.lru_cache(maxsize=None)
def pallas_result(mode, k):
    """One interpret-mode run of the TPU kernel in `mode` (float32)."""
    f, mask = make_case(np.float32)
    jf, jt = d3q19_pallas.stepk(jnp.asarray(f), jnp.asarray(mask.astype(np.float32)),
                                k_steps=k, bz=4, interpret=True, mode=mode, **KW)
    return np.asarray(jf), np.asarray(jt)


def port_result(mode, k, dtype=np.float32):
    f, mask = make_case(dtype)
    tf, tm = state.to_torch3d(f, mask, device="cpu", dtype=torch.from_numpy(f).dtype)
    out, tot = d3q19_kstep.stepk(tf, tm, k_steps=k, mode=mode, **KW)
    np.testing.assert_array_equal(tf.numpy(), f)  # two-stream: the input is left alone
    return f, mask, out.numpy(), tot.numpy()


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_state_matches_the_tpu_kernel(mode, k):
    jf, _ = pallas_result(mode, k)
    f, _, got, tot = port_result(mode, k)
    assert got.shape == jf.shape and tot.shape == (k,)
    assert rel(got, jf) <= 1e-5
    if mode != "collide_no_roll":  # values only move
        np.testing.assert_array_equal(got, jf)
    if mode == "copy":
        np.testing.assert_array_equal(got, f)
        np.testing.assert_array_equal(tot, np.zeros(k, np.float32))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mode", ["stream_only", "collide_no_roll"])
def test_sum_matches_the_tpu_kernel(mode, k):
    _, jt = pallas_result(mode, k)
    f, _, _, tot = port_result(mode, k)
    np.testing.assert_allclose(tot, jt, rtol=1e-6 if mode == "stream_only" else 1e-5)
    if mode == "stream_only":  # the rest speed does not move
        np.testing.assert_allclose(tot, f[0].astype(np.float64).sum(), rtol=1e-6)


def test_collide_no_roll_differs_from_full():
    """The mode is not the production step: without the shifts in y and x
    the state differs (and full matches the TPU kernel's full step)."""
    f, mask = make_case(np.float32)
    tf, tm = state.to_torch3d(f, mask, device="cpu")
    full, _ = d3q19_kstep.stepk(tf, tm, k_steps=1, **KW)
    no_roll, _ = d3q19_kstep.stepk(tf, tm, k_steps=1, mode="collide_no_roll", **KW)
    assert rel(no_roll.numpy(), full.numpy()) > 1e-3


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", ["stream_only", "collide_no_roll"])
def test_float64_is_the_jax_engine(mode, k):
    f, mask, got, _ = port_result(mode, k, np.float64)
    with jax.enable_x64(True):
        x = jnp.asarray(f)
        amask = j3.accel_plane_mask(*SHAPE, KW["accel_plane"], dtype=np.float64)
        for _ in range(k):
            if mode == "stream_only":
                x = jnp.stack(j3.stream_pull(x))
            else:
                pulled = [jnp.roll(x[q], int(j3.E[q, 0]), axis=0) for q in range(19)]
                x, _ = j3.collide_fields(pulled, jnp.asarray(mask), amask, omega=KW["omega"],
                                         density=KW["density"], accel=KW["accel"])
        want = np.asarray(x)
    if mode == "stream_only":
        np.testing.assert_array_equal(got, want)
    else:
        assert rel(got, want) <= 1e-12


@pytest.mark.parametrize("mode", MODES)
def test_run_takes_the_modes(mode):
    """`run` in a mode is `stepk` in that mode, pass after pass."""
    f, mask = make_case(np.float64)
    tf, tm = state.to_torch3d(f, mask, device="cpu", dtype=torch.float64)
    want, tots = tf, []
    for _ in range(3):
        want, tot = d3q19_kstep.stepk_plain(want, tm, k_steps=2, mode=mode, **KW)
        tots.append(tot)
    got, got_tot = d3q19_kstep.run(tf, tm, num_steps=6, k_steps=2, mode=mode, **KW)
    assert torch.equal(got, want) and torch.equal(got_tot, torch.cat(tots))


def test_modes_are_refused_where_they_do_not_run():
    """Unknown modes raise; B4 takes none (it has no `mode`), and a mode
    forced onto the step path raises before it looks for a card."""
    f, mask = make_case(np.float32)
    tf, tm = state.to_torch3d(f, mask, device="cpu")
    with pytest.raises(ValueError, match="mode must be one of"):
        d3q19_kstep.stepk(tf, tm, k_steps=1, mode="fused", **KW)
    with pytest.raises(TypeError):
        d3q19_kstep_inplace.stepk(tf, tm, k_steps=1, mode="copy", **KW)
    g = torch.empty((19, *SHAPE), device="meta")
    with pytest.raises(ValueError, match="wave path only"):
        d3q19_kstep.resolve_path("step", g, 2, mode="copy")
