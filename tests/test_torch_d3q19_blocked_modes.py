"""The diagnostic modes of the in-place blocked D3Q19 kernel B5
(lbm_tpu_torch.ops.d3q19_kstep_inplace_blocked, `mode="stream_only"` and
`mode="copy"`) on the CPU, against the JAX Pallas kernel they port
(lbm_tpu.ops.d3q19_pallas_inplace_blocked.stepk(mode=...)) run in interpret
mode, at the smallest shape that kernel takes: 4x8x16, bz 2, by 8 (two z-rows
of blocks, one y-block), K = 1 and 2, one cached interpret run per (mode, K).

On the CPU the wrapper runs the plain version, `d3q19_kstep.stepk_plain(mode=)`;
the CUDA kernel is held against it on the card by chip_smoke.py, on both of
its paths, at K = 1..4.

Tolerances: the state bit for bit in float32 (streaming only moves values).
stream_only's Sum|u| is the window sum of the rest-speed plane; the TPU
kernel adds it a block at a time in float32 and the plain version in one
sum, so it is held to 1e-6 relative. copy's Sum|u| is zeros in the port and
a token in the TPU kernel (one value a block), never compared. The Pallas
kernels do not run in float64 (their Sum|u| is a float32 output), so the
float64 state is held bit for bit to K pull-streams of the JAX engine's own
`lbm_tpu.ops.d3q19.stream_pull`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import d3q19 as j3
from lbm_tpu.ops import d3q19_pallas_inplace_blocked as jblk
from lbm_tpu_torch.core import state
from lbm_tpu_torch.ops import (d3q19_kstep, d3q19_kstep_blocked as b7,
                               d3q19_kstep_inplace_blocked as b5, d3q19_lattice)

SHAPE = (4, 8, 16)
BZ, BY = 2, 8
KW = dict(omega=1.85, density=0.1, accel=0.005, accel_plane=2)
MODES = ("stream_only", "copy")


def make_case(dtype, seed=0):
    rng = np.random.default_rng(seed)
    f = d3q19_lattice.initial_distributions(*SHAPE, 0.1, np.float64)
    f = (f * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, f.shape))).astype(dtype)
    mask = rng.uniform(size=SHAPE) < 0.05
    mask[0] = mask[-1] = True
    return f, mask


@functools.lru_cache(maxsize=None)
def pallas_result(mode, k):
    """One interpret-mode run of the TPU kernel in `mode` (float32)."""
    f, mask = make_case(np.float32)
    jf, jt = jblk.stepk(jnp.asarray(f), jnp.asarray(mask.astype(np.float32)), k_steps=k,
                        bz=BZ, by=BY, interpret=True, mode=mode, **KW)
    return np.asarray(jf), np.asarray(jt)


def port_result(mode, k, dtype=np.float32):
    f, mask = make_case(dtype)
    tf, tm = state.to_torch3d(f, mask, device="cpu", dtype=torch.from_numpy(f).dtype)
    out, tot = b5.stepk(tf, tm, k_steps=k, mode=mode, **KW)
    assert out is tf  # in place, as on the card
    return f, out.numpy(), tot.numpy()


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_state_is_bit_equal_to_the_tpu_kernel(mode, k):
    jf, _ = pallas_result(mode, k)
    f, got, _ = port_result(mode, k)
    np.testing.assert_array_equal(got, jf)
    if mode == "copy":
        np.testing.assert_array_equal(got, f)


@pytest.mark.parametrize("k", [1, 2])
def test_stream_only_sum_is_the_rest_plane(k):
    _, jt = pallas_result("stream_only", k)
    f, _, tot = port_result("stream_only", k)
    assert tot.shape == (k,)
    np.testing.assert_allclose(tot, jt, rtol=1e-6)
    # the rest speed does not move: every step sums the same plane
    np.testing.assert_allclose(tot, f[0].astype(np.float64).sum(), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
def test_copy_sum_is_zeros(k):
    _, _, tot = port_result("copy", k)
    np.testing.assert_array_equal(tot, np.zeros(k, np.float32))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_stream_only_float64_is_the_jax_engine_streaming(k):
    f, got, _ = port_result("stream_only", k, np.float64)
    with jax.enable_x64(True):
        x = jnp.asarray(f)
        for _ in range(k):
            x = jnp.stack(j3.stream_pull(x))
        np.testing.assert_array_equal(got, np.asarray(x))


@pytest.mark.parametrize("mode", MODES)
def test_run_takes_the_modes(mode):
    """`run` in a mode is `stepk` in that mode, pass after pass."""
    f, mask = make_case(np.float64)
    tf, tm = state.to_torch3d(f, mask, device="cpu", dtype=torch.float64)
    want, tots = tf.clone(), []
    for _ in range(3):
        want, tot = d3q19_kstep.stepk_plain(want, tm, k_steps=2, mode=mode, **KW)
        tots.append(tot)
    got, got_tot = b5.run(tf, tm, num_steps=6, k_steps=2, mode=mode, **KW)
    assert torch.equal(got, want) and torch.equal(got_tot, torch.cat(tots))


@pytest.mark.parametrize("mode", MODES)
def test_the_two_stream_kernel_refuses_a_mode(mode):
    """B7 has no diagnostic modes, as `lbm_tpu.ops.d3q19_pallas.stepk(by=...)`
    has none; it refuses before it looks at the device."""
    f, mask = make_case(np.float32)
    tf, tm = state.to_torch3d(f, mask, device="cpu")
    with pytest.raises(ValueError, match="no diagnostic modes"):
        b7.stepk(tf, tm, k_steps=2, mode=mode, **KW)
    with pytest.raises(ValueError, match="no diagnostic modes"):
        b7.run(tf, tm, num_steps=2, k_steps=2, mode=mode, **KW)
    out, _ = b7.stepk(tf, tm, k_steps=2, mode="full", **KW)
    assert out.shape == tf.shape


def test_unknown_modes_are_refused():
    f, mask = make_case(np.float32)
    tf, tm = state.to_torch3d(f, mask, device="cpu")
    with pytest.raises(ValueError, match="mode must be one of"):
        b5.stepk(tf, tm, k_steps=1, mode="collide_no_roll", **KW)
    with pytest.raises(ValueError, match="mode must be one of"):
        d3q19_kstep.stepk_plain(tf, tm, k_steps=1, mode="fused", **KW)
