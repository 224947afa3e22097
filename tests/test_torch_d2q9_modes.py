"""The diagnostic modes of the port's D2Q9 K-step wrappers (kernels B1, B2,
B3) on the CPU, against the TPU kernels' own `mode` (lbm_tpu.ops.d2q9_pallas,
d2q9_pallas_inplace and d2q9_pallas_manual in interpret mode).

"stream_only" streams K times without bounce-back or collision and sums the
rest-speed plane; "copy" returns the input. Both change no value of the state
by arithmetic, so the state must be bit-equal to the TPU kernels'. The
stream_only Sum|u| is reduced in another order: <= 1e-6 relative. The copy
mode's Sum|u| is only a token (the TPU kernels sum one 128-wide row per band,
the port returns zeros) and is never compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import d2q9_pallas, d2q9_pallas_inplace, d2q9_pallas_manual
from lbm_tpu_torch.core import state
from lbm_tpu_torch.ops import d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual

NY, NX = 32, 128
KW = dict(omega=1.85, accel_w1=0.1 * 0.005 / 9, accel_w2=0.1 * 0.005 / 36, accel_row=NY - 2)
JAX_KERNELS = {"pallas": d2q9_pallas, "pallas-inplace": d2q9_pallas_inplace,
               "pallas-manual": d2q9_pallas_manual}
PORT_WRAPPERS = {"b2": d2q9_kstep, "b1": d2q9_kstep_inplace, "b3": d2q9_kstep_manual}


def make_case(seed=0):
    rng = np.random.default_rng(seed)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None]
    f = (0.1 * w * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (9, NY, NX)))).astype(np.float32)
    mask = rng.uniform(size=(NY, NX)) < 0.1
    return f, mask


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("mode", ["stream_only", "copy"])
@pytest.mark.parametrize("engine", list(JAX_KERNELS))
def test_stepk_plain_modes_match_the_tpu_kernels(engine, mode, k):
    f, mask = make_case(seed=k)
    jf, jt = JAX_KERNELS[engine].stepk(jnp.asarray(f), jnp.asarray(mask.astype(np.float32)),
                                       k_steps=k, band=8, interpret=True, mode=mode, **KW)
    tf, tm = state.to_torch(f, mask, device="cpu")
    pf, pt = d2q9_kstep.stepk_plain(tf, tm, k_steps=k, mode=mode, **KW)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    assert pt.shape == (k,)
    if mode == "stream_only":
        jt = np.asarray(jt, np.float64)
        assert np.abs(pt.numpy() - jt).max() / np.abs(jt).max() <= 1e-6
    else:
        np.testing.assert_array_equal(pf.numpy(), f)


@pytest.mark.parametrize("mode", ["full", "stream_only", "copy"])
@pytest.mark.parametrize("name", list(PORT_WRAPPERS))
def test_wrappers_take_the_mode_to_their_plain_version(name, mode):
    mod = PORT_WRAPPERS[name]
    f, mask = make_case(seed=5)
    tf, tm = state.to_torch(f, mask, device="cpu")
    ref = d2q9_kstep.stepk_plain(tf, tm, k_steps=2, mode=mode, **KW)
    got = mod.stepk(tf.clone(), tm, k_steps=2, mode=mode, **KW)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    run = mod.run(tf.clone(), tm, num_steps=4, k_steps=2, mode=mode, **KW)
    again = d2q9_kstep.stepk_plain(ref[0], tm, k_steps=2, mode=mode, **KW)
    assert torch.equal(run[0], again[0])
    assert torch.equal(run[1], torch.cat([ref[1], again[1]]))


def test_stream_only_is_k_periodic_shifts_and_copy_is_zero_token():
    f, mask = make_case(seed=6)
    tf, tm = state.to_torch(f.astype(np.float64), mask, device="cpu")
    got, tot = d2q9_kstep.stepk_plain(tf, tm, k_steps=3, mode="stream_only", **KW)
    cx = [0, 1, 0, -1, 0, 1, -1, -1, 1]
    cy = [0, 0, 1, 0, -1, 1, 1, -1, -1]
    for q in range(9):
        # pull streaming: speed q moves by (cy, cx) rows and columns a step
        expected = np.roll(f[q].astype(np.float64), (3 * cy[q], 3 * cx[q]), axis=(0, 1))
        np.testing.assert_array_equal(got[q].numpy(), expected)
    np.testing.assert_allclose(tot.numpy(), [f[0].astype(np.float64).sum()] * 3, rtol=1e-12)
    _, token = d2q9_kstep.stepk_plain(tf, tm, k_steps=3, mode="copy", **KW)
    assert torch.equal(token, torch.zeros(3, dtype=torch.float64))


def test_unknown_mode_is_refused():
    f, mask = make_case()
    tf, tm = state.to_torch(f, mask, device="cpu")
    for mod in PORT_WRAPPERS.values():
        with pytest.raises(ValueError, match="mode must be one of"):
            mod.stepk(tf, tm, k_steps=1, mode="collide_only", **KW)
    with pytest.raises(ValueError, match="mode must be one of"):
        d2q9_kstep.check_mode("fast")
    assert [d2q9_kstep.check_mode(m) for m in d2q9_kstep.MODES] == [0, 1, 2]


def test_modes_in_float64_match_the_tpu_kernel():
    f, mask = make_case(seed=7)
    f = f.astype(np.float64)
    with jax.enable_x64(True):
        jf, jt = d2q9_pallas.stepk(jnp.asarray(f), jnp.asarray(mask.astype(np.float64)),
                                   k_steps=2, band=8, interpret=True, mode="stream_only", **KW)
        jf, jt = np.asarray(jf), np.asarray(jt)
    tf, tm = state.to_torch(f, mask, device="cpu")
    pf, pt = d2q9_kstep.stepk_plain(tf, tm, k_steps=2, mode="stream_only", **KW)
    np.testing.assert_array_equal(pf.numpy(), jf)
    assert np.abs(pt.numpy() - jt).max() / np.abs(jt).max() <= 1e-12
