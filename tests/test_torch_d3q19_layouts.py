"""The lattice layouts of kernel B6 (`lbm_tpu_torch.ops.d3q19_kstep`,
`layout="qmajor" | "zmajor" | "fused"`) on the CPU, against the JAX Pallas
z-slab kernel's (`lbm_tpu.ops.d3q19_pallas.stepk` / `run`, `layout=`) in
interpret mode, at 8x16x128, bz 4, one cached interpret run per case.

* z-major `stepk`, K = 1, 2 and 4: float32 at the JAX package's own bar for
  its z-major test (rtol 1e-6, atol 1e-8; Sum|u| rtol 1e-6), bfloat16
  within one unit (Sum|u|, float32, 1e-6 relative); the modes
  stream_only, copy and collide_no_roll in float32 at the same bars (copy's
  Sum|u|, zeros in the port and a token in the TPU kernel, not compared).
* z-major `run` (q-major in and out, transposed at entry and exit) and
  `fused` `stepk` / `run` (the q-major state; the TPU kernel's rank-3 view)
  at the same bars.
* in the port, z-major (once transposed) and fused are bit-equal to q-major
  for `stepk_plain`, `stepk` and `run`, the state and Sum|u|.
* an unknown layout, and a state of the wrong rank or shape for its layout,
  raise; the in-place kernel B4 takes no layout.

On the card chip_smoke.py's `phase_layouts_3d` holds the CUDA kernel's
z-major launches bit-equal to its q-major ones; experiments/cuda-kstep-tiles/
wave3d.py `check_paths` does the same on each path and mode at small shapes.
"""

import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lbm_tpu.ops import d3q19_pallas
from lbm_tpu_torch.ops import d3q19_kstep, d3q19_kstep_inplace, d3q19_lattice

SHAPE = (8, 16, 128)
KW = dict(omega=1.85, density=0.1, accel=0.005, accel_plane=6)
BF16 = ml_dtypes.bfloat16
NP_TYPES = {"float32": np.float32, "bfloat16": BF16}
TORCH_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_case(dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    f = d3q19_lattice.initial_distributions(*SHAPE, 0.1, np.float64)
    f = (f * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, f.shape))).astype(NP_TYPES[dtype])
    mask = rng.uniform(size=SHAPE) < 0.05
    mask[0] = mask[-1] = True
    return f, mask


def to_torch(a) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(a).view(np.int16).astype(np.int32)


def zmajor(a):
    return a.transpose(0, 1).contiguous() if isinstance(a, torch.Tensor) else \
        np.ascontiguousarray(np.swapaxes(a, 0, 1))


@functools.lru_cache(maxsize=None)
def pallas_stepk(layout, k, dtype="float32", mode="full"):
    f, mask = make_case(dtype)
    f = zmajor(f) if layout == "zmajor" else f
    jf, jt = d3q19_pallas.stepk(jnp.asarray(f), jnp.asarray(mask.astype(NP_TYPES[dtype])),
                                k_steps=k, bz=4, interpret=True, mode=mode, layout=layout,
                                **KW)
    return np.asarray(jf), np.asarray(jt)


def port_stepk(layout, k, dtype="float32", mode="full"):
    f, mask = make_case(dtype)
    tf = to_torch(zmajor(f) if layout == "zmajor" else f)
    return d3q19_kstep.stepk(tf, torch.from_numpy(mask), k_steps=k, mode=mode, layout=layout,
                             **KW)


def hold_f32(got_f, got_t, want_f, want_t, tot=True):
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=1e-6, atol=1e-8)
    if tot:
        np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_zmajor_stepk_matches_the_tpu_kernel_in_float32(k):
    got_f, got_t = port_stepk("zmajor", k)
    want_f, want_t = pallas_stepk("zmajor", k)
    assert got_f.shape == want_f.shape == (SHAPE[0], 19, *SHAPE[1:])
    hold_f32(got_f, got_t, want_f, want_t)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_zmajor_stepk_within_one_unit_in_bfloat16(k):
    got_f, got_t = port_stepk("zmajor", k, "bfloat16")
    want_f, want_t = pallas_stepk("zmajor", k, "bfloat16")
    assert got_f.dtype == torch.bfloat16 and got_t.dtype == torch.float32
    assert np.abs(bits(got_f) - bits(want_f)).max() <= 1
    np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mode", ["stream_only", "copy", "collide_no_roll"])
def test_zmajor_modes_match_the_tpu_kernel(mode, k):
    got_f, got_t = port_stepk("zmajor", k, mode=mode)
    want_f, want_t = pallas_stepk("zmajor", k, mode=mode)
    hold_f32(got_f, got_t, want_f, want_t, tot=mode != "copy")
    if mode != "collide_no_roll":  # values only move
        np.testing.assert_array_equal(got_f.numpy(), want_f)


@pytest.mark.parametrize("k", [1, 2])
def test_fused_stepk_matches_the_tpu_kernel(k):
    got_f, got_t = port_stepk("fused", k)
    want_f, want_t = pallas_stepk("fused", k)
    assert got_f.shape == want_f.shape == (19, *SHAPE)
    hold_f32(got_f, got_t, want_f, want_t)


@functools.lru_cache(maxsize=None)
def pallas_run(layout):
    f, mask = make_case()
    jf, jt = d3q19_pallas.run(jnp.asarray(f), jnp.asarray(mask.astype(np.float32)),
                              num_steps=4, k_steps=2, bz=4, interpret=True, layout=layout,
                              **KW)
    return np.asarray(jf), np.asarray(jt)


@pytest.mark.parametrize("layout", ["zmajor", "fused"])
def test_run_matches_the_tpu_kernels_run(layout):
    f, mask = make_case()
    got_f, got_t = d3q19_kstep.run(to_torch(f), torch.from_numpy(mask), num_steps=4, k_steps=2,
                                   layout=layout, **KW)
    want_f, want_t = pallas_run(layout)
    assert got_f.shape == (19, *SHAPE) and got_t.shape == (4,)
    hold_f32(got_f, got_t, want_f, want_t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_layouts_bit_equal_to_qmajor_in_the_port(k, dtype):
    f, mask = make_case(dtype, seed=2)
    tf, tm = to_torch(f), torch.from_numpy(mask)
    kw = dict(k_steps=k, **KW)
    q_f, q_t = d3q19_kstep.stepk_plain(tf, tm, **kw)
    for fn in (d3q19_kstep.stepk_plain, d3q19_kstep.stepk):
        z_f, z_t = fn(zmajor(tf), tm, layout="zmajor", **kw)
        assert torch.equal(z_f.transpose(0, 1), q_f) and torch.equal(z_t, q_t)
        u_f, u_t = fn(tf, tm, layout="fused", **kw)
        assert torch.equal(u_f, q_f) and torch.equal(u_t, q_t)
    runs = [d3q19_kstep.run(tf, tm, num_steps=2 * k, k_steps=k, layout=layout, **KW)
            for layout in d3q19_kstep.LAYOUTS]
    for r_f, r_t in runs[1:]:
        assert torch.equal(r_f, runs[0][0]) and torch.equal(r_t, runs[0][1])
    assert torch.equal(to_torch(f), tf)  # run leaves its input alone in every layout


def test_layout_refusals():
    f, mask = make_case()
    tf, tm = to_torch(f), torch.from_numpy(mask)
    kw = dict(k_steps=1, **KW)
    with pytest.raises(ValueError, match="layout must be one of"):
        d3q19_kstep.stepk(tf, tm, layout="ymajor", **kw)
    with pytest.raises(ValueError, match="layout must be one of"):
        d3q19_kstep.run(tf, tm, num_steps=1, layout="ymajor", **KW)
    with pytest.raises(ValueError, match=r"takes a state of shape \(nz, 19, ny, nx\)"):
        d3q19_kstep.stepk(tf, tm, layout="zmajor", **kw)  # a q-major state
    with pytest.raises(ValueError, match=r"takes a state of shape \(19, nz, ny, nx\)"):
        d3q19_kstep.stepk(tf.reshape(19, -1, SHAPE[2]), tm, layout="fused", **kw)  # rank 3
    with pytest.raises(ValueError, match=r"takes a state of shape \(19, nz, ny, nx\)"):
        d3q19_kstep.run(zmajor(tf), tm, num_steps=1, layout="zmajor", **KW)  # run is q-major
    with pytest.raises(TypeError):
        d3q19_kstep_inplace.stepk(tf, tm, layout="zmajor", **kw)
