"""The D3Q19 K-step wrappers of the port (lbm_tpu_torch.ops.d3q19_kstep,
kernel B6, and d3q19_kstep_inplace, kernel B4) on the CPU, against the JAX
Pallas z-slab kernels run in interpret mode (lbm_tpu.ops.d3q19_pallas.stepk
and d3q19_pallas_inplace.stepk), as tests/test_d3q19_pallas.py and
tests/test_d3q19_inplace.py run them, at their sizes.

On the CPU the wrappers run their kernels' plain version, `stepk_plain`; the
CUDA kernels themselves are held against it on the card by chip_smoke.py.

Tolerances (max abs difference over max abs value): float32 <= 1e-5 on state
and Sum|u|. The Pallas kernels keep Sum|u| in float32 and do not run in
float64, so the float64 case holds the wrappers to K steps of the JAX engine
`lbm_tpu.ops.d3q19.run` instead, at <= 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import d3q19 as j3
from lbm_tpu.ops import d3q19_pallas, d3q19_pallas_inplace
from lbm_tpu_torch.core import state
from lbm_tpu_torch.ops import d3q19, d3q19_kstep, d3q19_kstep_inplace, d3q19_lattice

NZ, NY, NX = 8, 8, 128
KW = dict(omega=1.85, density=0.1, accel=0.005)
# each port function and the JAX Pallas function it is held against
PAIRS = {
    "stepk_plain": (d3q19_kstep.stepk_plain, d3q19_pallas.stepk),
    "b6": (d3q19_kstep.stepk, d3q19_pallas.stepk),
    "b4": (d3q19_kstep_inplace.stepk, d3q19_pallas_inplace.stepk),
}


def make_case(dtype, seed=0, shape=(NZ, NY, NX)):
    rng = np.random.default_rng(seed)
    f = d3q19_lattice.initial_distributions(*shape, 0.1, np.float64)
    f = (f * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, f.shape))).astype(dtype)
    mask = rng.uniform(size=shape) < 0.05
    mask[0] = mask[-1] = True
    return f, mask


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@functools.lru_cache(maxsize=None)
def pallas_result(jax_fn, seed, kw_items):
    """One interpret-mode run of a Pallas kernel, shared by the port
    functions that are held against it."""
    f, mask = make_case(np.float32, seed)
    jf, jt = jax_fn(jnp.asarray(f), jnp.asarray(mask.astype(np.float32)), bz=4,
                    interpret=True, **dict(kw_items))
    return np.asarray(jf), np.asarray(jt)


def compare_float32(name, k, seed=0, **window):
    port_fn, jax_fn = PAIRS[name]
    f, mask = make_case(np.float32, seed)
    kw = dict(k_steps=k, accel_plane=window.pop("accel_plane", NZ - 2), **KW, **window)
    jf, jt = pallas_result(jax_fn, seed, tuple(sorted(kw.items())))
    tf, tm = state.to_torch3d(f, mask, device="cpu")
    pf, pt = port_fn(tf, tm, **kw)
    assert pt.shape == (k,)
    assert rel(pf.numpy(), jf) <= 1e-5
    assert rel(pt.numpy(), jt) <= 1e-5


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", list(PAIRS))
def test_stepk_float32_matches_pallas(name, k):
    compare_float32(name, k)


@pytest.mark.parametrize("name", list(PAIRS))
def test_stepk_ghost_window_matches_pallas(name):
    """A ghost-extended block: local plane p is global plane p + 4 of a
    16-plane grid, so the accelerated plane 8 is local plane 4, more than K
    planes from both ends (where the TPU kernels' unwrapped halo test and the
    whole-array step agree), and only planes [2, 6) x rows [2, 6) count."""
    compare_float32(name, 2, seed=2, plane_offset=4, valid_planes=(2, 6), valid_rows=(2, 6),
                    global_nz=16, accel_plane=8)


@pytest.mark.parametrize("name", list(PAIRS))
def test_stepk_float64_matches_the_jax_engine(name):
    port_fn, _ = PAIRS[name]
    f, mask = make_case(np.float64, seed=1)
    with jax.enable_x64(True):
        amask = j3.accel_plane_mask(NZ, NY, NX, NZ - 2, dtype=np.float64)
        jf, jt = j3.run(jnp.asarray(f), jnp.asarray(mask), amask, num_steps=3, **KW)
        jf, jt = np.asarray(jf), np.asarray(jt)
    tf, tm = state.to_torch3d(f, mask, device="cpu")
    pf, pt = port_fn(tf, tm, k_steps=3, accel_plane=NZ - 2, **KW)
    assert pf.dtype == torch.float64 and pt.dtype == torch.float64
    assert rel(pf.numpy(), jf) <= 1e-12
    assert rel(pt.numpy(), jt) <= 1e-12


def test_inplace_stepk_overwrites_its_input():
    f, mask = make_case(np.float32)
    tf, tm = state.to_torch3d(f, mask, device="cpu")
    expected, _ = d3q19_kstep.stepk_plain(tf, tm, k_steps=2, accel_plane=NZ - 2, **KW)
    ptr = tf.data_ptr()
    out, _ = d3q19_kstep_inplace.stepk(tf, tm, k_steps=2, accel_plane=NZ - 2, **KW)
    assert out is tf and tf.data_ptr() == ptr
    assert torch.equal(tf, expected)
    # the two-stream wrapper leaves its input alone, and so does the in-place
    # one for a caller that hands it a copy
    tf2, _ = state.to_torch3d(f, mask, device="cpu")
    d3q19_kstep.stepk(tf2, tm, k_steps=2, accel_plane=NZ - 2, **KW)
    d3q19_kstep_inplace.stepk(tf2.clone(), tm, k_steps=2, accel_plane=NZ - 2, **KW)
    np.testing.assert_array_equal(tf2.numpy(), f)


@pytest.mark.parametrize("mod", [d3q19_kstep, d3q19_kstep_inplace])
def test_run_equals_the_plain_engine(mod):
    """K-step passes of the plain version are K single steps: `run` on the
    CPU equals the plain engine bit for bit, at every K."""
    f, mask = make_case(np.float64, shape=(6, 8, 16))
    tf, tm = state.to_torch3d(f, mask, device="cpu")
    amask = d3q19.accel_plane_mask(6, 8, 16, 4, dtype=tf.dtype)
    ref_f, ref_t = d3q19.run(tf, tm, amask, num_steps=12, **KW)
    for k in (1, 2, 3, 4):
        got_f, got_t = mod.run(tf.clone(), tm, num_steps=12, k_steps=k, accel_plane=4, **KW)
        assert torch.equal(got_f, ref_f) and torch.equal(got_t, ref_t)
    with pytest.raises(ValueError, match="multiple of k_steps"):
        mod.run(tf, tm, num_steps=7, k_steps=2, accel_plane=4, **KW)


@pytest.mark.parametrize("num_steps, k", [(1200, 4), (6000, 4), (7, 1), (1, 1), (6, 2), (9, 3)])
def test_choose_k_divides_the_steps(num_steps, k):
    """PREFERRED_K where it divides the steps, else the K dividing them at
    which B4 costs the least a step: 6 steps run at K = 2, where K = 3 would
    pay B4's swap."""
    assert d3q19_kstep.choose_k(num_steps) == k
    assert d3q19_kstep_inplace.choose_k(num_steps) == k
    assert num_steps % k == 0
    # a chunk of 3 steps leaves K=3 where the total allows it, else K=1
    assert d3q19_kstep.choose_k(num_steps, 3) == (3 if num_steps % 3 == 0 else 1)
    assert 1 <= d3q19_kstep.PREFERRED_K <= d3q19_kstep.MAX_K
    # the in-place kernel pays a swap after an odd K
    assert d3q19_kstep.PREFERRED_K % 2 == 0
    # at the grid of PATH_MS the preferred K ties with the cheapest a step
    ms = d3q19_kstep.pass_ms(torch.float32, "b4")
    per_step = [ms[j - 1] / j for j in range(1, d3q19_kstep.MAX_K + 1)]
    assert per_step[d3q19_kstep.PREFERRED_K - 1] <= 1.02 * min(per_step)


@pytest.mark.parametrize("nx, block", [(256, (256, 1, 1)), (512, (256, 1, 1)), (128, (128, 2, 1)), (100, (128, 2, 1)),
                                       (64, (64, 4, 1)), (16, (32, 8, 1))])
def test_choose_block(nx, block):
    assert d3q19_kstep.choose_block(nx) == block
    bx, by, bz = block
    assert bx * by * bz <= d3q19_kstep.MAX_THREADS_PER_BLOCK and (bx * by * bz) % 32 == 0


def test_coefficients_are_those_of_collide_fields():
    omo, wo0, wo1, wo2, fw1, fw2 = d3q19_kstep.coefficients(1.85, 0.1, 0.005)
    w = d3q19_lattice.W
    assert omo == 1.0 - 1.85
    assert (wo0, wo1, wo2) == (float(w[0]) * 1.85, float(w[1]) * 1.85, float(w[7]) * 1.85)
    assert (fw1, fw2) == (0.1 * 0.005 * float(w[1]), 0.1 * 0.005 * float(w[7]))


@pytest.mark.parametrize("mod", [d3q19_kstep, d3q19_kstep_inplace])
def test_kernel_path_checks_its_arguments(mod):
    """A tensor that is not on the CPU goes to the kernel's checks (never to
    the plain version), which refuse what the kernel does not take."""
    f = torch.empty((19, 4, 8, 32), device="meta")
    mask = torch.empty((4, 8, 32), dtype=torch.bool, device="meta")
    before = mod.launches
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        mod.stepk(f, mask, k_steps=2, accel_plane=2, **KW)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        mod.run(f, mask, num_steps=4, k_steps=2, accel_plane=2, **KW)
    assert mod.launches == before
