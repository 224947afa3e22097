"""The K-step wrappers of the port (lbm_tpu_torch.ops.d2q9_kstep, kernel B2,
and d2q9_kstep_inplace, kernel B1) on the CPU, against the JAX Pallas
kernels run in interpret mode (lbm_tpu.ops.d2q9_pallas.stepk and
d2q9_pallas_inplace.stepk), as tests/test_d2q9_inplace.py runs them.

On the CPU the wrappers run their kernels' plain version, `stepk_plain`; the
CUDA kernels themselves are held against it on the card by chip_smoke.py.

Tolerances (max abs difference over max abs value), as in
tests/test_torch_d2q9.py: float64 <= 1e-12 on state and Sum|u|; float32
<= 2e-6 on the state and <= 2e-5 on Sum|u| (u is a difference of nearly
equal populations, so one ulp of a population is ~1e-5 of u).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import d2q9_pallas, d2q9_pallas_inplace
from lbm_tpu_torch.core import state
from lbm_tpu_torch.core.params import Params
from lbm_tpu_torch.ops import d2q9, d2q9_kstep, d2q9_kstep_inplace

NY, NX = 32, 128
KW = dict(omega=1.85, accel_w1=0.1 * 0.005 / 9, accel_w2=0.1 * 0.005 / 36)
BARS = {np.float64: (1e-12, 1e-12), np.float32: (2e-6, 2e-5)}  # (state, Sum|u|)
# each port function and the JAX Pallas function it is held against
PAIRS = {
    "stepk_plain": (d2q9_kstep.stepk_plain, d2q9_pallas.stepk),
    "b2": (d2q9_kstep.stepk, d2q9_pallas.stepk),
    "b1": (d2q9_kstep_inplace.stepk, d2q9_pallas_inplace.stepk),
}


def make_case(dtype, seed=0):
    rng = np.random.default_rng(seed)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None]
    f = (0.1 * w * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (9, NY, NX)))).astype(dtype)
    mask = np.zeros((NY, NX), bool)
    mask[NY // 4: NY // 2, NX // 4: NX // 2] = True
    mask[0, :] = True
    return f, mask


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def compare(name, dtype, k, seed=0, **window):
    port_fn, jax_fn = PAIRS[name]
    f, mask = make_case(dtype, seed)
    kw = dict(k_steps=k, accel_row=window.pop("accel_row", NY - 2), **KW, **window)
    with jax.enable_x64(dtype == np.float64):
        jf, jt = jax_fn(jnp.asarray(f), jnp.asarray(mask.astype(dtype)), band=8,
                        interpret=True, **kw)
        jf, jt = np.asarray(jf), np.asarray(jt)
    tf, tm = state.to_torch(f, mask, device="cpu")
    pf, pt = port_fn(tf, tm, **kw)
    assert pt.shape == (k,)
    state_bar, u_bar = BARS[dtype]
    assert rel(pf.numpy(), jf) <= state_bar
    assert rel(pt.numpy(), jt) <= u_bar


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name", list(PAIRS))
def test_stepk_float32_matches_pallas(name, k):
    compare(name, np.float32, k)


@pytest.mark.parametrize("name", list(PAIRS))
def test_stepk_float64_matches_pallas(name):
    compare(name, np.float64, 4, seed=1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(PAIRS))
def test_stepk_ghost_window_matches_pallas(name, dtype):
    """A ghost-extended block: local row r is global row r + 16 of a
    40-row grid, so the accelerated row 2 is local row 26 (42 mod 40), and
    only [4, 28) x [8, 120) counts towards Sum|u|."""
    compare(name, dtype, 2, seed=2, row_offset=16, valid_rows=(4, 28), valid_cols=(8, 120),
            global_ny=40, accel_row=2)


def test_inplace_stepk_overwrites_its_input():
    f, mask = make_case(np.float32)
    tf, tm = state.to_torch(f, mask, device="cpu")
    expected, _ = d2q9_kstep.stepk_plain(tf, tm, k_steps=2, accel_row=NY - 2, **KW)
    out, _ = d2q9_kstep_inplace.stepk(tf, tm, k_steps=2, accel_row=NY - 2, **KW)
    assert out is tf
    assert torch.equal(tf, expected)
    # the two-stream wrapper leaves its input alone
    tf2, _ = state.to_torch(f, mask, device="cpu")
    d2q9_kstep.stepk(tf2, tm, k_steps=2, accel_row=NY - 2, **KW)
    np.testing.assert_array_equal(tf2.numpy(), f)


@pytest.mark.parametrize("mod", [d2q9_kstep, d2q9_kstep_inplace])
def test_run_and_simulate_equal_the_plain_engine(mod):
    """K-step passes of the plain version are K single steps: `run` and
    `simulate` on the CPU equal the plain engine bit for bit."""
    p = Params(nx=NX, ny=NY, max_iters=8, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    _, mask = make_case(np.float64)
    f0, tm = state.to_torch(state.initial_distributions(p, np.float64), mask, device="cpu")
    ref_f, ref_av = d2q9.simulate(p, f0, tm)
    got_f, got_av = mod.simulate(p, f0, tm)
    assert torch.equal(got_f, ref_f) and torch.equal(got_av, ref_av)
    f, _ = state.to_torch(make_case(np.float64)[0], mask, device="cpu")
    ref_f, ref_t = d2q9.run(f, tm, d2q9.accel_row_mask(NY, NX, NY - 2, dtype=f.dtype),
                            num_steps=8, **KW)
    got_f, got_t = mod.run(f.clone(), tm, num_steps=8, k_steps=4, accel_row=NY - 2, **KW)
    assert torch.equal(got_f, ref_f) and torch.equal(got_t, ref_t)
    with pytest.raises(ValueError, match="multiple of k_steps"):
        mod.run(f, tm, num_steps=6, k_steps=4, accel_row=NY - 2, **KW)


@pytest.mark.parametrize("max_iters, k", [(20000, 4), (8, 4), (6, 2), (7, 1)])
def test_simulate_takes_the_largest_k_dividing_max_iters(max_iters, k):
    p = Params(nx=NX, ny=NY, max_iters=max_iters, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    _, mask = make_case(np.float64)
    f0, tm = state.to_torch(state.initial_distributions(p, np.float64), mask, device="cpu")
    seen = {}

    def fake_run(f, mask, *, num_steps, k_steps, **kw):
        seen.update(num_steps=num_steps, k_steps=k_steps)
        return f, torch.ones(num_steps, dtype=f.dtype)

    d2q9_kstep.simulate_with(fake_run, p, f0, tm)
    assert seen == dict(num_steps=max_iters, k_steps=k)


def test_choose_config_and_engine():
    # the flagship grid: the measured 16x32 tile at K=4, in both dtypes
    assert d2q9_kstep.choose_config(1024, 1024, torch.float32) == (16, 32, 4)
    assert d2q9_kstep.choose_config(8, 64, torch.float32) == (8, 32, 4)
    for dtype in (torch.float32, torch.float64):
        th, tw, k = d2q9_kstep.choose_config(1024, 1024, dtype)
        itemsize = torch.empty((), dtype=dtype).element_size()
        assert 1024 % th == 0 and 1024 % tw == 0
        assert d2q9_kstep.smem_bytes(th, tw, k, itemsize) <= d2q9_kstep.SMEM_PER_BLOCK
    # `auto` takes the fastest kernel engine that fits in free memory, B2,
    # on every grid with sides of at least PREFERRED_K, whatever its height
    # mod 8 (unlike lbm_tpu.ops.d2q9_pallas.choose_engine)
    ample = 1 << 40
    assert d2q9_kstep.choose_engine(1024, 1024, free_bytes=ample) == "cuda"
    assert d2q9_kstep.choose_engine(8, 128, free_bytes=ample) == "cuda"  # no 2-band minimum
    assert d2q9_kstep.choose_engine(12, 128, free_bytes=ample) == "cuda"
    assert d2q9_kstep.choose_engine(32, 48, free_bytes=ample) == "cuda"
    assert d2q9_kstep.choose_engine(1024, 1001, free_bytes=ample) == "cuda"
    assert d2q9_kstep.choose_engine(3, 128, free_bytes=ample) == "torch"
    # no candidate divides a 12-row grid: the first tile, with edge tiles
    assert d2q9_kstep.choose_config(12, 128) == (16, 32, 4)


@pytest.mark.parametrize("shape, tile", [
    ((32, 48), (16, 16)),
    ((1000, 1008), (8, 16)),
    ((1024, 1000), (8, 8)),
    ((1024, 1001), (16, 32)),  # no tile divides it: edge tiles
])
def test_choose_config_narrow_widths(shape, tile):
    """Widths that are not a multiple of 32 take a narrower tile that
    divides them, whose sides are still at least K; a width that no tile
    divides takes the first tile, whose last column of tiles is cut."""
    config = d2q9_kstep.choose_config(*shape, torch.float32)
    assert config == (*tile, d2q9_kstep.PREFERRED_K)
    assert min(tile) >= d2q9_kstep.MAX_STEPS_PER_PASS


def test_smem_bytes_formula():
    # two buffers of 9 planes of (th+2K)x(tw+2K) values, 2x8 reduction slots,
    # one mask byte per cell, one flag byte per region row and column
    assert d2q9_kstep.smem_bytes(32, 64, 4, 4) == (2 * 9 * 40 * 72 * 4 + 16 * 4 + 40 * 72
                                                   + 40 + 72)
