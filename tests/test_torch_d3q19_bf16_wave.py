"""B4's bfloat16 pass on the wave path against its step path, on the card.

A bfloat16 pass of K > 1 steps through a float32 scratch lattice and rounds
once (csrc/d3q19_kstep.cu): on the step path in K launches, on the wave
path in one (`d3q19_kstep.WavePlan`, rounded). Both take the same steps in
the same order and sum |u| in the same blocks, so the state and Sum|u| must
be equal bit for bit: at 64x128x256, K = 2, 3 and 4, over three passes of
`run`; and on a ragged 5x24x40 grid with a window (valid planes and rows, a
plane offset and a longer global grid, as the sharded slab steps), over
three passes of `stepk`. Each wave pass is one launch of the wave entry.

Needs an NVIDIA card: marked `cuda`, each test skips without one. On the
card, where JAX (which tests/conftest.py imports) is not installed:
`python -m pytest --noconftest -m cuda tests/test_torch_d3q19_bf16_wave.py`.
"""

import numpy as np
import pytest
import torch

from lbm_tpu_torch.core import state
from lbm_tpu_torch.ops import d3q19_kstep, d3q19_kstep_inplace
from lbm_tpu_torch.ops.d3q19_lattice import initial_distributions

pytestmark = pytest.mark.cuda

KW = dict(omega=1.85, density=0.1, accel=0.005)
PASSES = 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")


@pytest.fixture
def wave_calls(monkeypatch):
    """The number of wave entry calls since the test began, in a list."""
    calls = [0]
    launch = d3q19_kstep.wave_launch

    def counted(*args, **kwargs):
        calls[0] += 1
        return launch(*args, **kwargs)

    monkeypatch.setattr(d3q19_kstep, "wave_launch", counted)
    return calls


def make_case(shape, seed):
    """A bfloat16 state perturbed by 20% about rest and a 5% mask, walls on
    the first and last plane, on the card."""
    rng = np.random.default_rng(seed)
    f = initial_distributions(*shape, 0.1, np.float64)
    f = f * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, f.shape))
    mask = rng.uniform(size=shape) < 0.05
    mask[0] = mask[-1] = True
    return state.to_torch3d(f, mask, device="cuda", dtype=torch.bfloat16)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_run_on_the_wave_path_is_bit_equal_to_the_step_path(card, wave_calls, k):
    nz, ny, nx = 64, 128, 256
    f, mask = make_case((nz, ny, nx), seed=k)
    kw = dict(num_steps=PASSES * k, k_steps=k, accel_plane=nz - 2, **KW)
    step = f.clone()
    _, step_tot = d3q19_kstep_inplace.run(step, mask, path="step", **kw)
    assert d3q19_kstep_inplace.last_path == "step" and wave_calls[0] == 0
    d3q19_kstep_inplace.launches = 0
    wave = f.clone()
    _, wave_tot = d3q19_kstep_inplace.run(wave, mask, path="wave", **kw)
    torch.cuda.synchronize()
    assert d3q19_kstep_inplace.last_path == "wave"
    assert d3q19_kstep_inplace.launches == wave_calls[0] == PASSES
    assert wave.dtype == torch.bfloat16 and wave_tot.dtype == torch.float32
    assert torch.equal(wave, step), f"K={k}: the wave path's state differs from the step path's"
    assert torch.equal(wave_tot, step_tot), f"K={k}: Sum|u| differs"
    assert not torch.equal(wave, f)


def test_a_ragged_window_on_the_wave_path_is_bit_equal_to_the_step_path(card, wave_calls):
    shape = (5, 24, 40)  # a block 64 wide (choose_block): edge blocks in every row
    f, mask = make_case(shape, seed=7)
    window = dict(plane_offset=3, valid_planes=(1, 4), valid_rows=(2, 21), global_nz=13,
                  accel_plane=5)
    for k in (2, 3, 4):
        step, wave = f.clone(), f.clone()
        for i in range(PASSES):
            _, step_tot = d3q19_kstep_inplace.stepk(step, mask, k_steps=k, path="step", **window,
                                                    **KW)
            calls = wave_calls[0]
            _, wave_tot = d3q19_kstep_inplace.stepk(wave, mask, k_steps=k, path="wave", **window,
                                                    **KW)
            torch.cuda.synchronize()
            assert d3q19_kstep_inplace.last_path == "wave" and wave_calls[0] == calls + 1
            what = f"5x24x40 K={k} pass {i}"
            assert torch.equal(wave, step), f"{what}: the state differs"
            assert torch.equal(wave_tot, step_tot), f"{what}: Sum|u| differs"
