"""The engine loop every K-step wrapper's `run` shares (lbm_tpu_torch.ops.passes),
through each of the seven wrappers' `run` on the CPU, where it runs its
kernel's plain version: a K that does not divide the step count is refused
with one message, and with the NaN checks on (`--debug-nans`,
LBM_TORCH_DEBUG_NANS=1) a NaN in the state raises after the first pass.
"""

import pytest
import torch

from lbm_tpu_torch.ops import (d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual, d3q19_kstep,
                               d3q19_kstep_blocked, d3q19_kstep_inplace,
                               d3q19_kstep_inplace_blocked)
from lbm_tpu_torch.utils import profiling

KW_2D = dict(omega=1.85, accel_w1=1e-4, accel_w2=2.5e-5, accel_row=6)
KW_3D = dict(omega=1.85, density=0.1, accel=0.005, accel_plane=2)
# each kernel's wrapper and its case: state shape, mask shape, physics
WRAPPERS = {
    "B1": (d2q9_kstep_inplace, (9, 8, 16), KW_2D),
    "B2": (d2q9_kstep, (9, 8, 16), KW_2D),
    "B3": (d2q9_kstep_manual, (9, 8, 16), KW_2D),
    "B4": (d3q19_kstep_inplace, (19, 4, 8, 16), KW_3D),
    "B5": (d3q19_kstep_inplace_blocked, (19, 4, 8, 16), KW_3D),
    "B6": (d3q19_kstep, (19, 4, 8, 16), KW_3D),
    "B7": (d3q19_kstep_blocked, (19, 4, 8, 16), KW_3D),
}


@pytest.fixture
def nan_debugging():
    previous = profiling.enable_nan_debugging(True)
    yield
    profiling.enable_nan_debugging(previous)


def case(kernel):
    mod, shape, kw = WRAPPERS[kernel]
    f = torch.full(shape, 0.01, dtype=torch.float32)
    mask = torch.zeros(shape[1:], dtype=torch.bool)
    return mod, f, mask, kw


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_every_wrapper_checks_k_and_nans_in_the_shared_loop(kernel, nan_debugging):
    mod, f, mask, kw = case(kernel)
    with pytest.raises(ValueError, match="num_steps 6 not a multiple of k_steps 4"):
        mod.run(f, mask, num_steps=6, k_steps=4, **kw)
    f_final, tots = mod.run(f.clone(), mask, num_steps=4, k_steps=2, **kw)
    assert tots.shape == (4,) and bool(torch.isfinite(f_final).all())
    f[3, 1, 2] = float("nan")
    with pytest.raises(FloatingPointError,
                       match=r"after steps 1-2 of a K-step pass \(plain version\) \(pass 1\)"):
        mod.run(f, mask, num_steps=4, k_steps=2, **kw)
