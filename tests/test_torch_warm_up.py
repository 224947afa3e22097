"""run_simulation's warm-up run (lbm_tpu_torch.models.lbm): one pass of the
K the timed run takes (`d2q9_kstep.choose_k`), through the same engine, on
the same start state and mask, before the timed run; the result is the
timed run's alone. Run on the CPU, where the kernel engines take their
plain version.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lbm_tpu_torch.core import state
from lbm_tpu_torch.core.params import Obstacles, Params
from lbm_tpu_torch.models import lbm
from lbm_tpu_torch.ops import d2q9, d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual

# the module of each engine's simulate
MODULES = {"torch": d2q9, "cuda": d2q9_kstep, "cuda-inplace": d2q9_kstep_inplace,
           "cuda-manual": d2q9_kstep_manual}
ENGINES = ("torch", "cuda", "cuda-inplace", "cuda-manual", "auto")
# step counts at K = 4, 2, 1 and a run of one step
STEPS = {20: 4, 6: 2, 7: 1, 1: 1}


def case(steps):
    p = Params(nx=16, ny=12, max_iters=steps, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    mask = np.zeros((12, 16), bool)
    mask[0] = mask[-1] = True
    mask[3:9, 6] = True
    return p, Obstacles(mask)


@pytest.mark.parametrize("steps", sorted(STEPS))
@pytest.mark.parametrize("engine", ENGINES)
def test_warm_up_is_one_pass_of_the_timed_runs_k(monkeypatch, engine, steps):
    assert d2q9_kstep.choose_k(steps) == STEPS[steps]
    calls = []
    for name, mod in MODULES.items():
        def spy(params, f, mask, name=name, real=mod.simulate):
            calls.append((name, params, f, mask))
            return real(params, f, mask)
        monkeypatch.setattr(mod, "simulate", spy)
    p, obstacles = case(steps)
    res = lbm.run_simulation(p, obstacles, engine=engine, device="cpu")
    assert engine == "auto" or res.engine == engine
    assert len(calls) == 2
    (warm_name, warm_p, warm_f, warm_mask), (name, timed_p, f, mask) = calls
    assert warm_name == name == res.engine
    assert warm_p == dataclasses.replace(p, max_iters=min(steps, STEPS[steps]))
    assert timed_p == p
    assert warm_f is f and warm_mask is mask
    assert res.av_vels.shape == (steps,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("steps", sorted(STEPS))
@pytest.mark.parametrize("engine", ENGINES)
def test_result_is_one_direct_simulate_bit_for_bit(engine, steps, dtype):
    p, obstacles = case(steps)
    res = lbm.run_simulation(p, obstacles, engine=engine, dtype=dtype, device="cpu")
    f0, mask = state.to_torch(state.initial_distributions(p, lbm.host_dtype(dtype)),
                              obstacles.mask, device="cpu")
    f, av = MODULES[res.engine].simulate(p, f0, mask)
    want_f = state.host_state(f)
    if dtype == torch.bfloat16:
        assert res.f_final.dtype == torch.bfloat16 and torch.equal(res.f_final, want_f)
    else:
        assert res.f_final.dtype == want_f.dtype and np.array_equal(res.f_final, want_f)
    assert np.array_equal(res.av_vels, av.double().numpy())


def test_choose_k_is_the_k_of_simulate_with():
    p, obstacles = case(0)
    f0, mask = state.to_torch(state.initial_distributions(p, np.float64), obstacles.mask,
                              device="cpu")
    for n in range(65):
        seen = {}

        def fake_run(f, mask, *, num_steps, k_steps, **kw):
            seen.update(num_steps=num_steps, k_steps=k_steps)
            return f, torch.ones(num_steps, dtype=f.dtype)

        d2q9_kstep.simulate_with(fake_run, dataclasses.replace(p, max_iters=n), f0, mask)
        k = d2q9_kstep.choose_k(n)
        assert seen == dict(num_steps=n, k_steps=k), n
        assert n % k == 0 and k <= d2q9_kstep.PREFERRED_K
        assert 2 * k > d2q9_kstep.PREFERRED_K or n % (2 * k)
