"""The port's copy of the host data model (lbm_tpu_torch.core.params) against
`lbm_tpu.core.params`: every member of Params and Obstacles the reference
has, `one_minus_omega` and `Obstacles.at` among them, gives the same value on
the same inputs."""

import dataclasses

import numpy as np
import pytest

from lbm_tpu.core.params import Obstacles as JObstacles
from lbm_tpu.core.params import Params as JParams
from lbm_tpu_torch.core.params import Obstacles, Params


@pytest.mark.parametrize("omega", [0.5, 1.0, 1.85, 1.999])
def test_params_members_equal_the_reference(omega):
    p = Params(nx=128, ny=64, max_iters=100, reynolds_dim=10, density=0.1, accel=0.005,
               omega=omega)
    jp = JParams(**dataclasses.asdict(p))
    assert p.one_minus_omega == jp.one_minus_omega == 1.0 - omega
    assert p.viscosity == jp.viscosity


def test_obstacles_at_equals_the_reference():
    mask = np.random.default_rng(7).uniform(size=(9, 13)) < 0.4
    obs, jobs = Obstacles(mask.copy()), JObstacles(mask.copy())
    for y in range(9):
        for x in range(13):
            got = obs.at(x, y)
            assert isinstance(got, bool) and got == jobs.at(x, y) == bool(mask[y, x])
    assert (obs.ny, obs.nx) == (jobs.ny, jobs.nx)
