"""The frozen references: against the committed float64 3-D trace, against
the program at small sizes on the CPU, and their FLOP count."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.reference import d2q9, d3q19

from conftest import REPO

GOLDEN_3D = REPO / "tests" / "data" / "d3q19_16x16x32_200.av_vels.dat"
CONFIGS = REPO / "benchmark" / "configs"


def rest_3d(nz, ny, nx, dtype=torch.float64):
    w = torch.tensor(d3q19.W, dtype=torch.float64)[:, None, None, None]
    return (0.1 * w * torch.ones((19, nz, ny, nx), dtype=torch.float64)).to(dtype)


def walls(nz, ny, nx):
    mask = np.zeros((nz, ny, nx), bool)
    mask[0] = mask[-1] = True
    return mask


def test_d3q19_matches_the_committed_float64_trace():
    golden = np.loadtxt(GOLDEN_3D, usecols=1, delimiter="\t")
    _, av = d3q19.solve(rest_3d(16, 16, 32), walls(16, 16, 32), steps=200, omega=1.85,
                        density=0.1, accel=0.005, storage=torch.float64, store_every=1,
                        device="cpu")
    np.testing.assert_allclose(av.numpy()[1:], golden[1:], rtol=1e-12)


def _load_mask():
    from benchmark import harness

    drv = harness.driver(REPO / "benchmark", "d2q9_job")
    cfg = json.loads((CONFIGS / "d2q9-cavity-1024.json").read_text())
    return drv.load_mask(CONFIGS / cfg["mask"], cfg["ny"], cfg["nx"]), cfg


def test_d2q9_agrees_with_the_program_in_float64_on_the_golden_geometry():
    """A short float64 run of the flagship's geometry: the reference and the
    program's plain engine agree to rounding."""
    from lbm_tpu_torch.core.params import Obstacles, Params
    from lbm_tpu_torch.models.lbm import run_simulation

    mask, cfg = _load_mask()
    steps = 6
    p = Params(nx=cfg["nx"], ny=cfg["ny"], max_iters=steps, reynolds_dim=cfg["reynolds_dim"],
               density=cfg["density"], accel=cfg["accel"], omega=cfg["omega"])
    prog = run_simulation(p, Obstacles(mask), dtype=torch.float64, engine="torch", device="cpu")
    f, av = d2q9.solve(ny=p.ny, nx=p.nx, steps=steps, density=p.density, accel=p.accel,
                       omega=p.omega, mask=mask, storage=torch.float64, store_every=1,
                       device="cpu")
    np.testing.assert_allclose(av.numpy(), prog.av_vels, rtol=1e-12)
    np.testing.assert_allclose(f.numpy(), prog.f_final, rtol=0, atol=1e-15)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d2q9_steps_as_the_programs_passes_do(dtype):
    """Float32 steps, bfloat16 stored once a K=4 pass: the reference's state
    equals the program's (its kernels' plain version on the CPU) bit for
    bit on a small grid with a barrier."""
    from lbm_tpu_torch.core.params import Obstacles, Params
    from lbm_tpu_torch.models.lbm import run_simulation

    mask = np.zeros((24, 40), bool)
    mask[0] = mask[-1] = True
    mask[:, 0] = mask[:, -1] = True
    mask[1:-1, 13] = True
    p = Params(nx=40, ny=24, max_iters=48, reynolds_dim=10, density=0.1, accel=0.01, omega=1.85)
    prog = run_simulation(p, Obstacles(mask), dtype=dtype, engine="cuda", device="cpu")
    f, av = d2q9.solve(ny=24, nx=40, steps=48, density=0.1, accel=0.01, omega=1.85, mask=mask,
                       storage=dtype, store_every=4, device="cpu")
    prog_f = prog.f_final if isinstance(prog.f_final, torch.Tensor) else torch.from_numpy(
        prog.f_final)
    assert torch.equal(f, prog_f)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d3q19_steps_as_the_programs_passes_do(dtype):
    from lbm_tpu_torch.ops import d3q19 as prog

    g = torch.Generator().manual_seed(5)
    f0 = (rest_3d(8, 6, 10) * (1 + 0.01 * (2 * torch.rand((19, 8, 6, 10), generator=g,
                                                             dtype=torch.float64) - 1)))
    f0 = f0.to(dtype)
    mask = walls(8, 6, 10)
    pf, _ = prog.advance(f0.clone(), torch.from_numpy(mask), num_steps=16,
                         engine="cuda-inplace", omega=1.85, density=0.1, accel=0.005)
    f, _ = d3q19.solve(f0, mask, steps=16, omega=1.85, density=0.1, accel=0.005, storage=dtype,
                       store_every=4, device="cpu")
    assert torch.equal(f, pf)


class Count(TorchDispatchMode):
    """Elementwise arithmetic by its output's elements; a sum by its
    input's."""

    ARITH = {"add", "sub", "mul", "div", "neg", "sqrt", "rsub"}

    def __init__(self):
        super().__init__()
        self.flop = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        if name in self.ARITH:
            self.flop += out.numel()
        elif name == "sum":
            self.flop += args[0].numel()
        return out


def test_d2q9_flop_per_update():
    ny, nx, steps = 12, 20, 3
    mask = np.zeros((ny, nx), bool)
    mask[0] = mask[-1] = True
    step = d2q9.make_step(torch.from_numpy(mask), omega=1.85, w1=1e-4, w2=2.5e-5, row=ny - 2,
                          dtype=torch.float32)
    f = d2q9.initial_state(ny, nx, 0.1, torch.float32, "cpu")
    with Count() as count:
        for _ in range(steps):
            f, _ = step(f)
    assert count.flop == steps * (d2q9.FLOP_PER_UPDATE * ny * nx + d2q9.ROW_FLOP * nx)


def test_d3q19_flop_per_update():
    nz, ny, nx, steps = 6, 4, 5, 2
    step = d3q19.make_step(torch.from_numpy(walls(nz, ny, nx)), omega=1.85, density=0.1,
                           accel=0.005, plane=nz - 2, dtype=torch.float32)
    f = rest_3d(nz, ny, nx, torch.float32)
    with Count() as count:
        for _ in range(steps):
            f, _ = step(f)
    assert count.flop == steps * (d3q19.FLOP_PER_UPDATE * nz * ny * nx
                                  + d3q19.PLANE_FLOP * ny * nx)
