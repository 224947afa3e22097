"""The port's driver and CLI (lbm_tpu_torch.models.lbm, lbm_tpu_torch.cli.lbm)
against the JAX package's (lbm_tpu.models.lbm), on the CPU.

Tolerance: float64, <= 1e-12 relative (max abs difference over max abs
value) on av_vels and on the final state — both engines do the same
operations in the same grouping, so only last-bit contraction differences
of XLA remain. Output files must be byte-identical for the same arrays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.core.params import Obstacles as JObstacles
from lbm_tpu.core.params import Params as JParams
from lbm_tpu.models import lbm as jlbm
from lbm_tpu_torch.cli import lbm as cli
from lbm_tpu_torch.core import io
from lbm_tpu_torch.core.params import Obstacles, Params
from lbm_tpu_torch.models import lbm

NY, NX = 32, 64


def flagship_like(steps=40):
    p = Params(nx=NX, ny=NY, max_iters=steps, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    mask = np.zeros((NY, NX), bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    mask[10:20, 24:28] = True
    return p, Obstacles(mask)


def to_jax(p, obstacles):
    return JParams(**dataclasses.asdict(p)), JObstacles(obstacles.mask.copy())


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_run_simulation_auto_matches_jax_float64():
    p, obs = flagship_like()
    res = lbm.run_simulation(p, obs, engine="auto", dtype=torch.float64, device="cpu")
    assert res.engine == "cuda"  # the kernel engine's CPU route (memory counts as ample)
    with jax.enable_x64(True):
        jres = jlbm.run_simulation(*to_jax(p, obs), engine="jax", dtype=jnp.float64)
    assert res.av_vels.shape == (40,) and res.f_final.dtype == np.float64
    assert rel(res.av_vels, jres.av_vels) <= 1e-12
    assert rel(res.f_final, jres.f_final) <= 1e-12
    assert res.reynolds == pytest.approx(jres.reynolds, rel=1e-12)
    assert res.total_density == pytest.approx(jres.total_density, rel=1e-12)


@pytest.mark.parametrize("engine", ["torch", "cuda", "cuda-inplace"])
def test_engines_agree_on_the_cpu(engine):
    """Every engine runs on the CPU; the kernel engines' plain route is K
    plain steps, so all three give the same bits."""
    p, obs = flagship_like(steps=8)
    ref = lbm.run_simulation(p, obs, engine="torch", device="cpu")
    res = lbm.run_simulation(p, obs, engine=engine, device="cpu")
    np.testing.assert_array_equal(res.av_vels, ref.av_vels)
    np.testing.assert_array_equal(res.f_final, ref.f_final)


def test_unknown_engine_and_dtype_rejected():
    p, obs = flagship_like(steps=4)
    with pytest.raises(ValueError, match="unknown engine"):
        lbm.run_simulation(p, obs, engine="pallas", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        lbm.run_simulation(p, obs, dtype=torch.float16, device="cpu")


def test_write_outputs_byte_identical_to_jax(tmp_path):
    p, obs = flagship_like()
    rng = np.random.default_rng(11)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None]
    f = 0.1 * w * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (9, NY, NX)))
    av = rng.uniform(1e-5, 1e-2, 40)
    for dtype in (np.float64, np.float32):
        fd = f.astype(dtype)
        ours = lbm.LbmResult(f_final=fd, av_vels=av, compute_seconds=1.0, reynolds=1.0,
                             total_density=1.0, engine="torch")
        theirs = jlbm.LbmResult(f_final=fd, av_vels=av, compute_seconds=1.0, reynolds=1.0,
                                total_density=1.0)
        a = lbm.write_outputs(ours, p, obs, tmp_path / f"port_{dtype.__name__}")
        b = jlbm.write_outputs(theirs, *to_jax(p, obs), tmp_path / f"jax_{dtype.__name__}")
        for pa, pb in zip(a, b):
            assert pa.name == pb.name
            assert pa.read_bytes() == pb.read_bytes()
    # %.12E keeps 13 significant digits
    np.testing.assert_allclose(io.read_av_vels(a[0]), av, rtol=1e-12)


def test_cli_on_params_and_obstacles_files(tmp_path, capsys):
    p, obs = flagship_like(steps=12)
    p.to_file(tmp_path / "input.params")
    obs.to_file(tmp_path / "obstacles.dat")
    rc = cli.main(["--params", str(tmp_path / "input.params"),
                   "--obstacles", str(tmp_path / "obstacles.dat"),
                   "--device", "cpu", "--dtype", "float64", "--out-dir", str(tmp_path / "out")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "engine:\t\t\t\tcuda\n" in out and "==done==" in out and "MLUPS:" in out
    av = io.read_av_vels(tmp_path / "out" / "av_vels.dat")
    ref = lbm.run_simulation(p, obs, dtype=torch.float64, device="cpu", engine="torch")
    np.testing.assert_array_equal(av, np.asarray([float(f"{v:.12E}") for v in ref.av_vels]))
    fs = io.read_final_state(tmp_path / "out" / "final_state.dat")
    assert fs.shape == (NY * NX, 7)
    assert int(fs[:, 6].sum()) == obs.num_blocked
