"""Checkpoint/resume in the port (lbm_tpu_torch.core.checkpoint, the 2-D
runner lbm_tpu_torch.models.lbm.run_simulation_with_checkpoints and the
CLI's flags) on the CPU, and its exchange with the JAX package: a checkpoint
written by either package loads in the other and resumes there.

Chunked and resumed runs equal uninterrupted ones bit for bit. A run that
crosses packages is held to <= 1e-12 relative in float64 (both engines do
the same operations in the same grouping).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.core import checkpoint as jcheckpoint
from lbm_tpu.core.params import Obstacles as JObstacles
from lbm_tpu.core.params import Params as JParams
from lbm_tpu.models import lbm as jlbm
from lbm_tpu.models import lbm3d as jlbm3d
from lbm_tpu_torch.cli import lbm as cli
from lbm_tpu_torch.core import checkpoint, io
from lbm_tpu_torch.core.params import Obstacles, Params
from lbm_tpu_torch.models import lbm, lbm3d

NY, NX = 16, 32


def small_case(steps=16):
    p = Params(nx=NX, ny=NY, max_iters=steps, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    mask = np.zeros((NY, NX), bool)
    mask[0, :] = mask[-1, :] = True
    mask[5:9, 10:13] = True
    return p, Obstacles(mask)


def to_jax(p, obstacles):
    return JParams(**dataclasses.asdict(p)), JObstacles(obstacles.mask.copy())


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("engine", ["torch", "cuda", "cuda-inplace", "auto"])
def test_chunked_and_resumed_equal_uninterrupted(engine, tmp_path):
    p, obs = small_case()
    ck = tmp_path / "ck.npz"
    ref = lbm.run_simulation(p, obs, engine=engine, device="cpu")
    kw = dict(checkpoint_path=ck, checkpoint_every=4, engine=engine, device="cpu")
    half = lbm.run_simulation_with_checkpoints(p, obs, num_steps=8, **kw)
    assert half.steps_run == 8 and half.av_vels.shape == (8,)
    loaded = checkpoint.load(ck, expect=p)
    assert loaded.step == 8 and loaded.k_steps == (None if engine == "torch" else 4)
    res = lbm.run_simulation_with_checkpoints(p, obs, resume=True, **kw)
    assert res.steps_run == 8 and res.engine == ref.engine
    np.testing.assert_array_equal(res.av_vels, ref.av_vels)
    np.testing.assert_array_equal(res.f_final, ref.f_final)
    assert res.reynolds == ref.reynolds and res.total_density == ref.total_density
    assert not list(tmp_path.glob("*.tmp*"))  # the atomic write left nothing behind


def test_resume_continues_at_the_writers_k(tmp_path):
    """A checkpoint written at K=2 resumes at K=2 even where 4 would divide,
    and an explicit other K is refused, as in the reference."""
    p, obs = small_case()
    ck = tmp_path / "ck.npz"
    kw = dict(checkpoint_path=ck, engine="cuda-inplace", device="cpu")
    lbm.run_simulation_with_checkpoints(p, obs, num_steps=6, checkpoint_every=6, **kw)
    assert checkpoint.load(ck).k_steps == 2
    seen = []
    run = lbm.d2q9_kstep_inplace.run

    def spy(*args, **kwargs):
        seen.append(kwargs["k_steps"])
        return run(*args, **kwargs)

    lbm.d2q9_kstep_inplace.run = spy
    try:
        lbm.run_simulation_with_checkpoints(p, obs, num_steps=16, checkpoint_every=4, resume=True,
                                            **{**kw, "checkpoint_path": tmp_path / "other.npz"})
        assert set(seen) == {4}  # no checkpoint there: a fresh run at the preferred K
        seen.clear()
        res = lbm.run_simulation_with_checkpoints(p, obs, num_steps=14, checkpoint_every=4,
                                                  resume=True, **kw)
    finally:
        lbm.d2q9_kstep_inplace.run = run
    assert set(seen) == {2} and res.steps_run == 8
    with pytest.raises(ValueError, match="written at k_steps=2"):
        lbm.run_simulation_with_checkpoints(p, obs, checkpoint_every=4, resume=True, k_steps=4,
                                            **kw)
    with pytest.raises(ValueError, match="beyond the requested"):
        lbm.run_simulation_with_checkpoints(p, obs, num_steps=4, checkpoint_every=4, resume=True,
                                            **kw)
    with pytest.raises(ValueError, match="divisible by k_steps"):
        lbm.run_simulation_with_checkpoints(p, obs, checkpoint_every=3, k_steps=2,
                                            **{**kw, "checkpoint_path": tmp_path / "new.npz"})
    with pytest.raises(ValueError, match="does not match"):
        lbm.run_simulation_with_checkpoints(dataclasses.replace(p, omega=1.7), obs,
                                            checkpoint_every=4, resume=True, **kw)


def test_save_and_load_keep_the_reference_fields(tmp_path):
    p, _ = small_case()
    rng = np.random.default_rng(0)
    f, av = rng.random((9, NY, NX)), rng.random(5)
    checkpoint.save(tmp_path / "a.npz", f, av, 5, p, k_steps=4)
    jcheckpoint.save(tmp_path / "b.npz", f, av, 5, JParams(**dataclasses.asdict(p)), k_steps=4)
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    f3 = rng.random((19, 4, 6, 8))
    checkpoint.save3d(tmp_path / "a3.npz", f3, av, 5, omega=1.85, density=0.1, accel=0.005)
    jcheckpoint.save3d(tmp_path / "b3.npz", f3, av, 5, omega=1.85, density=0.1, accel=0.005)
    with np.load(tmp_path / "a3.npz") as a, np.load(tmp_path / "b3.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    with pytest.raises(ValueError, match="3-D"):
        checkpoint.load(tmp_path / "a3.npz")
    with pytest.raises(ValueError, match="not a 3-D"):
        checkpoint.load3d(tmp_path / "a.npz")


def test_2d_checkpoints_cross_load_and_resume(tmp_path):
    """JAX writes, the port resumes; the port writes, JAX resumes: both end
    where an uninterrupted float64 run of either ends."""
    p, obs = small_case()
    jp, jobs = to_jax(p, obs)
    with jax.enable_x64(True):
        ref = jlbm.run_simulation(jp, jobs, dtype=jnp.float64, engine="jax")
        jlbm.run_simulation_with_checkpoints(
            jp, jobs, dtype=jnp.float64, engine="jax", num_steps=8, checkpoint_every=4,
            checkpoint_path=tmp_path / "from_jax.npz")
    ck = checkpoint.load(tmp_path / "from_jax.npz", expect=p)
    assert ck.step == 8 and ck.f.dtype == np.float64 and ck.k_steps is None
    res = lbm.run_simulation_with_checkpoints(
        p, obs, dtype=torch.float64, engine="cuda-inplace", checkpoint_every=4, resume=True,
        checkpoint_path=tmp_path / "from_jax.npz", device="cpu")
    assert res.steps_run == 8 and res.av_vels.shape == (16,)
    assert rel(res.av_vels, ref.av_vels) <= 1e-12 and rel(res.f_final, ref.f_final) <= 1e-12

    lbm.run_simulation_with_checkpoints(
        p, obs, dtype=torch.float64, engine="torch", num_steps=8, checkpoint_every=4,
        checkpoint_path=tmp_path / "from_port.npz", device="cpu")
    jck = jcheckpoint.load(tmp_path / "from_port.npz", expect=jp)
    assert jck.step == 8 and jck.k_steps is None
    with jax.enable_x64(True):
        jres = jlbm.run_simulation_with_checkpoints(
            jp, jobs, dtype=jnp.float64, engine="jax", checkpoint_every=4, resume=True,
            checkpoint_path=tmp_path / "from_port.npz")
    assert jres.steps_run == 8
    assert rel(jres.av_vels, ref.av_vels) <= 1e-12 and rel(jres.f_final, ref.f_final) <= 1e-12


def test_3d_checkpoints_cross_load_and_resume(tmp_path):
    nz, ny, nx = 6, 8, 16
    with jax.enable_x64(True):
        ref_f, ref_av, _, _ = jlbm3d.run_simulation_with_checkpoints(
            nz, ny, nx, num_steps=12, checkpoint_every=12, dtype=np.float64, engine="jax",
            checkpoint_path=tmp_path / "ref.npz")
        jlbm3d.run_simulation_with_checkpoints(
            nz, ny, nx, num_steps=6, checkpoint_every=3, dtype=np.float64, engine="jax",
            checkpoint_path=tmp_path / "from_jax.npz")
    assert checkpoint.load3d(tmp_path / "from_jax.npz", expect_shape=(nz, ny, nx)).step == 6
    f, av, _, ran = lbm3d.run_simulation_with_checkpoints(
        nz, ny, nx, num_steps=12, checkpoint_every=2, dtype=torch.float64, engine="cuda-inplace",
        resume=True, checkpoint_path=tmp_path / "from_jax.npz", device="cpu")
    assert ran == 6 and av.shape == (12,)
    assert rel(av, ref_av) <= 1e-12 and rel(f, ref_f) <= 1e-12

    lbm3d.run_simulation_with_checkpoints(
        nz, ny, nx, num_steps=6, checkpoint_every=2, dtype=torch.float64, engine="cuda",
        checkpoint_path=tmp_path / "from_port.npz", device="cpu")
    assert jcheckpoint.load3d(tmp_path / "from_port.npz").step == 6
    with jax.enable_x64(True):
        jf, jav, _, jran = jlbm3d.run_simulation_with_checkpoints(
            nz, ny, nx, num_steps=12, checkpoint_every=3, dtype=np.float64, engine="jax",
            resume=True, checkpoint_path=tmp_path / "from_port.npz")
    assert jran == 6
    assert rel(jav, ref_av) <= 1e-12 and rel(jf, ref_f) <= 1e-12


@pytest.mark.parametrize("engine", ["cuda-blocked", "cuda-inplace-blocked"])
def test_3d_blocked_engines_chunk_resume_and_hand_over(engine, tmp_path):
    """A chunked and resumed run of a blocked engine equals an uninterrupted
    one bit for bit; so does one that another engine resumes at another K
    (the 3-D checkpoint records no K: the state does not depend on it), and
    the JAX package loads the checkpoint."""
    from lbm_tpu_torch.ops import d3q19

    nz, ny, nx = 6, 8, 16
    ref_f, ref_av = d3q19.simulate(nz, ny, nx, num_steps=12, engine=engine, device="cpu")
    kw = dict(checkpoint_every=4, engine=engine, device="cpu")
    lbm3d.run_simulation_with_checkpoints(nz, ny, nx, num_steps=8,
                                          checkpoint_path=tmp_path / "a.npz", **kw)
    assert jcheckpoint.load3d(tmp_path / "a.npz").step == 8
    (tmp_path / "b.npz").write_bytes((tmp_path / "a.npz").read_bytes())
    f, av, _, ran = lbm3d.run_simulation_with_checkpoints(
        nz, ny, nx, num_steps=12, resume=True, checkpoint_path=tmp_path / "a.npz", **kw)
    assert ran == 4
    np.testing.assert_array_equal(f, ref_f.numpy())
    np.testing.assert_array_equal(av, ref_av.numpy().astype(np.float64))
    f, av, _, ran = lbm3d.run_simulation_with_checkpoints(
        nz, ny, nx, num_steps=12, resume=True, checkpoint_path=tmp_path / "b.npz",
        checkpoint_every=1, engine="cuda", k_steps=1, device="cpu")
    assert ran == 4
    np.testing.assert_array_equal(f, ref_f.numpy())
    np.testing.assert_array_equal(av, ref_av.numpy().astype(np.float64))


def test_cli_checkpoint_flags(tmp_path, capsys):
    p, obs = small_case()
    p.to_file(tmp_path / "input.params")
    obs.to_file(tmp_path / "obstacles.dat")
    base = ["--params", str(tmp_path / "input.params"), "--obstacles",
            str(tmp_path / "obstacles.dat"), "--device", "cpu"]
    ck_args = base + ["--out-dir", str(tmp_path / "ck"), "--checkpoint-every", "4"]
    assert cli.main(ck_args + ["--num-steps", "8"]) == 0
    assert (tmp_path / "ck" / "checkpoint.npz").exists()
    assert len(io.read_av_vels(tmp_path / "ck" / "av_vels.dat")) == 8
    assert cli.main(ck_args + ["--resume"]) == 0
    assert cli.main(base + ["--out-dir", str(tmp_path / "un")]) == 0
    assert "MLUPS:" in capsys.readouterr().out
    for name in ("av_vels.dat", "final_state.dat"):
        assert (tmp_path / "ck" / name).read_bytes() == (tmp_path / "un" / name).read_bytes()
    # --checkpoint names another file; --resume alone runs in one chunk
    assert cli.main(base + ["--out-dir", str(tmp_path / "one"), "--resume",
                            "--checkpoint", str(tmp_path / "elsewhere" / "c.npz")]) == 0
    assert checkpoint.load(tmp_path / "elsewhere" / "c.npz").step == 16
