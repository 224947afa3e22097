"""The port's multi-device entry points on gloo ranks, against the JAX
package's on the CPU.

* The CLI, `--engine sharded|sharded-cuda --device cpu --num-devices 4
  --dtype float64` (the CLI starts its own 4 ranks): av_vels.dat and the
  final state against `lbm_tpu.models.lbm.run_simulation_sharded` on 4 of
  the JAX package's 8 virtual CPU devices with x64, to 1e-12 relative; the
  `--partition-json` file byte for byte against the JAX CLI's.
* Checkpointed sharded runs ('sharded' with ppermute and implicit,
  'sharded-cuda'): N steps in two chunks, resumed to 2N, equal an
  uninterrupted 2N run bit for bit (av_vels and state).
* conv-sharded (`models.blur.run_blur`) equals the conv engine bit for bit,
  float32 and bfloat16.
The last two run in one group of 4 ranks (`parallel.launch.run_each`).
* The CLI's and the models' refusals, and no fallback: a sharded run on
  CUDA without CUDA, or with more ranks than cards, raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.cli import lbm as jcli
from lbm_tpu.core.params import Obstacles as JObstacles
from lbm_tpu.core.params import Params as JParams
from lbm_tpu.models import lbm as jlbm
from lbm_tpu_torch.cli import blur as blur_cli
from lbm_tpu_torch.cli import lbm as cli
from lbm_tpu_torch.core import io
from lbm_tpu_torch.core.params import Obstacles, Params
from lbm_tpu_torch.models import blur, lbm
from lbm_tpu_torch.parallel import launch

NY, NX = 64, 128
BAR = 1e-12
CK_STEPS = 16  # the checkpointed runs: 16 steps in chunks of 8, resumed to 32
CK_ENGINES = (("sharded", "ppermute"), ("sharded", "implicit"), ("sharded-cuda", None))


def case(steps=24):
    p = Params(nx=NX, ny=NY, max_iters=steps, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    mask = np.zeros((NY, NX), bool)
    mask[0, :] = mask[-1, :] = True
    mask[20:30, 40:46] = True
    mask[NY // 2, ::3] = True  # on the row-block boundary of a 4-row mesh
    return p, Obstacles(mask)


def write_case(tmp_path, p, obs):
    p.to_file(tmp_path / "p.params")
    obs.to_file(tmp_path / "o.dat")
    return ["--params", str(tmp_path / "p.params"), "--obstacles", str(tmp_path / "o.dat")]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("engine,jax_engine", [("sharded", "sharded"),
                                               ("sharded-cuda", "sharded-pallas")])
def test_cli_matches_jax_run_simulation_sharded(tmp_path, capsys, engine, jax_engine):
    p, obs = case()
    files = write_case(tmp_path, p, obs)
    rc = cli.main(files + ["--engine", engine, "--device", "cpu", "--num-devices", "4",
                           "--dtype", "float64", "--out-dir", str(tmp_path / "out"),
                           "--partition-json", str(tmp_path / "part.json")])
    assert rc == 0
    text = capsys.readouterr().out
    assert f"engine:\t\t\t\t{engine}" in text and "==done==" in text
    av = io.read_av_vels(tmp_path / "out" / "av_vels.dat")
    fs = np.loadtxt(tmp_path / "out" / "final_state.dat")

    with jax.enable_x64(True):
        jres = jlbm.run_simulation_sharded(JParams(**dataclasses.asdict(p)),
                                           JObstacles(obs.mask.copy()), dtype=jnp.float64,
                                           engine=jax_engine, num_devices=4)
    assert av.shape == (24,)
    assert rel(av, jres.av_vels) <= BAR
    jlbm.write_outputs(jres, JParams(**dataclasses.asdict(p)), JObstacles(obs.mask.copy()),
                       tmp_path / "jax")
    jfs = np.loadtxt(tmp_path / "jax" / "final_state.dat")
    assert rel(fs, jfs) <= BAR

    # the JAX CLI's partition file for the same grid and device count
    rc = jcli.main(files + ["--engine", "jax", "--device", "cpu", "--num-steps", "1",
                            "--num-devices", "4", "--out-dir", str(tmp_path / "jcli"),
                            "--partition-json", str(tmp_path / "jax_part.json")])
    assert rc == 0
    assert (tmp_path / "part.json").read_bytes() == (tmp_path / "jax_part.json").read_bytes()


def rgba_case(h=40, w=150):
    return np.random.default_rng(3).integers(0, 256, size=(h, w, 4), dtype=np.uint8)


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """The checkpointed runs and the conv-sharded blurs, in one group of 4
    ranks. Returns {key: result}."""
    tmp = tmp_path_factory.mktemp("ck")
    p, obs = case(steps=2 * CK_STEPS)
    todo = {}
    for engine, strategy in CK_ENGINES:
        kw = dict(engine=engine, dtype=torch.float64, num_devices=4, device="cpu",
                  checkpoint_every=CK_STEPS // 2, checkpoint_path=tmp / f"{engine}{strategy}.npz",
                  strategy=strategy)
        todo[(engine, strategy, "first")] = (lbm.run_simulation_with_checkpoints, (p, obs),
                                             dict(kw, num_steps=CK_STEPS))
        todo[(engine, strategy, "resumed")] = (lbm.run_simulation_with_checkpoints, (p, obs),
                                               dict(kw, resume=True))
        todo[(engine, strategy, "whole")] = (lbm.run_simulation_sharded, (p, obs), dict(
            engine=engine, strategy=strategy, dtype=torch.float64, num_devices=4, device="cpu"))
    for dtype in (torch.float32, torch.bfloat16):
        todo[("conv-sharded", dtype)] = (blur.run_blur, (rgba_case(),), dict(
            num_iters=3, engine="conv-sharded", dtype=dtype, num_devices=4, device="cpu"))
    got = launch.run_each(list(todo.values()), 4, timeout=240)
    return dict(zip(todo, got)), tmp


@pytest.mark.parametrize("engine,strategy", CK_ENGINES)
def test_checkpointed_sharded_runs_resume_bit_equal(ranked, engine, strategy):
    results, tmp = ranked
    first = results[(engine, strategy, "first")]
    resumed = results[(engine, strategy, "resumed")]
    whole = results[(engine, strategy, "whole")]
    assert first.av_vels.shape == (CK_STEPS,) and resumed.steps_run == CK_STEPS
    np.testing.assert_array_equal(resumed.av_vels, whole.av_vels)
    np.testing.assert_array_equal(resumed.f_final, whole.f_final)
    np.testing.assert_array_equal(resumed.av_vels[:CK_STEPS], first.av_vels)
    with np.load(tmp / f"{engine}{strategy}.npz") as ck:
        assert int(ck["step"]) == 2 * CK_STEPS
        assert int(ck["k_steps"]) == (4 if engine == "sharded-cuda" else 0)
        np.testing.assert_array_equal(ck["f"], whole.f_final)
    # and the single-device plain engine, in float64
    p, obs = case(steps=2 * CK_STEPS)
    ref = lbm.run_simulation(p, obs, engine="torch", dtype=torch.float64, device="cpu")
    assert rel(whole.f_final, ref.f_final) <= BAR and rel(whole.av_vels, ref.av_vels) <= BAR


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_sharded_equals_conv(ranked, dtype):
    got = ranked[0][("conv-sharded", dtype)]
    want = blur.run_blur(rgba_case(), num_iters=3, engine="conv", dtype=dtype, device="cpu")
    assert got.engine == "conv-sharded"
    np.testing.assert_array_equal(got.state, want.state)
    np.testing.assert_array_equal(got.rgba, want.rgba)


@pytest.mark.parametrize("flags,message", [
    (["--engine", "sharded", "--overlap"], "--overlap applies to --engine sharded-cuda only"),
    (["--engine", "sharded-cuda", "--overlap", "--checkpoint-every", "4"],
     "--overlap is not supported with checkpointed runs"),
    (["--engine", "torch", "--strategy", "naive"], "--strategy applies to --engine sharded"),
    (["--engine", "torch", "--num-devices", "2"], "--num-devices applies to the sharded"),
])
def test_cli_refuses_misused_flags(tmp_path, capsys, flags, message):
    files = write_case(tmp_path, *case())
    with pytest.raises(SystemExit) as err:
        cli.main(files + ["--device", "cpu", "--out-dir", str(tmp_path / "out"), *flags])
    assert err.value.code != 0
    assert message in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_models_refuse_and_never_fall_back(monkeypatch):
    p, obs = case(steps=4)
    with pytest.raises(ValueError, match="applies to --engine sharded only"):
        lbm.run_simulation_sharded(p, obs, engine="sharded-cuda", strategy="naive", device="cpu")
    with pytest.raises(ValueError, match="overlap=True applies"):
        lbm.run_simulation_sharded(p, obs, engine="sharded", overlap=True, device="cpu")
    with pytest.raises(ValueError, match="unknown sharded engine"):
        lbm.run_simulation_sharded(p, obs, engine="cuda", device="cpu")
    with pytest.raises(ValueError, match="num_devices applies"):
        blur.run_blur(rgba_case(), engine="conv", num_devices=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lbm.run_simulation_sharded(p, obs, engine="sharded-cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            blur.run_blur(rgba_case(), engine="conv-sharded")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 CUDA ranks asked for, and this host has 1"):
        launch.check_world(2, "cuda")
    with pytest.raises(RuntimeError, match="2 CUDA ranks"):
        lbm.run_simulation_sharded(p, obs, engine="sharded", num_devices=2, device="cuda")


def test_blur_cli_refuses_num_devices_without_conv_sharded(tmp_path, capsys):
    from lbm_tpu_torch.utils import image as img_lib

    img_lib.save_png(tmp_path / "in.png", rgba_case())
    with pytest.raises(SystemExit):
        blur_cli.main(["-i", str(tmp_path / "in.png"), "-o", str(tmp_path / "out.png"),
                       "--device", "cpu", "--num-devices", "2"])
    assert "--num-devices applies to --engine conv-sharded only" in capsys.readouterr().err
    assert not (tmp_path / "out.png").exists()
