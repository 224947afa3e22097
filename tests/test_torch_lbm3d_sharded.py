"""The port's 3-D multi-device entry points on gloo ranks, against the JAX
package's on the CPU (its 8 virtual devices).

* The CLI, `cli.lbm3d --device cpu --num-devices 4 --dtype float64` with
  `--engine sharded-cuda` (the CLI starts its own 4 ranks), `--overlap`,
  `sharded-cuda-zy` (`--mesh-shape 2 2` and the default mesh) and `sharded`:
  av_vels_3d.dat and the `--final-state-slice` plane against
  `lbm_tpu.ops.d3q19.simulate` (engine 'jax') in float64, to 1e-12 relative;
  float32 `--engine sharded-cuda` against the JAX CLI's `--engine
  sharded-pallas` on 4 devices (av_vels at 2e-5, the reference's bar).
* `ops.d3q19.simulate(engine='sharded', num_devices=8)` on 8 ranks against
  the JAX package's on 8 devices (float32: the state at 2e-5 / 1e-7 and
  av_vels at 2e-5, the reference's bars; float64 against engine 'jax' to
  1e-12).
* Checkpointed 'sharded-cuda' runs (tests/test_checkpoint_3d.py:95-125's
  cases): a run in chunks equals an uninterrupted one bit for bit; a
  checkpoint written on 2 ranks resumes on 4, the state bit-equal to an
  uninterrupted run and av_vels within 1e-5 (the reference's bar: the
  partial sums of Sum|u| follow the mesh); the checkpoint holds the valid
  planes only.
* `dryrun.dryrun_multichip(4, device='cpu')` runs all eight stages.
* The CLI's and the models' refusals, and no fallback: a sharded run or the
  dry run on CUDA (their default) without CUDA, or with more ranks than
  cards, raises.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lbm_tpu.ops import d3q19 as jd3q19
from lbm_tpu_torch import dryrun
from lbm_tpu_torch.cli import lbm3d as cli
from lbm_tpu_torch.core import io
from lbm_tpu_torch.models import lbm3d
from lbm_tpu_torch.ops import d3q19
from lbm_tpu_torch.parallel import launch

REPO = Path(__file__).resolve().parent.parent
BAR64 = 1e-12
GRID = (24, 16, 32)
STEPS = 8
# (label, CLI flags) of the float64 runs, in one group of 4 ranks
CLI_RUNS = (("overlap", ["--engine", "sharded-cuda", "--overlap"]),
            ("zy", ["--engine", "sharded-cuda-zy", "--mesh-shape", "2", "2"]),
            ("zy-default", ["--engine", "sharded-cuda-zy"]),
            ("sharded", ["--engine", "sharded"]))


def argv(out, *flags, dtype="float64", n=4, grid=GRID, steps=STEPS):
    nz, ny, nx = grid
    return ["--nz", str(nz), "--ny", str(ny), "--nx", str(nx), "-n", str(steps), "--device",
            "cpu", "--num-devices", str(n), "--dtype", dtype, "--out-dir", str(out),
            "--final-state-slice", "mid", *flags]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def jax_f64(nz, ny, nx, steps):
    with jax.enable_x64(True):
        f, av = jd3q19.simulate(nz, ny, nx, num_steps=steps, dtype=np.float64)
        return np.asarray(f), np.asarray(av)


def slice_file(tmp, f):
    """The mid plane of state f in the final_state format, as numbers."""
    nz, ny, nx = f.shape[1:]
    path = tmp / "want_slice.dat"
    lbm3d.write_final_state_slice(path, f, d3q19.default_obstacle_mask(nz, ny, nx), nz // 2, 0.1)
    return np.loadtxt(path)


def hold_cli_f64(out, tmp):
    av = io.read_av_vels(out / "av_vels_3d.dat")
    want_f, want_av = jax_f64(*GRID, STEPS)
    assert av.shape == (STEPS,) and rel(av, want_av) <= BAR64
    got = np.loadtxt(out / f"final_state_3d_z{GRID[0] // 2}.dat")
    assert rel(got, slice_file(tmp, want_f)) <= BAR64


def test_cli_starts_its_ranks_and_matches_jax(tmp_path, capsys):
    assert cli.main(argv(tmp_path / "out", "--engine", "sharded-cuda")) == 0
    text = capsys.readouterr().out
    assert "engine:\t\t\tsharded-cuda" in text and "==done==" in text
    assert "kernel:\t\t\td3q19_kstep_inplace on 19x10x16x32, 2 steps per pass" in text
    assert "mesh:\t\t\t4" in text
    hold_cli_f64(tmp_path / "out", tmp_path)


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """The CLI runs, the checkpointed runs and the resume on another mesh, in
    one group of 2 ranks and then one of 4. Returns ({key: result}, tmp)."""
    tmp = tmp_path_factory.mktemp("ranked")
    ck = dict(num_steps=8, checkpoint_every=2, engine="sharded-cuda", device="cpu")
    first = {"resume-writer": (lbm3d.run_simulation_with_checkpoints, (22, 16, 128), dict(
        ck, num_steps=4, checkpoint_path=tmp / "r.npz", num_devices=2))}
    got = dict(zip(first, launch.run_each(list(first.values()), 2, timeout=300)))
    todo = {label: (cli.main, (argv(tmp / label, *flags),), {}) for label, flags in CLI_RUNS}
    todo["f32"] = (cli.main, (argv(tmp / "f32", "--engine", "sharded-cuda", dtype="float32",
                                   grid=(16, 16, 128)),), {})
    todo["whole"] = (lbm3d.run_simulation_with_checkpoints, (16, 16, 128), dict(
        ck, checkpoint_every=8, checkpoint_path=tmp / "a.npz", num_devices=4))
    todo["chunked"] = (lbm3d.run_simulation_with_checkpoints, (16, 16, 128), dict(
        ck, checkpoint_path=tmp / "b.npz", num_devices=4))
    todo["resume-full"] = (lbm3d.run_simulation_with_checkpoints, (22, 16, 128), dict(
        ck, checkpoint_path=tmp / "f.npz", num_devices=4))
    todo["resumed"] = (lbm3d.run_simulation_with_checkpoints, (22, 16, 128), dict(
        ck, checkpoint_path=tmp / "r.npz", num_devices=4, resume=True))
    todo["cli-ck"] = (cli.main, (argv(tmp / "cli-ck", "--engine", "sharded-cuda",
                                      "--checkpoint-every", "4"),), {})
    got.update(zip(todo, launch.run_each(list(todo.values()), 4, timeout=300)))
    return got, tmp


@pytest.mark.parametrize("label", [label for label, _ in CLI_RUNS] + ["cli-ck"])
def test_cli_engines_match_jax_in_float64(ranked, label):
    results, tmp = ranked
    assert results[label] == 0
    hold_cli_f64(tmp / label, tmp)


def test_cli_float32_matches_the_jax_cli(ranked, tmp_path):
    from lbm_tpu.cli import lbm3d as jcli

    results, tmp = ranked
    assert results["f32"] == 0
    rc = jcli.main(["--nz", "16", "--ny", "16", "--nx", "128", "-n", str(STEPS), "--device",
                    "cpu", "--engine", "sharded-pallas", "--num-devices", "4", "--out-dir",
                    str(tmp_path / "jax")])
    assert rc == 0
    got = io.read_av_vels(tmp / "f32" / "av_vels_3d.dat")
    want = io.read_av_vels(tmp_path / "jax" / "av_vels_3d.dat")
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_checkpointed_runs_are_bit_equal_to_whole_ones(ranked):
    results, tmp = ranked
    f1, av1, _, steps1 = results["whole"]
    f2, av2, _, steps2 = results["chunked"]
    assert steps1 == steps2 == 8 and f1.shape == (19, 16, 16, 128)
    np.testing.assert_array_equal(av1, av2)
    np.testing.assert_array_equal(f1, f2)
    with np.load(tmp / "b.npz") as ck:
        assert int(ck["step"]) == 8
        np.testing.assert_array_equal(ck["f"], f2)


def test_a_checkpoint_resumes_on_another_z_mesh(ranked):
    results, tmp = ranked
    _, av_w, _, steps_w = results["resume-writer"]
    full_f, full_av, _, _ = results["resume-full"]
    f_res, av_res, _, steps_res = results["resumed"]
    assert steps_w == 4 and steps_res == 4
    assert f_res.shape == (19, 22, 16, 128)
    np.testing.assert_array_equal(f_res, full_f)
    np.testing.assert_array_equal(av_res[:4], av_w)
    np.testing.assert_allclose(av_res, full_av, rtol=1e-5, atol=1e-9)
    with np.load(tmp / "r.npz") as ck:
        assert ck["f"].shape == (19, 22, 16, 128) and int(ck["step"]) == 8


@pytest.fixture(scope="module")
def eight():
    calls = [(d3q19.simulate, (16, 16, 32), dict(num_steps=20, engine="sharded", dtype=dtype,
                                                 num_devices=8, device="cpu"))
             for dtype in (torch.float32, torch.float64)]
    return [(f.numpy(), av.numpy()) for f, av in launch.run_each(calls, 8, timeout=300)]


def test_sharded_on_8_ranks_matches_jax(eight):
    f32, f64 = eight
    f_j, av_j = jd3q19.simulate(16, 16, 32, num_steps=20, engine="sharded", num_devices=8)
    np.testing.assert_allclose(f32[0], np.asarray(f_j), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(f32[1], np.asarray(av_j), rtol=2e-5)
    want_f, want_av = jax_f64(16, 16, 32, 20)
    assert rel(f64[0], want_f) <= BAR64 and rel(f64[1], want_av) <= BAR64


def test_dryrun_multichip_runs_every_stage(capsys):
    lines = dryrun.dryrun_multichip(4, device="cpu")
    assert capsys.readouterr().out.splitlines() == lines
    for what in ("mesh 2x2, grid 16x32", "sharded-cuda mesh 2x2 grid 32x256",
                 "OVERLAP row-mesh 4 grid 96x128", "FULL2D overlap mesh 2x2 grid 48x768",
                 "kstep_sharded_3d z-mesh 4 grid 16x8x128",
                 "kstep_sharded_3d overlap z-mesh 4 grid 24x8x128",
                 "ZY-mesh 2x2 grid 10x16x128 k=2 (uneven z)", "UNEVEN grid 66x130",
                 "conv-sharded blur 62x126 ok"):
        assert sum(what in line for line in lines) == 1, what
    assert len(lines) == 9 and all(line.startswith("dryrun_multichip(4): ") for line in lines)


@pytest.mark.parametrize("flags,message", [
    (["--engine", "sharded", "--overlap"], "--overlap applies to --engine sharded-cuda only"),
    (["--engine", "sharded-cuda-zy", "--overlap"], "--overlap applies to --engine sharded-cuda"),
    (["--engine", "sharded-cuda", "--mesh-shape", "2", "1"],
     "--mesh-shape applies to --engine sharded-cuda-zy only"),
    (["--engine", "cuda-inplace", "--num-devices", "2"],
     "--num-devices applies to the multi-device engines only"),
    (["--engine", "sharded-cuda-zy", "--checkpoint-every", "4"],
     "use the z-mesh sharded-cuda engine for checkpointed runs"),
    (["--engine", "sharded", "--resume"], "the implicit 'sharded' engine has no chunked runner"),
    (["--engine", "sharded-cuda", "--overlap", "--checkpoint-every", "4"],
     "--overlap is not supported with checkpointed runs"),
])
def test_cli_refuses_misused_flags(tmp_path, capsys, flags, message):
    with pytest.raises(SystemExit) as err:
        cli.main(["--nz", "8", "--ny", "8", "--nx", "16", "-n", "4", "--device", "cpu",
                  "--out-dir", str(tmp_path / "out"), *flags])
    assert err.value.code != 0
    assert message in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_models_refuse_and_never_fall_back(tmp_path, monkeypatch):
    kw = dict(num_steps=4, device="cpu")
    with pytest.raises(ValueError, match="overlap=True is only implemented"):
        d3q19.simulate(8, 8, 16, engine="sharded-cuda-zy", overlap=True, **kw)
    with pytest.raises(ValueError, match="mesh_shape applies"):
        d3q19.simulate(8, 8, 16, engine="sharded-cuda", mesh_shape=(1, 1), **kw)
    with pytest.raises(ValueError, match="num_devices applies"):
        d3q19.simulate(8, 8, 16, engine="cuda-inplace", num_devices=2, **kw)
    for engine in ("sharded-cuda-zy", "sharded"):
        with pytest.raises(ValueError, match="checkpointing supports"):
            lbm3d.run_simulation_with_checkpoints(
                8, 8, 16, checkpoint_path=tmp_path / "c.npz", checkpoint_every=2,
                engine=engine, **kw)
    with pytest.raises(ValueError, match="unknown multi-device engine"):
        lbm3d.run_simulation_sharded(8, 8, 16, engine="cuda", **kw)
    with pytest.raises(ValueError, match="overlap=True applies"):
        lbm3d.run_simulation_sharded(8, 8, 16, engine="sharded", overlap=True, **kw)
    assert not (tmp_path / "c.npz").exists()
    if not torch.cuda.is_available():
        for engine in d3q19.SHARDED_ENGINES:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                d3q19.simulate(8, 8, 16, num_steps=4, engine=engine)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lbm3d.run_simulation_sharded(8, 8, 16, num_steps=4)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.dryrun_multichip(2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--nz", "8", "--ny", "8", "--nx", "16", "-n", "4", "--engine",
                      "sharded-cuda", "--out-dir", str(tmp_path / "out")])
        assert not (tmp_path / "out").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 CUDA ranks asked for, and this host has 1"):
        d3q19.simulate(8, 8, 16, num_steps=4, engine="sharded-cuda", num_devices=2,
                       device="cuda")
    with pytest.raises(RuntimeError, match="2 CUDA ranks"):
        lbm3d.run_simulation_sharded(8, 8, 16, num_steps=4, num_devices=2, device="cuda")
    with pytest.raises(RuntimeError, match="2 CUDA ranks"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="2 CUDA ranks"):
        lbm3d.run_simulation_with_checkpoints(
            8, 8, 16, num_steps=4, checkpoint_path=tmp_path / "c.npz", checkpoint_every=2,
            engine="sharded-cuda", num_devices=2, device="cuda")


def test_the_dry_run_runs_as_a_module():
    res = subprocess.run([sys.executable, "-m", "lbm_tpu_torch.dryrun", "2", "--device", "cpu"],
                         cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 8 and all(line.startswith("dryrun_multichip(2): ") for line in lines)


def test_select_k_steps_checks_the_plan_for_the_real_shard_count():
    """The reference's rule (tests/test_checkpoint_3d.py:138-150) at the
    port's K: odd nz does not force K = 1 on sharded-cuda (plan_planes pads
    it), an infeasible plan for the real shard count steps K down, and the
    chunking still rules."""
    from lbm_tpu.models import lbm3d as jlbm3d

    assert lbm3d.select_k_steps("sharded-cuda", 4, 2, (7, 8, 16), 2) == 2
    assert jlbm3d.select_k_steps("sharded-pallas", 4, 2, 7, n_shards=2) == 2
    # nz = 7 on 4 shards: K = 2 leaves the last shard < K planes -> K = 1,
    # as the reference steps down
    assert lbm3d.select_k_steps("sharded-cuda", 4, 2, (7, 8, 16), 4) == 1
    assert jlbm3d.select_k_steps("sharded-pallas", 4, 2, 7, n_shards=4) == 1
    assert lbm3d.select_k_steps("sharded-cuda", 4, 3, (8, 8, 16), 2) == 1
    # where the reference stops at 2, the port takes its preferred K
    assert lbm3d.select_k_steps("sharded-cuda", 1200, 1200, (64, 128, 256), 1) == 4
    assert lbm3d.select_k_steps("sharded-cuda", 1200, 1200, (64, 128, 256), 16) == 4
    assert lbm3d.select_k_steps("sharded-cuda", 1200, 1200, (64, 128, 256), 32) == 2
    assert lbm3d.select_k_steps("sharded", 1200, 1200, (64, 128, 256), 4) == 1
