"""The port's 3-D checkpointed runner and CLI (lbm_tpu_torch.models.lbm3d,
lbm_tpu_torch.cli.lbm3d) against the JAX package's (lbm_tpu.cli.lbm3d,
lbm_tpu.ops.d3q19), on the CPU: the D3Q19 slice as a whole.

Tolerances: float64 <= 1e-12 relative against the JAX float64 run and
<= 1e-10 against the committed oracle trace (both from the second value on:
the first is 0 on the uniform start state), as tests/test_native_engine.py
compares them; float32 (the JAX CLI's only type) <= 1e-5 of the largest
value, at float32's rounding. Chunked and resumed runs equal uninterrupted
ones bit for bit.
"""

from pathlib import Path

import functools

import jax
import numpy as np
import pytest
import torch

from lbm_tpu.cli import lbm3d as jcli
from lbm_tpu.ops import d3q19 as j3
from lbm_tpu_torch.cli import lbm3d as cli
from lbm_tpu_torch.core import checkpoint, io
from lbm_tpu_torch.models import lbm3d
from lbm_tpu_torch.ops import d3q19, d3q19_kstep, d3q19_kstep_blocked

NZ, NY, NX = 6, 8, 16
GOLDEN = Path(__file__).parent / "data" / "d3q19_16x16x32_200.av_vels.dat"


def test_cli_matches_the_jax_cli(tmp_path, capsys):
    """Same arguments through both CLIs: av_vels_3d.dat and the mid-plane
    final_state file agree at float32's rounding."""
    args = ["--nz", str(NZ), "--ny", str(NY), "--nx", str(NX), "-n", "20", "--device", "cpu",
            "--final-state-slice", "mid"]
    assert jcli.main(args + ["--out-dir", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["--out-dir", str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    assert "engine:\t\t\tcuda-inplace" in out  # the default engine's CPU route
    for line in ("==done==", "Final mean |u|:", "Total compute time:", "Total density:", "MLUPS:"):
        assert out.count(line) == 2  # the same summary block from both
    av = io.read_av_vels(tmp_path / "port" / "av_vels_3d.dat")
    jav = io.read_av_vels(tmp_path / "jax" / "av_vels_3d.dat")
    assert av.shape == jav.shape == (20,)
    assert np.abs(av - jav).max() <= 1e-5 * np.abs(jav).max()
    name = f"final_state_3d_z{NZ // 2}.dat"
    fs = io.read_final_state(tmp_path / "port" / name)
    jfs = io.read_final_state(tmp_path / "jax" / name)
    assert fs.shape == jfs.shape == (NY * NX, 7)
    np.testing.assert_array_equal(fs[:, [0, 1, 6]], jfs[:, [0, 1, 6]])
    for col in (2, 3, 4, 5):
        assert np.abs(fs[:, col] - jfs[:, col]).max() <= 1e-5 * np.abs(jfs[:, 4:6]).max()


@pytest.mark.parametrize("engine", ["torch", "cuda-inplace"])
def test_float64_matches_jax_and_the_golden_anchor(engine):
    """200 steps at 16x16x32 in float64 against the JAX float64 engine and
    the committed oracle trace."""
    _, av = d3q19.simulate(16, 16, 32, num_steps=200, dtype=torch.float64, engine=engine,
                           device="cpu")
    av = av.numpy()
    with jax.enable_x64(True):
        _, jav = j3.simulate(16, 16, 32, num_steps=200, dtype=np.float64)
        jav = np.asarray(jav)
    np.testing.assert_allclose(av[1:], jav[1:], rtol=1e-12)
    golden = np.loadtxt(GOLDEN, usecols=1, delimiter="\t")
    np.testing.assert_allclose(av[1:], golden[1:], rtol=1e-10)


@functools.lru_cache(maxsize=None)
def jax_blocked_route():
    """Two steps at 4x256x256 through the JAX package's 'pallas-inplace'
    engine, which routes 256x256 planes to its blocked kernel (interpret mode
    on the CPU), as tests/test_d3q19_inplace_blocked.py runs it."""
    _, av = j3.simulate(4, 256, 256, num_steps=2, engine="pallas-inplace", k_steps=2)
    return np.asarray(av)


@pytest.mark.parametrize("engine", ["cuda-inplace-blocked", "cuda-blocked", "cuda-inplace",
                                    "cuda"])
def test_cli_blocked_shape_matches_the_jax_blocked_route(engine, tmp_path, capsys):
    """The 256x256-plane shape through the port's CLI and every kernel engine
    against the JAX package's blocked route, at float32's rounding."""
    assert cli.main(["--nz", "4", "--ny", "256", "--nx", "256", "-n", "2", "--device", "cpu",
                     "--engine", engine, "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"engine:\t\t\t{engine}\n" in out
    kind = "blocked" if engine.endswith("-blocked") else "slab"
    assert f"kernel:\t\t\t{kind}, 2 steps per pass\n" in out
    assert out.index("kernel:") < out.index("==done==")
    av = io.read_av_vels(tmp_path / "av_vels_3d.dat")
    np.testing.assert_allclose(av, jax_blocked_route(), rtol=1e-4, atol=1e-7)


def test_cli_prints_no_kernel_for_the_plain_engine(tmp_path, capsys):
    assert cli.main(["--nz", "4", "--ny", "4", "--nx", "8", "-n", "3", "--device", "cpu",
                     "--engine", "torch", "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "engine:\t\t\ttorch\n" in out and "kernel:" not in out


@pytest.mark.parametrize("engine", ["torch", "cuda", "cuda-inplace", "cuda-blocked",
                                    "cuda-inplace-blocked"])
def test_chunked_and_resumed_equal_uninterrupted(engine, tmp_path):
    ck = tmp_path / "ck3d.npz"
    ref_f, ref_av = d3q19.simulate(NZ, NY, NX, num_steps=12, engine=engine, device="cpu")
    kw = dict(checkpoint_path=ck, checkpoint_every=4, engine=engine, device="cpu")
    f6, av6, _, ran = lbm3d.run_simulation_with_checkpoints(NZ, NY, NX, num_steps=8, **kw)
    assert ran == 8 and av6.shape == (8,) and av6.dtype == np.float64
    assert checkpoint.load3d(ck).step == 8
    f, av, _, ran = lbm3d.run_simulation_with_checkpoints(NZ, NY, NX, num_steps=12, resume=True,
                                                          **kw)
    assert ran == 4
    np.testing.assert_array_equal(f, ref_f.numpy())
    np.testing.assert_array_equal(av, ref_av.numpy().astype(np.float64))
    assert not list(tmp_path.glob("*.tmp*"))  # the atomic write left nothing behind
    # a second resume has nothing left to run
    _, av2, _, ran = lbm3d.run_simulation_with_checkpoints(NZ, NY, NX, num_steps=12, resume=True,
                                                           **kw)
    assert ran == 0
    np.testing.assert_array_equal(av2, av)


def test_resume_refuses_another_run(tmp_path):
    ck = tmp_path / "ck3d.npz"
    kw = dict(checkpoint_path=ck, checkpoint_every=3, engine="cuda-inplace", device="cpu")
    lbm3d.run_simulation_with_checkpoints(NZ, NY, NX, num_steps=3, **kw)  # K=1: 3 is odd
    with pytest.raises(ValueError, match="beyond the requested"):
        lbm3d.run_simulation_with_checkpoints(NZ, NY, NX, num_steps=2, resume=True,
                                              **{**kw, "checkpoint_every": 2})
    with pytest.raises(ValueError, match="not a multiple of k_steps"):
        lbm3d.run_simulation_with_checkpoints(NZ, NY, NX, num_steps=8, resume=True,
                                              **{**kw, "checkpoint_every": 4})
    with pytest.raises(ValueError, match="checkpoint grid"):
        lbm3d.run_simulation_with_checkpoints(NZ, NY, NX * 2, num_steps=6, resume=True, **kw)
    with pytest.raises(ValueError, match="checkpoint physics"):
        lbm3d.run_simulation_with_checkpoints(NZ, NY, NX, num_steps=6, resume=True, omega=1.7,
                                              **kw)
    with pytest.raises(ValueError, match="divisible by k_steps"):
        lbm3d.run_simulation_with_checkpoints(NZ, NY, NX, num_steps=6, k_steps=2, **kw)
    with pytest.raises(ValueError, match="unknown engine"):
        lbm3d.run_simulation_with_checkpoints(NZ, NY, NX, num_steps=6,
                                              **{**kw, "engine": "pallas"})


@pytest.mark.parametrize("num_steps, every", [(1200, 300), (1200, 75), (9, 3), (600, 300), (7, 7)])
def test_select_k_steps_divides_steps_and_chunk(num_steps, every):
    for engine in ("cuda", "cuda-inplace"):
        k = lbm3d.select_k_steps(engine, num_steps, every)
        assert 1 <= k <= d3q19_kstep.MAX_K
        assert num_steps % k == 0 and every % k == 0
        # the preferred K where it divides both, else of those K the one at
        # which B4 costs the least a step
        ms = d3q19_kstep.pass_ms(torch.float32, "b4")
        ks = [j for j in range(1, d3q19_kstep.MAX_K + 1) if num_steps % j == 0 and every % j == 0]
        assert k == (d3q19_kstep.PREFERRED_K if d3q19_kstep.PREFERRED_K in ks
                     else min(ks, key=lambda j: ms[j - 1] / j))
    assert lbm3d.select_k_steps("torch", num_steps, every) == 1
    for engine in ("cuda-blocked", "cuda-inplace-blocked"):
        k = lbm3d.select_k_steps(engine, num_steps, every)
        assert k == d3q19_kstep_blocked.choose_k(num_steps, every)
        assert num_steps % k == 0 and every % k == 0


def test_cli_checkpoint_flags(tmp_path, capsys):
    base = ["--nz", str(NZ), "--ny", str(NY), "--nx", str(NX), "--device", "cpu",
            "--dtype", "float64", "--checkpoint-every", "4"]
    assert cli.main(base + ["-n", "8", "--out-dir", str(tmp_path / "ck")]) == 0
    assert (tmp_path / "ck" / "checkpoint_3d.npz").exists()
    assert cli.main(base + ["-n", "16", "--resume", "--out-dir", str(tmp_path / "ck")]) == 0
    assert cli.main(["--nz", str(NZ), "--ny", str(NY), "--nx", str(NX), "--device", "cpu",
                     "--dtype", "float64", "-n", "16", "--out-dir", str(tmp_path / "un")]) == 0
    assert "Time (this run, incl. checkpoints)" in capsys.readouterr().out
    assert ((tmp_path / "ck" / "av_vels_3d.dat").read_bytes()
            == (tmp_path / "un" / "av_vels_3d.dat").read_bytes())
    assert len(io.read_av_vels(tmp_path / "ck" / "av_vels_3d.dat")) == 16


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the no-CUDA behaviour cannot be observed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--nz", "4", "--ny", "4", "--nx", "8", "-n", "2",
                  "--out-dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        d3q19.simulate(4, 4, 8, num_steps=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lbm3d.run_simulation_with_checkpoints(4, 4, 8, num_steps=2, checkpoint_every=2,
                                              checkpoint_path=tmp_path / "ck.npz")
    assert not (tmp_path / "ck.npz").exists()


def test_final_state_slice_fields_conventions():
    rng = np.random.default_rng(5)
    f = d3q19.initial_distributions(NZ, NY, NX, 0.1, np.float64)
    f = f * (1.0 + 0.2 * rng.uniform(-1, 1, f.shape))
    mask = d3q19.default_obstacle_mask(NZ, NY, NX)
    mask[3, 2:4, 5:9] = True
    u_x, u_y, u, pressure, obs = lbm3d.final_state_slice_fields(f, mask, 3, 0.1)
    assert obs.sum() == 8 and (u[obs] == 0).all() and (u_x[obs] == 0).all()
    np.testing.assert_allclose(pressure[obs], 0.1 / 3.0, rtol=1e-15)
    rho = f[:, 3].sum(axis=0)
    np.testing.assert_allclose(pressure[~obs], rho[~obs] / 3.0, rtol=1e-14)
    assert (u[~obs] >= np.hypot(u_x, u_y)[~obs] - 1e-18).all()  # |u| includes u_z
