"""The port's native serial engines (ops/d2q9_native.py, ops/d3q19_native.py)
against the JAX package.

The port builds its own library from native/*.cpp with g++ (the flags of
native/Makefile) into build/lbm_tpu_torch/native/; in this process the
reference's library (native/liblbmio.so) loads beside it, so both come from
this host's compiler and are held bit for bit. Then, after
tests/test_native_engine.py: f64 against the JAX engine (1e-12), f32 in its
rounding class, chunked runs bit-identical to whole ones, the guarded first
acceleration, randomised states, the CLIs' `--engine native` and checkpointed
runs resumed bit-equal. Params and obstacle files are written into tmp_path
from numpy seeds.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import d2q9 as ref_d2q9
from lbm_tpu.ops import d3q19 as ref_d3q19
from lbm_tpu_torch.cli import lbm as cli
from lbm_tpu_torch.cli import lbm3d as cli3d
from lbm_tpu_torch.core import io, state
from lbm_tpu_torch.core.params import Obstacles, Params
from lbm_tpu_torch.models import lbm as lbm_model
from lbm_tpu_torch.models import lbm3d as lbm3d_model
from lbm_tpu_torch.ops import d2q9, d2q9_native, d3q19, d3q19_native
from lbm_tpu_torch.utils import native_io

ANCHOR_3D = Path(__file__).parent / "data" / "d3q19_16x16x32_200.av_vels.dat"


@pytest.fixture(scope="module", autouse=True)
def port_library():
    if not d2q9_native.available():
        pytest.skip(f"no C++ toolchain: {native_io.last_build_error}")


@pytest.fixture(scope="module")
def ref_native():
    # imported here, not at collection: its first use builds native/ with make
    from lbm_tpu.ops import d2q9_native as ref

    if not ref.available():
        pytest.skip("the reference's native library cannot be built")
    return ref


def case(tmp_path, n=60, seed=0, ny=24, nx=40):
    """Params and an obstacle file (seeded blocks and single cells) written
    into tmp_path and read back."""
    rng = np.random.default_rng(seed)
    p = Params(nx=nx, ny=ny, max_iters=n, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    mask = rng.random((ny, nx)) < 0.06
    mask[5:9, 10:14] = True
    p.to_file(tmp_path / "p.params")
    Obstacles(mask).to_file(tmp_path / "o.dat")
    p = Params.from_file(tmp_path / "p.params")
    return p, Obstacles.from_file(tmp_path / "o.dat", p)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bit_equal_to_the_reference_native_engine(tmp_path, ref_native, dtype):
    p, obs = case(tmp_path)
    f0 = state.initial_distributions(p, dtype)
    f_ref, av_ref = ref_native.simulate(p, f0.copy(), obs.mask)
    f, av = d2q9_native.simulate(p, torch.from_numpy(f0), obs.mask)
    assert np.array_equal(f, f_ref) and np.array_equal(av, av_ref)
    # run() and first_accelerate() advance a numpy state in place, like the reference's
    aw = d2q9.AccelWeights.from_params(p)
    kw = dict(num_steps=7, omega=p.omega, accel_w1=aw.w1, accel_w2=aw.w2, accel_row=p.ny - 2)
    a, b = f0.copy(), f0.copy()
    assert np.array_equal(d2q9_native.run(a, obs.mask, **kw), ref_native.run(b, obs.mask, **kw))
    assert np.array_equal(a, b)


def test_f64_agrees_with_the_jax_engine(tmp_path):
    p, obs = case(tmp_path, n=100)
    f0 = state.initial_distributions(p, np.float64)
    fn, avn = d2q9_native.simulate(p, f0, obs.mask)
    with jax.enable_x64(True):
        fj, avj = ref_d2q9.simulate(p, jnp.asarray(f0), jnp.asarray(obs.mask))
        fj, avj = np.asarray(fj), np.asarray(avj)
    np.testing.assert_allclose(avn, avj, rtol=1e-12)
    np.testing.assert_allclose(fn, fj, rtol=1e-11, atol=1e-16)


def test_f32_same_rounding_class_as_the_jax_engine(tmp_path):
    p, obs = case(tmp_path, n=100)
    f0 = state.initial_distributions(p, np.float32)
    fn, avn = d2q9_native.simulate(p, f0, obs.mask)
    fj, avj = ref_d2q9.simulate(p, jnp.asarray(f0), jnp.asarray(obs.mask))
    np.testing.assert_allclose(avn, np.asarray(avj, np.float64), rtol=1e-4)
    np.testing.assert_allclose(fn, np.asarray(fj), rtol=2e-4, atol=1e-9)


def test_chunked_runs_bit_identical(tmp_path):
    p, obs = case(tmp_path)
    aw = d2q9.AccelWeights.from_params(p)
    kw = dict(omega=p.omega, accel_w1=aw.w1, accel_w2=aw.w2, accel_row=p.ny - 2)
    f_one = state.initial_distributions(p, np.float64)
    f_chunk = f_one.copy()
    tot_one = d2q9_native.run(f_one, obs.mask, num_steps=40, **kw)
    tots = [d2q9_native.run(f_chunk, obs.mask, num_steps=10, **kw) for _ in range(4)]
    assert np.array_equal(np.concatenate(tots), tot_one)
    assert np.array_equal(f_chunk, f_one)


def test_first_accelerate_guard_matches_jax(tmp_path):
    p, obs = case(tmp_path, n=1)
    f0 = state.initial_distributions(p, np.float64)
    # cells that fail the positivity guard
    f0[3, p.ny - 2, ::3] = 1e-6
    f0[6, p.ny - 2, 1::5] = 1e-7
    aw = d2q9.AccelWeights.from_params(p)
    f_native = f0.copy()
    d2q9_native.first_accelerate(f_native, obs.mask, accel_row=p.ny - 2, accel_w1=aw.w1,
                                 accel_w2=aw.w2)
    with jax.enable_x64(True):
        f_jax = np.asarray(ref_d2q9.first_accelerate(
            jnp.asarray(f0), jnp.asarray(obs.mask), accel_row=p.ny - 2, accel_w1=aw.w1,
            accel_w2=aw.w2))
    assert np.array_equal(f_native, f_jax)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomised_state_parity_with_jax(seed):
    """Equilibrium + 1% perturbation + random obstacles: the native and JAX
    engines agree step for step at f64."""
    rng = np.random.default_rng(seed)
    ny, nx = 24, 40
    rho = 0.1 * (1 + 0.01 * rng.standard_normal((ny, nx)))
    u_x = 0.01 * rng.standard_normal((ny, nx))
    u_y = 0.01 * rng.standard_normal((ny, nx))
    f0 = d2q9.equilibrium(torch.from_numpy(rho), torch.from_numpy(u_x),
                          torch.from_numpy(u_y)).numpy()
    mask = rng.random((ny, nx)) < 0.1
    mask[ny - 2] = False  # keep the accelerated row free
    omega, w1, w2 = 1.85, 1e-4, 2.5e-5
    f_nat = f0.copy()
    tot_nat = d2q9_native.run(f_nat, mask, num_steps=20, omega=omega, accel_w1=w1,
                              accel_w2=w2, accel_row=ny - 2)
    with jax.enable_x64(True):
        amask = ref_d2q9.accel_row_mask(ny, nx, ny - 2, dtype=jnp.float64)
        f_jax, tot_jax = ref_d2q9.run(jnp.asarray(f0), jnp.asarray(mask), amask, num_steps=20,
                                      omega=omega, accel_w1=w1, accel_w2=w2)
    np.testing.assert_allclose(tot_nat, np.asarray(tot_jax), rtol=1e-12)
    np.testing.assert_allclose(f_nat, np.asarray(f_jax), rtol=1e-10, atol=1e-18)


def test_cli_engine_native_and_a_checkpointed_run(tmp_path, capsys):
    p, obs = case(tmp_path, n=30)
    files = ["--params", str(tmp_path / "p.params"), "--obstacles", str(tmp_path / "o.dat"),
             "--engine", "native", "--dtype", "float64"]
    # the default --device is cuda: the native engine never asks for it
    assert cli.main(files + ["--out-dir", str(tmp_path / "whole")]) == 0
    assert "engine:\t\t\t\tnative" in capsys.readouterr().out
    f0 = state.initial_distributions(p, np.float64)
    with jax.enable_x64(True):
        _, avj = ref_d2q9.simulate(p, jnp.asarray(f0), jnp.asarray(obs.mask))
    av = io.read_av_vels(tmp_path / "whole" / "av_vels.dat")
    np.testing.assert_allclose(av, np.asarray(avj), rtol=1e-12)

    # 20 steps in chunks of 10, resumed to 30: bit-equal to the whole run
    ck = ["--checkpoint-every", "10", "--out-dir", str(tmp_path / "ck")]
    assert cli.main(files + ck + ["--num-steps", "20"]) == 0
    assert cli.main(files + ck + ["--resume"]) == 0
    for name in ("av_vels.dat", "final_state.dat"):
        assert (tmp_path / "ck" / name).read_bytes() == (tmp_path / "whole" / name).read_bytes()
    whole = lbm_model.run_simulation(p, obs, dtype=torch.float64, engine="native")
    resumed = lbm_model.run_simulation_with_checkpoints(
        p, obs, checkpoint_path=tmp_path / "ck" / "checkpoint.npz", checkpoint_every=10,
        dtype=torch.float64, engine="native", resume=True)
    assert np.array_equal(resumed.av_vels, whole.av_vels)
    assert np.array_equal(resumed.f_final, whole.f_final)


def test_native_refuses_other_types_and_tensors_to_advance(tmp_path):
    p, obs = case(tmp_path, n=2)
    with pytest.raises(ValueError, match="float32/float64"):
        d2q9_native.simulate(p, state.initial_distributions(p, np.float16), obs.mask)
    with pytest.raises(ValueError, match="float32 or torch.float64"):
        lbm_model.run_simulation(p, obs, dtype=torch.bfloat16, engine="native")
    f = torch.from_numpy(state.initial_distributions(p, np.float32))
    with pytest.raises(TypeError, match="numpy array"):
        d2q9_native.run(f, obs.mask, num_steps=1, omega=1.85, accel_w1=0.0, accel_w2=0.0,
                        accel_row=1)
    with pytest.raises(ValueError, match="float32/float64"):
        d3q19_native.run(np.zeros((19, 4, 4, 4), np.int32), np.zeros((4, 4, 4), bool),
                         num_steps=1, omega=1.85, density=0.1, accel=0.0, accel_plane=2)


def test_without_a_toolchain_native_raises_and_runs_nothing_else(tmp_path, monkeypatch):
    p, obs = case(tmp_path, n=2)
    monkeypatch.setattr(native_io, "load", lambda auto_build=True: None)

    def never(*args, **kwargs):
        raise AssertionError("another engine ran")

    monkeypatch.setattr(d2q9, "run", never)
    with pytest.raises(RuntimeError, match="native D2Q9 engine unavailable.*g\\+\\+"):
        lbm_model.run_simulation(p, obs, engine="native")
    with pytest.raises(RuntimeError, match="native D3Q19 engine unavailable"):
        d3q19.simulate(4, 4, 8, num_steps=1, engine="native")
    assert not d2q9_native.available() and not d3q19_native.available()


def test_auto_never_picks_native_and_native_never_asks_cuda(tmp_path, monkeypatch):
    p, obs = case(tmp_path, n=4)
    assert lbm_model.choose_engine(p, torch.float32, torch.device("cpu")) != "native"

    def asked(*args, **kwargs):
        raise AssertionError("the native engine asked CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", asked)
    res = lbm_model.run_simulation(p, obs, dtype=torch.float32, engine="native")
    assert res.engine == "native" and res.av_vels.shape == (4,)
    f, av = d3q19.simulate(4, 4, 8, num_steps=3, engine="native", dtype=torch.float32)
    assert f.device.type == "cpu" and av.shape == (3,)


# ---------------------------------------------------------------------------
# the native D3Q19 engine
# ---------------------------------------------------------------------------


def test_3d_bit_equal_to_the_reference_native_engine(ref_native):
    from lbm_tpu.ops import d3q19_native as ref3

    for dtype in (np.float64, np.float32):
        f, av = d3q19_native.simulate(6, 8, 12, num_steps=20, dtype=dtype)
        f_ref, av_ref = ref3.simulate(6, 8, 12, num_steps=20, dtype=dtype)
        assert np.array_equal(f, f_ref) and np.array_equal(av, av_ref)


def test_3d_f64_matches_jax_and_the_golden_anchor():
    fn, avn = d3q19_native.simulate(16, 16, 32, num_steps=200, dtype=np.float64)
    with jax.enable_x64(True):
        f0 = jnp.asarray(ref_d3q19.initial_distributions(16, 16, 32, 0.1, np.float64))
        mask = np.zeros((16, 16, 32), bool)
        mask[0] = mask[-1] = True
        amask = ref_d3q19.accel_plane_mask(16, 16, 32, 14, dtype=jnp.float64)
        fj, totj = ref_d3q19.run(f0, jnp.asarray(mask), amask, num_steps=200, omega=1.85,
                                 density=0.1, accel=0.005)
        avj = np.asarray(totj) / float((~mask).sum())
    np.testing.assert_allclose(avn, avj, rtol=1e-12)
    np.testing.assert_allclose(fn, np.asarray(fj), rtol=1e-11, atol=1e-18)
    golden = np.loadtxt(ANCHOR_3D, usecols=1, delimiter="\t")
    np.testing.assert_allclose(avn[1:], golden[1:], rtol=1e-12)


def test_3d_f32_same_rounding_class_as_jax():
    _, avn = d3q19_native.simulate(8, 12, 16, num_steps=50, dtype=np.float32)
    _, avj = ref_d3q19.simulate(8, 12, 16, num_steps=50, dtype=np.float32)
    np.testing.assert_allclose(avn, np.asarray(avj, np.float64), rtol=2e-4, atol=1e-9)


def test_3d_obstacle_geometry_parity():
    mask = np.zeros((8, 12, 16), bool)
    mask[0] = mask[-1] = True
    mask[3:5, 4:7, 6:10] = True
    fn, avn = d3q19_native.simulate(8, 12, 16, num_steps=30, obstacle_mask=mask,
                                    dtype=np.float64)
    with jax.enable_x64(True):
        fj, avj = ref_d3q19.simulate(8, 12, 16, num_steps=30, obstacle_mask=mask,
                                     dtype=np.float64)
    np.testing.assert_allclose(avn, np.asarray(avj), rtol=1e-12)
    np.testing.assert_allclose(fn, np.asarray(fj), rtol=1e-11, atol=1e-18)
    # the port's entry point with the same mask: the same arrays, as tensors
    f_t, av_t = d3q19.simulate(8, 12, 16, num_steps=30, obstacle_mask=mask, engine="native",
                               dtype=torch.float64)
    assert np.array_equal(f_t.numpy(), fn) and np.array_equal(av_t.numpy(), avn)


def test_3d_cli_engine_native_and_a_checkpointed_run(tmp_path, capsys):
    argv = ["--nz", "8", "--ny", "8", "--nx", "16", "--engine", "native", "--dtype", "float64"]
    assert cli3d.main(argv + ["-n", "12", "--out-dir", str(tmp_path / "whole")]) == 0
    assert "engine:\t\t\tnative" in capsys.readouterr().out
    _, av = d3q19_native.simulate(8, 8, 16, num_steps=12, dtype=np.float64)
    whole = tmp_path / "whole" / "av_vels_3d.dat"
    np.testing.assert_array_equal(io.read_av_vels(whole), np.asarray(
        [float(f"{v:.12E}") for v in av]))
    ck = ["--checkpoint-every", "4", "--out-dir", str(tmp_path / "ck")]
    assert cli3d.main(argv + ck + ["-n", "8"]) == 0
    assert cli3d.main(argv + ck + ["-n", "12", "--resume"]) == 0
    assert (tmp_path / "ck" / "av_vels_3d.dat").read_bytes() == whole.read_bytes()
    f_ck, av_ck, _, steps = lbm3d_model.run_simulation_with_checkpoints(
        8, 8, 16, num_steps=12, checkpoint_path=tmp_path / "ck" / "checkpoint_3d.npz",
        checkpoint_every=4, dtype=torch.float64, engine="native", resume=True)
    f_whole, _ = d3q19_native.simulate(8, 8, 16, num_steps=12, dtype=np.float64)
    assert steps == 0 and np.array_equal(f_ck, f_whole) and np.array_equal(av_ck, av)


def test_3d_chunked_runs_bit_identical():
    f_one = d3q19.initial_distributions(6, 8, 12, 0.1, np.float64)
    f_chunk = f_one.copy()
    mask = d3q19.default_obstacle_mask(6, 8, 12)
    kw = dict(omega=1.85, density=0.1, accel=0.005, accel_plane=4)
    tot_one = d3q19_native.run(f_one, mask, num_steps=12, **kw)
    tots = [d3q19_native.run(f_chunk, mask, num_steps=4, **kw) for _ in range(3)]
    assert np.array_equal(np.concatenate(tots), tot_one) and np.array_equal(f_chunk, f_one)


def test_num_steps_overrides_the_native_run(tmp_path):
    p, obs = case(tmp_path, n=50)
    short = lbm_model.run_simulation(p, obs, dtype=torch.float64, engine="native", num_steps=5)
    _, av = d2q9_native.simulate(dataclasses.replace(p, max_iters=5),
                                 state.initial_distributions(p, np.float64), obs.mask)
    assert np.array_equal(short.av_vels, av)
