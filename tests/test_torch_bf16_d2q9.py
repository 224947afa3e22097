"""bfloat16 lattice storage in the port's 2-D paths (kernels B1-B3, the plain
`torch` engine, `models.lbm`'s runs, the writers and checkpoints) against
the JAX package on the CPU, the Pallas kernels in interpret mode.

The TPU kernels step in float32 and round the state to bfloat16 once a
K-step pass; the port's plain versions (the kernels' CPU route) do the same.
The two round the same float32 values except where the two frameworks'
float32 arithmetic differs in the last bit (XLA fuses, PyTorch does not),
and such a difference crosses a bfloat16 rounding boundary rarely. So:
  * one pass: every value within one bfloat16 unit, at most 1e-3 of them
    differing; Sum|u| (float32) within 1e-6 relative;
  * a whole run, 100 steps: av_vels within 1e-5 relative.
The plain `torch` engine rounds every operation to bfloat16, with every
scalar rounded first, as JAX's weak typing does: bit-equal to
`lbm_tpu.ops.d2q9.run` over 100 steps. The writers and the checkpoint's
lattice are byte-equal.
"""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lbm_tpu.core import io as jio
from lbm_tpu.core import state as jstate
from lbm_tpu.core.params import Obstacles as JObstacles
from lbm_tpu.core.params import Params as JParams
from lbm_tpu.models import lbm as jlbm
from lbm_tpu.ops import d2q9 as jd2q9
from lbm_tpu.ops import d2q9_pallas, d2q9_pallas_inplace, d2q9_pallas_manual
from lbm_tpu_torch.core import checkpoint, io, state
from lbm_tpu_torch.core.params import Obstacles, Params
from lbm_tpu_torch.models import lbm
from lbm_tpu_torch.ops import d2q9, d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual

BF16 = ml_dtypes.bfloat16
NY, NX = 32, 128
KW = dict(omega=1.85, accel_w1=0.1 * 0.005 / 9, accel_w2=0.1 * 0.005 / 36)
# each port wrapper (its CPU route is the plain version) and its TPU kernel
PAIRS = {
    "b2": (d2q9_kstep.stepk, d2q9_pallas.stepk),
    "b1": (d2q9_kstep_inplace.stepk, d2q9_pallas_inplace.stepk),
    "b3": (d2q9_kstep_manual.stepk, d2q9_pallas_manual.stepk),
}


def bits(a) -> np.ndarray:
    """The bfloat16 values of a tensor or ml_dtypes array as int32 bit
    patterns: neighbouring values of one sign differ by 1."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(a).view(np.int16).astype(np.int32)


def to_bf16_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)


def perturbed_state(ny, nx, seed=0):
    rng = np.random.default_rng(seed)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None]
    f = (0.1 * w * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (9, ny, nx)))).astype(BF16)
    mask = np.zeros((ny, nx), bool)
    mask[ny // 4: ny // 2, nx // 4: nx // 2] = True
    mask[0, :] = True
    return f, mask


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name", list(PAIRS))
def test_one_pass_within_one_unit_of_the_tpu_kernel(name, k):
    port_fn, jax_fn = PAIRS[name]
    f, mask = perturbed_state(NY, NX)
    jf, jt = jax_fn(jnp.asarray(f), jnp.asarray(mask.astype(BF16)), k_steps=k,
                    accel_row=NY - 2, band=8, interpret=True, **KW)
    jf, jt = np.asarray(jf), np.asarray(jt)
    assert jf.dtype == BF16 and jt.dtype == np.float32
    pf, pt = port_fn(to_bf16_tensor(f), torch.from_numpy(mask), k_steps=k, accel_row=NY - 2,
                     **KW)
    assert pf.dtype == torch.bfloat16 and pt.dtype == torch.float32 and pt.shape == (k,)
    diff = np.abs(bits(pf) - bits(jf))
    assert diff.max() <= 1
    assert (diff != 0).mean() <= 1e-3
    assert rel(pt.numpy(), jt) <= 1e-6


def test_plain_version_rounds_once_a_pass():
    """stepk_plain of a bfloat16 state is the float32 pass of its values,
    rounded at the end: not K roundings."""
    f, mask = perturbed_state(NY, NX, seed=3)
    tf = to_bf16_tensor(f)
    pf, pt = d2q9_kstep.stepk_plain(tf, torch.from_numpy(mask), k_steps=4, accel_row=NY - 2,
                                    **KW)
    ff, ft = d2q9_kstep.stepk_plain(tf.float(), torch.from_numpy(mask), k_steps=4,
                                    accel_row=NY - 2, **KW)
    assert torch.equal(pf, ff.to(torch.bfloat16)) and torch.equal(pt, ft)


def test_torch_engine_bit_equal_to_the_jax_engine():
    """100 steps of the plain engine in bfloat16 at 32x64, first
    acceleration and the free-cell division included."""
    p = Params(nx=64, ny=32, max_iters=100, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    f, mask = perturbed_state(32, 64, seed=1)
    jf, jav = jd2q9.simulate(JParams(**dataclasses.asdict(p)), jnp.asarray(f),
                             jnp.asarray(mask))
    pf, pav = d2q9.simulate(p, to_bf16_tensor(f), torch.from_numpy(mask))
    assert pf.dtype == torch.bfloat16 and pav.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(pf), bits(np.asarray(jf)))
    np.testing.assert_array_equal(bits(pav), bits(np.asarray(jav)))


def flagship_like(steps):
    p = Params(nx=NX, ny=NY, max_iters=steps, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    mask = np.zeros((NY, NX), bool)
    mask[0, :] = mask[-1, :] = True
    mask[10:20, 24:28] = True
    return p, Obstacles(mask)


def to_jax(p, obstacles):
    return JParams(**dataclasses.asdict(p)), JObstacles(obstacles.mask.copy())


@pytest.mark.parametrize("engine, jax_engine", [("cuda", "pallas"),
                                                ("cuda-inplace", "pallas-inplace"),
                                                ("cuda-manual", "pallas-manual")])
def test_run_simulation_matches_the_pallas_engines(engine, jax_engine):
    p, obs = flagship_like(100)
    res = lbm.run_simulation(p, obs, engine=engine, dtype=torch.bfloat16, device="cpu")
    jres = jlbm.run_simulation(*to_jax(p, obs), engine=jax_engine, dtype=jnp.bfloat16)
    assert isinstance(res.f_final, torch.Tensor) and res.f_final.dtype == torch.bfloat16
    assert res.av_vels.shape == (100,)
    assert rel(res.av_vels, jres.av_vels) <= 1e-5
    assert np.abs(bits(res.f_final) - bits(jres.f_final)).max() <= 1
    assert res.total_density == pytest.approx(jres.total_density, rel=1e-5)


def test_initial_distributions_bit_equal():
    p = Params(nx=16, ny=8, max_iters=1, reynolds_dim=10, density=0.1, accel=0.005, omega=1.85)
    ours = state.initial_distributions(p, torch.bfloat16)
    theirs = jstate.initial_distributions(JParams(**dataclasses.asdict(p)), BF16)
    np.testing.assert_array_equal(bits(ours), bits(theirs))


def test_write_final_state_byte_identical(tmp_path):
    p, obs = flagship_like(1)
    f, _ = perturbed_state(NY, NX, seed=4)
    io.write_final_state(tmp_path / "port.dat", p, obs.mask, to_bf16_tensor(f))
    jio.write_final_state(tmp_path / "jax.dat", JParams(**dataclasses.asdict(p)), obs.mask, f)
    assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "jax.dat").read_bytes()


def test_checkpoint_lattice_is_the_jax_packages_bytes(tmp_path):
    """The plain engines of both packages, 20 steps in chunks of 10: the
    checkpoint's lattice is the same bfloat16 bits in `|V2`."""
    p, obs = flagship_like(20)
    lbm.run_simulation_with_checkpoints(p, obs, checkpoint_path=tmp_path / "port.npz",
                                        checkpoint_every=10, dtype=torch.bfloat16,
                                        engine="torch", device="cpu")
    jlbm.run_simulation_with_checkpoints(*to_jax(p, obs), checkpoint_path=tmp_path / "jax.npz",
                                         checkpoint_every=10, dtype=jnp.bfloat16, engine="jax")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a["f"].dtype == b["f"].dtype == np.dtype("V2")
        assert a["f"].tobytes() == b["f"].tobytes()
        assert int(a["step"]) == int(b["step"]) == 20
    ck = checkpoint.load(tmp_path / "port.npz")
    assert ck.f.dtype == torch.bfloat16 and ck.f.shape == (9, NY, NX)


@pytest.mark.parametrize("engine", ["cuda", "torch"])
def test_bf16_resume_bit_equal_to_a_whole_run(tmp_path, engine):
    p, obs = flagship_like(40)
    whole = lbm.run_simulation_with_checkpoints(p, obs, checkpoint_path=tmp_path / "whole.npz",
                                                checkpoint_every=20, dtype=torch.bfloat16,
                                                engine=engine, device="cpu")
    ck = tmp_path / "part.npz"
    lbm.run_simulation_with_checkpoints(p, obs, checkpoint_path=ck, checkpoint_every=20,
                                        dtype=torch.bfloat16, engine=engine, num_steps=20,
                                        device="cpu")
    resumed = lbm.run_simulation_with_checkpoints(p, obs, checkpoint_path=ck,
                                                  checkpoint_every=20, dtype=torch.bfloat16,
                                                  engine=engine, resume=True, device="cpu")
    assert resumed.steps_run == 20
    assert torch.equal(resumed.f_final, whole.f_final)
    np.testing.assert_array_equal(resumed.av_vels, whole.av_vels)
    if engine == "cuda":  # the checkpointed run equals run_simulation at its K
        plain = lbm.run_simulation(p, obs, engine="cuda", dtype=torch.bfloat16, device="cpu")
        assert torch.equal(plain.f_final, whole.f_final)


def test_shared_memory_and_path_of_a_bf16_launch():
    """The buffers of a bfloat16 launch hold float32: the tile and shared
    memory are float32's; the box path is never taken (not even at K = 8,
    where 8 values are a whole 16-byte piece)."""
    assert d2q9_kstep.itemsizes(torch.bfloat16) == (2, 4)
    assert d2q9_kstep.choose_config(1024, 1024, torch.bfloat16) == \
        d2q9_kstep.choose_config(1024, 1024, torch.float32)
    for k in (4, 8):
        assert d2q9_kstep.choose_path(1024, 1024, (16, 32), k, 2, False,
                                      compute_itemsize=4) == "thread"
        assert d2q9_kstep_manual.choose_path(1024, 1024, (16, 32), k, 2,
                                             compute_itemsize=4) == "thread"
    assert d2q9_kstep.choose_path(1024, 1024, (16, 32), 4, 4, False) == "box"
    # a bfloat16 lattice is half of float32's; sums and partials are float32
    f32 = d2q9_kstep.simulate_bytes("cuda", 1024, 1024, torch.float32)
    bf16 = d2q9_kstep.simulate_bytes("cuda", 1024, 1024, torch.bfloat16)
    assert bf16 == f32 - 4 * 9 * 1024 * 1024 * 2


def test_cli_runs_bf16_and_refuses_it_where_it_is_not_implemented(tmp_path, capsys):
    from lbm_tpu_torch.cli import lbm as cli

    p, obs = flagship_like(8)
    params = tmp_path / "p.params"
    params.write_text(f"{p.nx}\n{p.ny}\n{p.max_iters}\n{p.reynolds_dim}\n{p.density}\n"
                      f"{p.accel}\n{p.omega}\n")
    obstacles = tmp_path / "o.dat"
    ys, xs = np.nonzero(obs.mask)
    obstacles.write_text("".join(f"{x} {y} 1\n" for y, x in zip(ys, xs)))
    base = ["--params", str(params), "--obstacles", str(obstacles), "--device", "cpu",
            "--dtype", "bfloat16", "--out-dir", str(tmp_path / "out")]
    assert cli.main(base + ["--engine", "auto"]) == 0
    assert "engine:\t\t\t\tcuda" in capsys.readouterr().out
    assert len((tmp_path / "out" / "av_vels.dat").read_text().splitlines()) == 8
    # the plain sharded engine on one gloo rank: the torch engine's bits
    sharded = base[:-1] + [str(tmp_path / "sharded"), "--engine", "sharded"]
    assert cli.main(sharded) == 0
    assert "engine:\t\t\t\tsharded" in capsys.readouterr().out
    got = io.read_av_vels(tmp_path / "sharded" / "av_vels.dat")
    want = lbm.run_simulation(p, obs, engine="torch", dtype=torch.bfloat16, device="cpu")
    assert torch.equal(torch.from_numpy(got).to(torch.bfloat16),  # the file's 13 digits
                       torch.from_numpy(want.av_vels).to(torch.bfloat16))
    with pytest.raises(SystemExit):
        cli.main(base + ["--engine", "native"])
    assert "--engine native takes float32 or float64" in capsys.readouterr().err
