"""bfloat16 on the port's 2-D multi-device engines, on gloo ranks, against
the JAX package's sharded bfloat16 runs on its 8 virtual CPU devices (the
Pallas kernels in interpret mode).

* `sharded-cuda` (each rank's kernel B1, or B2 with local_engine=
  'two-stream', on the CPU their plain version: a float32 pass rounded to
  bfloat16 once) against `run_simulation_sharded(engine='sharded-pallas')`,
  16 steps at K = 4: 32x128 on 4 row shards, 40x128 on 2 (the last shard
  padded and masked), and `overlap=True` ('row') at 48x128 on 2 ('full2d'
  on a (1, 2) mesh at 32x768: the port's own, held to one device). The bars
  of the single-device bfloat16 runs (tests/test_torch_bf16_d2q9.py): the
  state within one bfloat16 unit with at most 1e-3 of the values
  differing, av_vels within 1e-5 relative (Sum|u| is float32, added over
  the ranks in another order).
* the plain `sharded` engine, every operation rounded to bfloat16, against
  `engine='sharded'` with ppermute and implicit: the state bit-equal;
  av_vels within two bfloat16 units, since the bfloat16 Sum|u| is added
  over the ranks in another order (measured: one unit at 7 of the 16 steps
  with ppermute, 6 with implicit; two units on a grid without the row of
  obstacles on the shard boundary).
* each state bit-equal to the port's own single-device bfloat16 run of the
  same arithmetic: `cuda-inplace` (B1's plain pass; `cuda`, B2's, for the
  two-stream local kernel) and `torch` for all five halo strategies.
* checkpointed runs ('sharded-cuda' on 2 ranks, 'sharded' on 4): 8 steps,
  resumed to 16, equal the uninterrupted run bit for bit, and the lattice
  they write is the JAX package's `|V2` bytes from its own checkpointed
  sharded run; the CLI runs a checkpointed 'sharded-cuda' bfloat16 run.
"""

import dataclasses
import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lbm_tpu.core.params import Obstacles as JObstacles
from lbm_tpu.core.params import Params as JParams
from lbm_tpu.models import lbm as jlbm
from lbm_tpu_torch.cli import lbm as cli
from lbm_tpu_torch.core import io, state
from lbm_tpu_torch.core.params import Obstacles, Params
from lbm_tpu_torch.models import lbm
from lbm_tpu_torch.parallel import kstep_sharded, launch

BF16 = torch.bfloat16
STEPS = 16
# (rows, ranks, overlap) of the sharded-cuda runs
KERNEL_CASES = ((32, 4, False), (40, 2, False), (48, 2, True))
STRATEGIES = ("implicit", "ppermute", "manytensors", "allgather", "naive")


def case(ny, steps=STEPS, nx=128):
    p = Params(nx=nx, ny=ny, max_iters=steps, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    mask = np.zeros((ny, nx), bool)
    mask[0, :] = mask[-1, :] = True
    mask[10:20, 24:28] = True
    mask[ny // 2, ::3] = True  # on a row-shard boundary
    return p, Obstacles(mask)


def to_jax(p, obs):
    return JParams(**dataclasses.asdict(p)), JObstacles(obs.mask.copy())


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(a).view(np.int16).astype(np.int32)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@functools.lru_cache(maxsize=None)
def jax_run(ny, n, engine, overlap=False, strategy="ppermute"):
    return jlbm.run_simulation_sharded(*to_jax(*case(ny)), dtype=jnp.bfloat16, engine=engine,
                                       num_devices=n, overlap=overlap, strategy=strategy)


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """The port's runs, in one group of 2 ranks and one of 4. Returns
    ({key: result}, the checkpoints' directory)."""
    tmp = tmp_path_factory.mktemp("bf16ck")
    kw = dict(dtype=BF16, device="cpu")
    groups = {2: {}, 4: {}}
    for ny, n, overlap in KERNEL_CASES:
        groups[n][("sharded-cuda", ny, overlap)] = (lbm.run_simulation_sharded, case(ny), dict(
            engine="sharded-cuda", num_devices=n, overlap=overlap, **kw))
    for strategy in STRATEGIES:
        groups[4][("sharded", strategy)] = (lbm.run_simulation_sharded, case(32), dict(
            engine="sharded", strategy=strategy, num_devices=4, **kw))
    p, obs = case(40)
    f0 = state.initial_distributions(p, BF16)
    groups[2][("two-stream", 40)] = (launch.on_mesh, ((2, 1), kstep_sharded.simulate, p, f0,
                                                      obs.mask), dict(local_engine="two-stream"))
    p, obs = case(32, nx=768)
    groups[2][("full2d", 32)] = (launch.on_mesh, ((1, 2), kstep_sharded.simulate, p,
                                                  state.initial_distributions(p, BF16), obs.mask),
                                 dict(overlap=True, scheme="full2d"))
    for engine, ny, n in (("sharded-cuda", 40, 2), ("sharded", 32, 4)):
        ck = dict(engine=engine, num_devices=n, checkpoint_every=STEPS // 2,
                  checkpoint_path=tmp / f"{engine}.npz", **kw)
        groups[n][(engine, "first")] = (lbm.run_simulation_with_checkpoints, case(ny),
                                        dict(ck, num_steps=STEPS // 2))
        groups[n][(engine, "resumed")] = (lbm.run_simulation_with_checkpoints, case(ny),
                                          dict(ck, resume=True))
    results = {}
    for n, todo in groups.items():
        results.update(zip(todo, launch.run_each(list(todo.values()), n, timeout=300)))
    return results, tmp


@pytest.mark.parametrize("ny, n, overlap", KERNEL_CASES)
def test_sharded_cuda_matches_sharded_pallas(ranked, ny, n, overlap):
    got = ranked[0][("sharded-cuda", ny, overlap)]
    want = jax_run(ny, n, "sharded-pallas", overlap)
    assert isinstance(got.f_final, torch.Tensor) and got.f_final.dtype == BF16
    assert got.av_vels.shape == (STEPS,)
    diff = np.abs(bits(got.f_final) - bits(want.f_final))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
    assert rel(got.av_vels, want.av_vels) <= 1e-5
    # bit-equal to B1's single-device bfloat16 run (its plain pass here)
    single = lbm.run_simulation(*case(ny), engine="cuda-inplace", dtype=BF16, device="cpu")
    assert torch.equal(got.f_final, single.f_final)
    assert rel(got.av_vels, single.av_vels) <= 1e-6


@pytest.mark.parametrize("strategy", ["ppermute", "implicit"])
def test_plain_sharded_matches_the_jax_sharded_engine(ranked, strategy):
    got = ranked[0][("sharded", strategy)]
    want = jax_run(32, 4, "sharded", strategy=strategy)
    np.testing.assert_array_equal(bits(got.f_final), bits(want.f_final))
    av_bits = bits(torch.from_numpy(got.av_vels).to(BF16))
    assert np.abs(av_bits - bits(want.av_vels.astype(ml_dtypes.bfloat16))).max() <= 2


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_every_strategy_bit_equal_to_the_torch_engine(ranked, strategy):
    got = ranked[0][("sharded", strategy)]
    single = lbm.run_simulation(*case(32), engine="torch", dtype=BF16, device="cpu")
    assert got.f_final.dtype == BF16
    assert torch.equal(got.f_final, single.f_final)
    av_bits = bits(torch.from_numpy(got.av_vels).to(BF16))
    assert np.abs(av_bits - bits(torch.from_numpy(single.av_vels).to(BF16))).max() <= 2


def test_two_stream_local_kernel_equals_the_inplace_one(ranked):
    f, av = ranked[0][("two-stream", 40)]
    assert f.dtype == BF16 and av.dtype == torch.float32
    assert torch.equal(f, ranked[0][("sharded-cuda", 40, False)].f_final)
    single = lbm.run_simulation(*case(40), engine="cuda", dtype=BF16, device="cpu")
    assert torch.equal(f, single.f_final)


def test_full2d_overlap_equals_the_single_device_run(ranked):
    """Both waves under the interior kernel (five B1 kernels a chunk, their
    Sum|u| strips in float32), on a column-sharded mesh."""
    f, av = ranked[0][("full2d", 32)]
    assert f.dtype == BF16 and av.dtype == torch.float32
    single = lbm.run_simulation(*case(32, nx=768), engine="cuda-inplace", dtype=BF16,
                                device="cpu")
    assert torch.equal(f, single.f_final)
    assert rel(av.double().numpy(), single.av_vels) <= 1e-6


@functools.lru_cache(maxsize=None)
def jax_checkpointed(engine, ny, n, path):
    return jlbm.run_simulation_with_checkpoints(
        *to_jax(*case(ny)), checkpoint_path=path, checkpoint_every=STEPS // 2,
        dtype=jnp.bfloat16, engine=engine, num_devices=n)


@pytest.mark.parametrize("engine, jax_engine, ny, n", [
    ("sharded-cuda", "sharded-pallas", 40, 2), ("sharded", "sharded", 32, 4)])
def test_checkpointed_run_resumes_bit_equal_and_writes_the_jax_bytes(ranked, engine,
                                                                    jax_engine, ny, n):
    results, tmp = ranked
    first, resumed = results[(engine, "first")], results[(engine, "resumed")]
    whole = results[(engine, ny, False) if engine == "sharded-cuda" else (engine, "ppermute")]
    assert first.av_vels.shape == (STEPS // 2,) and resumed.steps_run == STEPS // 2
    assert torch.equal(resumed.f_final, whole.f_final)
    np.testing.assert_array_equal(resumed.av_vels, whole.av_vels)
    jax_checkpointed(jax_engine, ny, n, str(tmp / f"jax-{engine}.npz"))
    with np.load(tmp / f"{engine}.npz") as a, np.load(tmp / f"jax-{engine}.npz") as b:
        assert a["f"].dtype == b["f"].dtype == np.dtype("V2")
        assert a["f"].tobytes() == b["f"].tobytes()
        assert int(a["step"]) == int(b["step"]) == STEPS


def test_cli_runs_a_checkpointed_sharded_cuda_bf16_run(ranked, tmp_path, capsys):
    p, obs = case(40)
    p.to_file(tmp_path / "p.params")
    obs.to_file(tmp_path / "o.dat")
    rc = cli.main(["--params", str(tmp_path / "p.params"), "--obstacles", str(tmp_path / "o.dat"),
                   "--engine", "sharded-cuda", "--num-devices", "2", "--dtype", "bfloat16",
                   "--device", "cpu", "--checkpoint-every", str(STEPS // 2),
                   "--out-dir", str(tmp_path / "out")])
    assert rc == 0 and "==done==" in capsys.readouterr().out
    av = io.read_av_vels(tmp_path / "out" / "av_vels.dat")
    whole = ranked[0][("sharded-cuda", 40, False)]
    np.testing.assert_allclose(av, whole.av_vels, rtol=1e-11)
