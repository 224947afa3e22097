"""bfloat16 on the port's 3-D multi-device engines, on gloo ranks, against
the JAX package's sharded bfloat16 runs on its 8 virtual CPU devices (the
Pallas kernels in interpret mode), 16 steps at K = 2 from the state at rest
with the default walls.

* `sharded-cuda` on a z-mesh of 2 (each slab's kernel B4, or B6 with
  local_engine='two-stream', on the CPU their plain version: a float32
  pass rounded to bfloat16 once), with and without overlap, at 16x16x128,
  against `ops.d3q19.simulate(engine='sharded-pallas')`; `sharded-cuda-zy`
  on a (2, 2) mesh at 16x32x128 against 'sharded-pallas-zy'. The bars of
  the single-device bfloat16 runs: the state within one bfloat16 unit (at
  most 1e-3 of the values differing), av_vels within 1e-5 relative.
* the plain `sharded` engine (every operation rounded to bfloat16) on 4
  ranks against 'sharded': the state bit-equal, av_vels within two
  bfloat16 units (the bfloat16 Sum|u| is added over the ranks in another
  order; measured: one unit at 2 of the 16 steps).
* each state bit-equal to the port's single-device bfloat16 `cuda-inplace`
  (B4's plain pass; `cuda` for B6) or `torch` run.
* a checkpointed run on a z-mesh of 2, resumed on a z-mesh of 1: the state
  bit-equal to an uninterrupted run, av_vels within 1e-5 (Sum|u| adds
  another number of slabs), and its lattice the JAX package's `|V2` bytes
  from its own checkpointed 'sharded-pallas' run.
"""

import functools

import ml_dtypes
import numpy as np
import pytest
import torch

from lbm_tpu.models import lbm3d as jlbm3d
from lbm_tpu.ops import d3q19 as j3
from lbm_tpu_torch.models import lbm3d
from lbm_tpu_torch.ops import d3q19
from lbm_tpu_torch.parallel import launch

BF16 = torch.bfloat16
STEPS = 16
SHAPE = (16, 16, 128)
KW = dict(omega=1.85, density=0.1, accel=0.005)
# label: (port engine, JAX engine, shape, ranks, extra keywords)
CASES = {
    "z": ("sharded-cuda", "sharded-pallas", SHAPE, 2, dict(k_steps=2)),
    "z-overlap": ("sharded-cuda", "sharded-pallas", SHAPE, 2, dict(k_steps=2, overlap=True)),
    "zy": ("sharded-cuda-zy", "sharded-pallas-zy", (16, 32, 128), 4,
           dict(k_steps=2, mesh_shape=(2, 2))),
    "plain": ("sharded", "sharded", SHAPE, 4, {}),
}


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(a).view(np.int16).astype(np.int32)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@functools.lru_cache(maxsize=None)
def jax_run(label):
    _, engine, shape, n, extra = CASES[label]
    f, av = j3.simulate(*shape, num_steps=STEPS, dtype=ml_dtypes.bfloat16, engine=engine,
                        num_devices=n, **extra, **KW)
    return np.asarray(f), np.asarray(av)


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """The port's runs in one group of 2 ranks and one of 4, and the resume
    on one rank. Returns ({key: result}, the checkpoints' directory)."""
    tmp = tmp_path_factory.mktemp("bf16ck3d")
    groups = {2: {}, 4: {}}
    for label, (engine, _, shape, n, extra) in CASES.items():
        groups[n][label] = (d3q19.simulate, shape, dict(
            num_steps=STEPS, engine=engine, dtype=BF16, num_devices=n, device="cpu", **extra,
            **KW))
    groups[2]["two-stream"] = (lbm3d.simulate_engine, ("sharded-cuda", *SHAPE), dict(
        num_steps=STEPS, k_steps=2, dtype=BF16, local_engine="two-stream", **KW))
    groups[2]["timed"] = (lbm3d.run_simulation_sharded, SHAPE, dict(
        num_steps=STEPS, engine="sharded-cuda", dtype=BF16, num_devices=2, overlap=True,
        device="cpu", **KW))
    ck = dict(checkpoint_every=STEPS // 2, engine="sharded-cuda", dtype=BF16, k_steps=2,
              device="cpu", checkpoint_path=tmp / "port.npz", **KW)
    groups[2]["first"] = (lbm3d.run_simulation_with_checkpoints, SHAPE, dict(
        ck, num_steps=STEPS // 2, num_devices=2))
    results = {}
    for n, todo in groups.items():
        results.update(zip(todo, launch.run_each(list(todo.values()), n, timeout=300)))
    results["resumed"] = lbm3d.run_simulation_with_checkpoints(
        *SHAPE, num_steps=STEPS, resume=True, num_devices=1, **ck)
    return results, tmp


def single(engine, shape):
    return d3q19.simulate(*shape, num_steps=STEPS, dtype=BF16, engine=engine, device="cpu",
                          **({} if engine == "torch" else dict(k_steps=2)), **KW)


@pytest.mark.parametrize("label", ["z", "z-overlap", "zy"])
def test_kernel_engines_match_the_sharded_pallas_engines(ranked, label):
    f, av = ranked[0][label]
    jf, jav = jax_run(label)
    assert f.dtype == BF16 and av.dtype == torch.float32 and av.shape == (STEPS,)
    diff = np.abs(bits(f) - bits(jf))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3
    assert rel(av.numpy(), jav) <= 1e-5
    sf, sav = single("cuda-inplace", CASES[label][2])
    assert torch.equal(f, sf)
    assert rel(av.numpy(), sav.numpy()) <= 1e-6


def test_plain_sharded_matches_the_jax_sharded_engine(ranked):
    f, av = ranked[0]["plain"]
    jf, jav = jax_run("plain")
    assert f.dtype == av.dtype == BF16
    np.testing.assert_array_equal(bits(f), bits(jf))
    assert np.abs(bits(av) - bits(jav.astype(ml_dtypes.bfloat16))).max() <= 2
    sf, sav = single("torch", SHAPE)
    assert torch.equal(f, sf)
    assert np.abs(bits(av) - bits(sav)).max() <= 2


def test_two_stream_local_kernel_and_the_timed_run(ranked):
    results = ranked[0]
    f, av = results["two-stream"]
    assert torch.equal(f, results["z"][0])
    assert torch.equal(f, single("cuda", SHAPE)[0])
    timed = results["timed"]
    assert isinstance(timed.f_final, torch.Tensor) and timed.f_final.dtype == BF16
    assert timed.k_steps == 2 and timed.mesh_shape == (2,)
    assert torch.equal(timed.f_final, results["z-overlap"][0])
    np.testing.assert_allclose(timed.av_vels, results["z-overlap"][1].double().numpy(),
                               rtol=1e-6)


def test_checkpoint_resumes_on_another_z_mesh_and_writes_the_jax_bytes(ranked, tmp_path):
    results, tmp = ranked
    _, av_first, _, steps_first = results["first"]
    f_res, av_res, _, steps_res = results["resumed"]
    whole_f, whole_av = results["z"]
    assert steps_first == steps_res == STEPS // 2
    assert isinstance(f_res, torch.Tensor) and torch.equal(f_res, whole_f)
    np.testing.assert_array_equal(av_res[:STEPS // 2], av_first)
    np.testing.assert_allclose(av_res, whole_av.double().numpy(), rtol=1e-5)
    jlbm3d.run_simulation_with_checkpoints(
        *SHAPE, num_steps=STEPS, checkpoint_every=STEPS // 2, checkpoint_path=tmp_path / "j.npz",
        dtype=ml_dtypes.bfloat16, engine="sharded-pallas", k_steps=2, num_devices=2, **KW)
    with np.load(tmp / "port.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert a["f"].dtype == b["f"].dtype == np.dtype("V2")
        assert a["f"].tobytes() == b["f"].tobytes()
        assert int(a["step"]) == int(b["step"]) == STEPS
