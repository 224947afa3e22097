"""bfloat16 lattice storage in the port's 3-D paths (kernels B4-B7, the plain
`torch` engine, `ops.d3q19.simulate`, the slice writer and checkpoints)
against the JAX package on the CPU, the Pallas kernels in interpret mode, at
8x16x128 (bz 2, K <= 2).

As in 2-D (tests/test_torch_bf16_d2q9.py): the kernels step in float32 and
round the state once a pass, so one pass is within one bfloat16 unit of the
TPU kernel's (at most 1e-3 of values differing; Sum|u| within 1e-6
relative); the plain engine rounds every operation as the JAX engine does,
bit-equal over 100 steps; the slice writer and the checkpoint's lattice are
byte-equal. A 100-step run at the same K holds av_vels within 5e-5
relative, not 2-D's 1e-5: XLA fuses the 19-speed float32 collision
otherwise than PyTorch's one operation at a time, and one pass here leaves
3.2e-6 (K = 1) to 1.6e-5 (K = 2) of the bfloat16 values one unit apart;
fifty passes of such flips moved av_vels by 2.0e-5 at most (measured on the
CPU, all four engines).
"""

import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lbm_tpu.models import lbm3d as jlbm3d
from lbm_tpu.ops import d3q19 as j3
from lbm_tpu.ops import d3q19_lattice as jlattice
from lbm_tpu.ops import d3q19_pallas, d3q19_pallas_inplace
from lbm_tpu.ops import d3q19_pallas_inplace_blocked as jblk
from lbm_tpu_torch.core import checkpoint
from lbm_tpu_torch.models import lbm3d
from lbm_tpu_torch.ops import (d3q19, d3q19_kstep, d3q19_kstep_blocked, d3q19_kstep_inplace,
                               d3q19_kstep_inplace_blocked, d3q19_lattice)

BF16 = ml_dtypes.bfloat16
SHAPE = (8, 16, 128)
KW = dict(omega=1.85, density=0.1, accel=0.005)
# each port wrapper (its CPU route is the plain version), its TPU kernel and
# the kernel's blocking
PAIRS = {
    "b6": (d3q19_kstep.stepk, d3q19_pallas.stepk, dict(bz=2)),
    "b4": (d3q19_kstep_inplace.stepk, d3q19_pallas_inplace.stepk, dict(bz=2)),
    "b7": (d3q19_kstep_blocked.stepk, d3q19_pallas.stepk, dict(bz=2, by=8)),
    "b5": (d3q19_kstep_inplace_blocked.stepk, jblk.stepk, dict(bz=2, by=8)),
}


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(a).view(np.int16).astype(np.int32)


def to_bf16_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)


def make_case(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    f = d3q19_lattice.initial_distributions(*shape, 0.1, np.float64)
    f = (f * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, f.shape))).astype(BF16)
    mask = rng.uniform(size=shape) < 0.05
    mask[0] = mask[-1] = True
    return f, mask


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", list(PAIRS))
def test_one_pass_within_one_unit_of_the_tpu_kernel(name, k):
    port_fn, jax_fn, blocking = PAIRS[name]
    f, mask = make_case()
    kw = dict(k_steps=k, accel_plane=SHAPE[0] - 2, **KW)
    jf, jt = jax_fn(jnp.asarray(f), jnp.asarray(mask.astype(BF16)), interpret=True,
                    **blocking, **kw)
    jf, jt = np.asarray(jf), np.asarray(jt)
    assert jf.dtype == BF16 and jt.dtype == np.float32
    pf, pt = port_fn(to_bf16_tensor(f), torch.from_numpy(mask), **kw)
    assert pf.dtype == torch.bfloat16 and pt.dtype == torch.float32 and pt.shape == (k,)
    diff = np.abs(bits(pf) - bits(jf))
    assert diff.max() <= 1
    assert (diff != 0).mean() <= 1e-3
    assert rel(pt.numpy(), jt) <= 1e-6


def test_plain_version_rounds_once_a_pass():
    f, mask = make_case(seed=3)
    tf, tm = to_bf16_tensor(f), torch.from_numpy(mask)
    kw = dict(k_steps=2, accel_plane=SHAPE[0] - 2, **KW)
    pf, pt = d3q19_kstep.stepk_plain(tf, tm, **kw)
    ff, ft = d3q19_kstep.stepk_plain(tf.float(), tm, **kw)
    assert torch.equal(pf, ff.to(torch.bfloat16)) and torch.equal(pt, ft)


def test_torch_engine_bit_equal_to_the_jax_engine():
    """100 steps of the plain engine in bfloat16, from the state at rest,
    the free-cell division included."""
    jf, jav = j3.simulate(*SHAPE, num_steps=100, dtype=BF16, engine="jax", **KW)
    pf, pav = d3q19.simulate(*SHAPE, num_steps=100, dtype=torch.bfloat16, engine="torch",
                             device="cpu", **KW)
    assert pf.dtype == torch.bfloat16 and pav.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(pf), bits(jf))
    np.testing.assert_array_equal(bits(pav), bits(jav))


@functools.lru_cache(maxsize=None)
def jax_av_vels(jax_engine):
    """A 100-step bfloat16 run of a TPU engine at K = 2, shared by the port
    engines held against it."""
    return np.asarray(j3.simulate(*SHAPE, num_steps=100, dtype=BF16, engine=jax_engine,
                                  k_steps=2, **KW)[1])


@pytest.mark.parametrize("engine, jax_engine", [("cuda", "pallas"),
                                                ("cuda-inplace", "pallas-inplace"),
                                                ("cuda-blocked", "pallas"),
                                                ("cuda-inplace-blocked", "pallas-inplace")])
def test_simulate_matches_the_pallas_engines(engine, jax_engine):
    """100 steps at K = 2, the TPU engines' own K, so that both round at
    the same steps."""
    jav = jax_av_vels(jax_engine)
    pf, pav = d3q19.simulate(*SHAPE, num_steps=100, dtype=torch.bfloat16, engine=engine,
                             k_steps=2, device="cpu", **KW)
    assert pf.dtype == torch.bfloat16 and pav.dtype == torch.float32
    assert rel(pav[1:].numpy(), jav[1:]) <= 5e-5


def test_initial_distributions_bit_equal():
    ours = d3q19_lattice.initial_distributions(*SHAPE, 0.1, torch.bfloat16)
    np.testing.assert_array_equal(bits(ours), bits(jlattice.initial_distributions(*SHAPE, 0.1,
                                                                                  BF16)))


def test_final_state_slice_byte_identical(tmp_path):
    f, mask = make_case(seed=4)
    lbm3d.write_final_state_slice(tmp_path / "port.dat", to_bf16_tensor(f), mask, 4, 0.1)
    jlbm3d.write_final_state_slice(tmp_path / "jax.dat", f, mask, 4, 0.1)
    assert (tmp_path / "port.dat").read_bytes() == (tmp_path / "jax.dat").read_bytes()


def test_checkpoint_lattice_is_the_jax_packages_bytes(tmp_path):
    kw = dict(num_steps=20, checkpoint_every=10, **KW)
    lbm3d.run_simulation_with_checkpoints(*SHAPE, checkpoint_path=tmp_path / "port.npz",
                                          dtype=torch.bfloat16, engine="torch", device="cpu",
                                          **kw)
    jlbm3d.run_simulation_with_checkpoints(*SHAPE, checkpoint_path=tmp_path / "jax.npz",
                                           dtype=BF16, engine="jax", **kw)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a["f"].dtype == b["f"].dtype == np.dtype("V2")
        assert a["f"].tobytes() == b["f"].tobytes()
    ck = checkpoint.load3d(tmp_path / "port.npz")
    assert ck.f.dtype == torch.bfloat16 and tuple(ck.f.shape) == (19, *SHAPE)


@pytest.mark.parametrize("engine", ["cuda-inplace", "torch"])
def test_bf16_resume_bit_equal_to_a_whole_run(tmp_path, engine):
    kw = dict(checkpoint_every=10, dtype=torch.bfloat16, engine=engine, device="cpu", **KW)
    whole = lbm3d.run_simulation_with_checkpoints(*SHAPE, num_steps=20,
                                                  checkpoint_path=tmp_path / "w.npz", **kw)
    lbm3d.run_simulation_with_checkpoints(*SHAPE, num_steps=10,
                                          checkpoint_path=tmp_path / "p.npz", **kw)
    resumed = lbm3d.run_simulation_with_checkpoints(*SHAPE, num_steps=20, resume=True,
                                                    checkpoint_path=tmp_path / "p.npz", **kw)
    assert resumed[3] == 10
    assert torch.equal(resumed[0], whole[0])
    np.testing.assert_array_equal(resumed[1], whole[1])


def test_bf16_paths_and_refusals():
    """A bfloat16 pass of B4 at K > 1 takes the faster of its step and wave
    paths (PATH_MS; both step through a float32 scratch lattice), of one
    step and every bfloat16 pass of B6 the step path; of B5/B7 the thread
    path; the wave path refuses B6's bfloat16 pass and a pass of one step;
    the ghost-plane engine on one rank runs B4's bfloat16 pass, bit-equal to
    the single-device run."""
    ms = d3q19_kstep.PATH_MS[torch.bfloat16]["b4"]
    for kernel in ("b4", "b6"):
        for k in (1, 2, 3, 4):
            want = ("wave" if kernel == "b4" and k > 1 and ms["wave"][k - 1] <= ms["step"][k - 1]
                    else "step")
            assert d3q19_kstep.choose_path(64, 128, 256, k, torch.bfloat16,
                                           kernel=kernel) == want
    assert d3q19_kstep.choose_path(64, 128, 256, 4, torch.bfloat16, kernel="b4") == "wave"
    assert d3q19_kstep.choose_path(2, 128, 256, 4, torch.bfloat16, kernel="b4") == "step"
    assert d3q19_kstep_blocked.choose_path(32, 256, 256, (4, 4, 32), 2, torch.bfloat16) == "thread"
    assert d3q19_kstep_blocked.shared_bytes((4, 4, 32), 2, torch.bfloat16) == \
        d3q19_kstep_blocked.shared_bytes((4, 4, 32), 2, torch.float32)
    f = torch.zeros((19, 8, 8, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wave path"):
        d3q19_kstep.resolve_path("wave", f, 2)
    with pytest.raises(ValueError, match="wave path"):
        d3q19_kstep.resolve_path("wave", f, 1, kernel="b4")
    assert d3q19_kstep.resolve_path("wave", f, 2, kernel="b4") == "wave"
    assert d3q19_kstep.rounding_scratch(f, 1) is None
    assert d3q19_kstep.rounding_scratch(f, 2).dtype == torch.float32
    kw = dict(num_steps=2, dtype=torch.bfloat16, k_steps=2, device="cpu")
    sf, sav = d3q19.simulate(8, 8, 16, engine="sharded-cuda", num_devices=1, **kw)
    pf, pav = d3q19.simulate(8, 8, 16, engine="cuda-inplace", **kw)
    assert sf.dtype == torch.bfloat16 and sav.dtype == torch.float32
    assert torch.equal(sf, pf) and torch.equal(sav, pav)
