"""The two kernel switches of A9 on the CPU, against the JAX package.

  * B2's `shared_reciprocal` (the collision takes 1/rho once and
    multiplies): the plain version, the CPU route of `d2q9_kstep.stepk` and
    `run`, against `lbm_tpu.ops.d2q9_pallas.stepk(shared_reciprocal=True)` in
    interpret mode, at the float32 bars of tests/test_torch_d2q9_kstep.py
    (state 2e-6, Sum|u| 2e-5, max abs difference over max abs value);
  * the per-speed D3Q19 grouping, fixed per process by LBM_D3Q19_GROUPING as
    in the JAX package: a child process with LBM_D3Q19_GROUPING=reference
    runs the port's plain engine and the kernels' plain version, and the
    JAX package's engine and z-slab Pallas kernel, under that variable. The
    port holds the JAX package at float64 <= 1e-12 and float32 <= 2e-5 and
    differs from the paired grouping, as tests/test_d3q19.py asserts of the
    JAX package.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import d2q9_pallas
from lbm_tpu.ops import d3q19 as j3
from lbm_tpu.ops import d3q19_pallas
from lbm_tpu_torch.core import state
from lbm_tpu_torch.ops import d2q9_kstep, d3q19, d3q19_kstep, d3q19_lattice

NY, NX = 32, 128
KW = dict(omega=1.85, accel_w1=0.1 * 0.005 / 9, accel_w2=0.1 * 0.005 / 36)
SHAPE_3D = (8, 8, 32)
KW_3D = dict(omega=1.85, density=0.1, accel=0.005)
STEPS_3D = 20


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def case_2d(seed=0):
    rng = np.random.default_rng(seed)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None]
    f = (0.1 * w * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (9, NY, NX)))).astype(np.float32)
    mask = np.zeros((NY, NX), bool)
    mask[NY // 4: NY // 2, NX // 4: NX // 2] = True
    mask[0, :] = True
    return f, mask


@pytest.mark.parametrize("k", [1, 2, 4])
def test_b2_shared_reciprocal_matches_pallas(k):
    f, mask = case_2d()
    kw = dict(k_steps=k, accel_row=NY - 2, **KW)
    jf, jt = d2q9_pallas.stepk(jnp.asarray(f), jnp.asarray(mask.astype(np.float32)), band=8,
                               interpret=True, shared_reciprocal=True, **kw)
    tf, tm = state.to_torch(f, mask, device="cpu")
    pf, pt = d2q9_kstep.stepk(tf, tm, shared_reciprocal=True, **kw)
    assert rel(pf.numpy(), np.asarray(jf)) <= 2e-6
    assert rel(pt.numpy(), np.asarray(jt)) <= 2e-5
    # and it is another rounding than the default collision
    df, _ = d2q9_kstep.stepk(tf, tm, **kw)
    assert not torch.equal(df, pf)


def test_b2_run_shared_reciprocal_matches_pallas_run():
    f, mask = case_2d(seed=1)
    kw = dict(num_steps=8, k_steps=4, accel_row=NY - 2, **KW)
    jf, jt = d2q9_pallas.run(jnp.asarray(f), jnp.asarray(mask.astype(np.float32)), band=8,
                             interpret=True, shared_reciprocal=True, **kw)
    tf, tm = state.to_torch(f, mask, device="cpu")
    pf, pt = d2q9_kstep.run(tf, tm, shared_reciprocal=True, **kw)
    assert rel(pf.numpy(), np.asarray(jf)) <= 2e-6
    assert rel(pt.numpy(), np.asarray(jt)) <= 2e-5


def case_3d(dtype):
    rng = np.random.default_rng(7)
    f = d3q19_lattice.initial_distributions(*SHAPE_3D, 0.1, np.float64)
    f = (f * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, f.shape))).astype(dtype)
    mask = rng.uniform(size=SHAPE_3D) < 0.05
    mask[0] = mask[-1] = True
    return f, mask


def grouping_results(out: str) -> None:
    """The body of the child process (and of the paired parent): the port's
    and the JAX package's 3-D results under this process's grouping, saved
    to `out` (.npz)."""
    res = {"grouping": np.asarray(d3q19.GROUPING), "jax_grouping": np.asarray(j3.GROUPING)}
    amask = {}
    for name, dtype in (("f64", np.float64), ("f32", np.float32)):
        f, mask = case_3d(dtype)
        with jax.enable_x64(dtype == np.float64):
            am = j3.accel_plane_mask(*SHAPE_3D, SHAPE_3D[0] - 2, dtype=jnp.dtype(dtype))
            jf, jt = j3.run(jnp.asarray(f), jnp.asarray(mask), am, num_steps=STEPS_3D, **KW_3D)
            res[f"jax_run_{name}"], res[f"jax_tot_{name}"] = np.asarray(jf), np.asarray(jt)
        tf, tm = state.to_torch3d(f, mask, device="cpu")
        amask[name] = d3q19.accel_plane_mask(*SHAPE_3D, SHAPE_3D[0] - 2, dtype=tf.dtype)
        pf, pt = d3q19.run(tf, tm, amask[name], num_steps=STEPS_3D, **KW_3D)
        res[f"port_run_{name}"], res[f"port_tot_{name}"] = pf.numpy(), pt.numpy()
    # the kernels' plain version against the z-slab TPU kernel, one pass
    f, mask = case_3d(np.float32)
    kw = dict(k_steps=2, accel_plane=SHAPE_3D[0] - 2, **KW_3D)
    jf, jt = d3q19_pallas.stepk(jnp.asarray(f), jnp.asarray(mask.astype(np.float32)), bz=4,
                                interpret=True, **kw)
    res["jax_pass"], res["jax_pass_tot"] = np.asarray(jf), np.asarray(jt)
    pf, pt = d3q19_kstep.stepk_plain(*state.to_torch3d(f, mask, device="cpu"), **kw)
    res["port_pass"], res["port_pass_tot"] = pf.numpy(), pt.numpy()
    np.savez(out, **res)


@pytest.fixture(scope="module")
def groupings(tmp_path_factory):
    """{grouping: results}: 'reference' from a child process with
    LBM_D3Q19_GROUPING=reference, 'paired' from this process."""
    tmp = tmp_path_factory.mktemp("a9")
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, LBM_D3Q19_GROUPING="reference",
               PYTHONPATH=os.pathsep.join(filter(None, [str(repo),
                                                        os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, __file__, str(tmp / "reference.npz")], env=env,
                          capture_output=True, text=True, cwd=repo, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert d3q19.GROUPING == "paired"
    grouping_results(str(tmp / "paired.npz"))
    return {g: dict(np.load(tmp / f"{g}.npz")) for g in ("reference", "paired")}


def test_the_child_runs_the_per_speed_grouping(groupings):
    ref = groupings["reference"]
    assert str(ref["grouping"]) == str(ref["jax_grouping"]) == "reference"
    assert str(groupings["paired"]["grouping"]) == "paired"


@pytest.mark.parametrize("name, bar", [("f64", 1e-12), ("f32", 2e-5)])
@pytest.mark.parametrize("grouping", ["reference", "paired"])
def test_plain_engine_matches_the_jax_engine(groupings, grouping, name, bar):
    r = groupings[grouping]
    assert rel(r[f"port_run_{name}"], r[f"jax_run_{name}"]) <= bar
    assert rel(r[f"port_tot_{name}"], r[f"jax_tot_{name}"]) <= bar


@pytest.mark.parametrize("grouping", ["reference", "paired"])
def test_kernel_plain_version_matches_the_tpu_kernel(groupings, grouping):
    r = groupings[grouping]
    assert rel(r["port_pass"], r["jax_pass"]) <= 2e-5
    assert rel(r["port_pass_tot"], r["jax_pass_tot"]) <= 2e-5


@pytest.mark.parametrize("name", ["f64", "f32"])
def test_per_speed_differs_from_paired(groupings, name):
    """Another rounding class, within the float bar of the paired one (as
    tests/test_d3q19.py asserts of the JAX package)."""
    a, b = groupings["reference"][f"port_run_{name}"], groupings["paired"][f"port_run_{name}"]
    assert not np.array_equal(a, b)
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-9)


def test_kernel_variant_follows_the_grouping(monkeypatch):
    """The 3-D kernels load the per-speed library only under the reference
    grouping; its build carries its own define and name."""
    from lbm_tpu_torch.ops import _build

    assert d3q19.kernel_variant() is None
    monkeypatch.setattr(d3q19, "GROUPING", "reference")
    assert d3q19.kernel_variant() == "per_speed"
    assert "-DLBM_D3Q19_PER_SPEED" in _build.flags("per_speed")
    assert "-DLBM_D3Q19_PER_SPEED" not in _build.flags()
    default, variant = (_build.library_path("d3q19_kstep"),
                        _build.library_path("d3q19_kstep", "per_speed"))
    assert default != variant and variant.name.startswith("libd3q19_kstep_per_speed_")


if __name__ == "__main__":
    grouping_results(sys.argv[1])
