"""The pipelined K-step wrapper of the port (lbm_tpu_torch.ops.d2q9_kstep_manual,
kernel B3) and the engine `cuda-manual`, on the CPU, against the JAX package's
`pallas-manual` engine (lbm_tpu.ops.d2q9_pallas_manual, run in interpret
mode as tests/test_d2q9_manual.py runs it); and the D2Q9 kernels' tile choice
on grids whose sides no tile divides.

On the CPU the wrapper runs its kernel's plain version, `stepk_plain`; the
CUDA kernel itself is held against it and against B2 on the card by
chip_smoke.py.

Tolerances (max abs difference over max abs value), as in
tests/test_torch_d2q9_kstep.py: float64 <= 1e-12 on state and Sum|u|;
float32 <= 2e-6 on the state and <= 2e-5 on Sum|u|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.core.params import Obstacles as JObstacles
from lbm_tpu.core.params import Params as JParams
from lbm_tpu.models import lbm as jlbm
from lbm_tpu.ops import d2q9_pallas_manual
from lbm_tpu_torch.cli import lbm as cli
from lbm_tpu_torch.core import checkpoint, state
from lbm_tpu_torch.core.params import Obstacles, Params
from lbm_tpu_torch.models import lbm
from lbm_tpu_torch.ops import d2q9_kstep, d2q9_kstep_manual

KW = dict(omega=1.85, accel_w1=0.1 * 0.005 / 9, accel_w2=0.1 * 0.005 / 36)
BARS = {np.float64: (1e-12, 1e-12), np.float32: (2e-6, 2e-5)}  # (state, Sum|u|)


def make_case(ny, nx, dtype, seed=0):
    rng = np.random.default_rng(seed)
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None]
    f = (0.1 * w * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (9, ny, nx)))).astype(dtype)
    mask = np.zeros((ny, nx), bool)
    mask[ny // 4: ny // 2, nx // 4: nx // 2] = True
    mask[0, :] = True
    return f, mask


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def compare(ny, nx, band, k, dtype, seed=0, **window):
    f, mask = make_case(ny, nx, dtype, seed)
    kw = dict(k_steps=k, accel_row=window.pop("accel_row", ny - 2), **KW, **window)
    with jax.enable_x64(dtype == np.float64):
        jf, jt = d2q9_pallas_manual.stepk(jnp.asarray(f), jnp.asarray(mask.astype(dtype)),
                                          band=band, interpret=True, **kw)
        jf, jt = np.asarray(jf), np.asarray(jt)
    tf, tm = state.to_torch(f, mask, device="cpu")
    pf, pt = d2q9_kstep_manual.stepk(tf, tm, **kw)
    assert pt.shape == (k,)
    state_bar, u_bar = BARS[dtype]
    assert rel(pf.numpy(), jf) <= state_bar
    assert rel(pt.numpy(), jt) <= u_bar
    np.testing.assert_array_equal(tf.numpy(), f)  # two-stream: f is left alone


# the cases of tests/test_d2q9_manual.py, cut to at most 32x128
@pytest.mark.parametrize("ny, nx, band, k", [
    (16, 128, 8, 1),
    (32, 128, 16, 2),
    (32, 128, 8, 4),
    (32, 128, 16, 8),
])
def test_stepk_float32_matches_pallas_manual(ny, nx, band, k):
    compare(ny, nx, band, k, np.float32)


def test_stepk_float64_matches_pallas_manual():
    compare(32, 128, 8, 4, np.float64, seed=1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_stepk_ghost_window_matches_pallas_manual(dtype):
    """A ghost-extended block: local row r is global row r + 16 of a 40-row
    grid, so the accelerated row 2 is local row 26 (42 mod 40), more than K
    rows from both edges, and only [4, 28) x [8, 120) counts towards
    Sum|u|."""
    compare(32, 128, 8, 2, dtype, seed=2, row_offset=16, valid_rows=(4, 28),
            valid_cols=(8, 120), global_ny=40, accel_row=2)


def test_run_and_simulate_match_pallas_manual():
    ny, nx = 32, 128
    f, mask = make_case(ny, nx, np.float32, seed=3)
    kw = dict(num_steps=8, k_steps=4, accel_row=ny - 2, **KW)
    jf, jt = d2q9_pallas_manual.run(jnp.asarray(f), jnp.asarray(mask.astype(np.float32)),
                                    band=8, interpret=True, **kw)
    tf, tm = state.to_torch(f, mask, device="cpu")
    pf, pt = d2q9_kstep_manual.run(tf, tm, **kw)
    assert pt.shape == (8,)
    assert rel(pf.numpy(), np.asarray(jf)) <= BARS[np.float32][0]
    assert rel(pt.numpy(), np.asarray(jt)) <= BARS[np.float32][1]

    p = Params(nx=nx, ny=ny, max_iters=8, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    with jax.enable_x64(True):
        f0 = state.initial_distributions(p, np.float64)
        jf, jav = d2q9_pallas_manual.simulate(p, jnp.asarray(f0), jnp.asarray(mask),
                                              interpret=True)
        jf, jav = np.asarray(jf), np.asarray(jav)
    pf, pav = d2q9_kstep_manual.simulate(p, *state.to_torch(f0, mask, device="cpu"))
    assert rel(pf.numpy(), jf) <= 1e-12
    assert rel(pav.numpy(), jav) <= 1e-12


def flagship_like(ny=32, nx=64, steps=8):
    p = Params(nx=nx, ny=ny, max_iters=steps, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    mask = np.zeros((ny, nx), bool)
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    mask[10:20, 24:28] = True
    return p, Obstacles(mask)


def to_jax(p, obstacles):
    return JParams(**dataclasses.asdict(p)), JObstacles(obstacles.mask.copy())


def test_run_simulation_cuda_manual_matches_pallas_manual_float64():
    p, obs = flagship_like()
    res = lbm.run_simulation(p, obs, engine="cuda-manual", dtype=torch.float64, device="cpu")
    assert res.engine == "cuda-manual"
    with jax.enable_x64(True):
        jres = jlbm.run_simulation(*to_jax(p, obs), engine="pallas-manual", dtype=jnp.float64)
    assert res.av_vels.shape == (8,) and res.f_final.dtype == np.float64
    assert rel(res.av_vels, jres.av_vels) <= 1e-12
    assert rel(res.f_final, jres.f_final) <= 1e-12


def test_checkpoint_chunking_through_cuda_manual(tmp_path):
    """Chunks of 4 steps, then a resume to 12, equal an uninterrupted run of
    the same engine at the same K bit for bit; the checkpoint records K."""
    p, obs = flagship_like(steps=12)
    ref = lbm.run_simulation(p, obs, engine="cuda-manual", dtype=torch.float64, device="cpu")
    ck = tmp_path / "ck.npz"
    kw = dict(checkpoint_path=ck, checkpoint_every=4, engine="cuda-manual",
              dtype=torch.float64, device="cpu")
    lbm.run_simulation_with_checkpoints(p, obs, num_steps=8, **kw)
    assert checkpoint.load(ck, expect=p).k_steps == 4
    res = lbm.run_simulation_with_checkpoints(p, obs, resume=True, **kw)
    assert res.steps_run == 4 and res.engine == "cuda-manual"
    np.testing.assert_array_equal(res.av_vels, ref.av_vels)
    np.testing.assert_array_equal(res.f_final, ref.f_final)


def test_cli_accepts_cuda_manual(tmp_path, capsys):
    p, obs = flagship_like()
    p.to_file(tmp_path / "p.params")
    obs.to_file(tmp_path / "o.dat")
    rc = cli.main(["--params", str(tmp_path / "p.params"), "--obstacles", str(tmp_path / "o.dat"),
                   "--engine", "cuda-manual", "--device", "cpu", "--dtype", "float64",
                   "--out-dir", str(tmp_path / "out")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "engine:\t\t\t\tcuda-manual" in out and "==done==" in out
    ref = lbm.run_simulation(p, obs, engine="torch", dtype=torch.float64, device="cpu")
    written = np.loadtxt(tmp_path / "out" / "av_vels.dat", usecols=1)
    assert rel(written, ref.av_vels) <= 1e-9  # the file keeps 12 significant digits


def test_wrapper_routes_and_counts_nothing_on_the_cpu():
    f, mask = make_case(16, 64, np.float64)
    tf, tm = state.to_torch(f, mask, device="cpu")
    before = d2q9_kstep_manual.launches
    kw = dict(k_steps=2, accel_row=14, **KW)
    got = d2q9_kstep_manual.stepk(tf, tm, **kw)
    ref = d2q9_kstep.stepk_plain(tf, tm, **kw)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    one = d2q9_kstep_manual.step(tf, tm, **{k: v for k, v in kw.items() if k != "k_steps"})
    assert one[1].dim() == 0
    assert d2q9_kstep_manual.launches == before
    with pytest.raises(ValueError, match="multiple of k_steps"):
        d2q9_kstep_manual.run(tf, tm, num_steps=6, k_steps=4, accel_row=14, **KW)


@pytest.mark.parametrize("shape", [(64, 1001), (72, 130), (1024, 1001), (12, 128)])
def test_every_width_gets_a_tile(shape):
    """No tile of the candidates divides these grids: B1/B2 and B3 take the
    first tile that fits, and the last row and column of tiles are cut."""
    for dtype in (torch.float32, torch.float64):
        itemsize = torch.empty((), dtype=dtype).element_size()
        th, tw, k = d2q9_kstep.choose_config(*shape, dtype)
        assert (th, tw, k) == (16, 32, 4)
        assert d2q9_kstep.choose_tile(*shape, itemsize, 8) is not None
        th, tw, k = d2q9_kstep_manual.choose_config(*shape, dtype)
        assert d2q9_kstep_manual.smem_bytes(th, tw, k, itemsize) <= d2q9_kstep.SMEM_PER_BLOCK
        assert min(th, tw) >= k
    # every grid with sides of at least K goes to a kernel, whatever its height
    assert d2q9_kstep.choose_engine(*shape, free_bytes=1 << 40) == "cuda"


def test_manual_smem_bytes():
    # three buffers of 9 planes of 24x40 values, 2x8 reduction slots, two
    # mask stages of 960 bytes, 24 + 40 flag bytes: two blocks an SM
    assert d2q9_kstep_manual.smem_bytes(16, 32, 4, 4) == 3 * 9 * 960 * 4 + 64 + 2 * 960 + 64
    assert d2q9_kstep_manual.smem_bytes(16, 32, 4, 4) == 105728
    # buffers round up to 16 bytes: 9 x 34 x 18 float32 is 5,508 values
    assert d2q9_kstep_manual.smem_bytes(16, 32, 1, 4) == 3 * 5508 * 4 + 64 + 2 * 612 + 18 + 34
    # a region over 2,048 cells does not fit the mask registers
    assert d2q9_kstep_manual.smem_bytes(32, 64, 4, 4) > d2q9_kstep.SMEM_PER_BLOCK
    assert d2q9_kstep_manual.choose_config(1024, 1024, torch.float32) == (16, 32, 4)


def test_auto_on_a_width_no_tile_divides_matches_jax_auto():
    """`auto` on a 64x100 grid, which no tile divides: the port's
    cuda (its plain route on the CPU, where memory counts as ample) against
    the JAX package's own `auto` in float64."""
    p, obs = flagship_like(64, 100, steps=8)
    res = lbm.run_simulation(p, obs, engine="auto", dtype=torch.float64, device="cpu")
    assert res.engine == "cuda"
    with jax.enable_x64(True):
        jres = jlbm.run_simulation(*to_jax(p, obs), engine="auto", dtype=jnp.float64)
    assert rel(res.av_vels, jres.av_vels) <= 1e-12
    assert rel(res.f_final, jres.f_final) <= 1e-12
