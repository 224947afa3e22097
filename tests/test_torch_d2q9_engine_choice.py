"""How `auto` picks the 2-D engine in the port (d2q9_kstep.choose_engine and
models.lbm.choose_engine), on the CPU.

The rule: the fastest kernel engine whose simulation fits in free device
memory (d2q9_kstep.AUTO_ENGINES: B2, then B1, which holds half a lattice
less), on every grid with sides of at least PREFERRED_K, whatever its height
mod 8; a smaller grid runs on the plain engine. The byte counts are held to
the buffers the wrappers allocate, and `auto` on a grid whose height is not a
multiple of 8 is held to the JAX package's `jax` engine in float64 (1e-12
relative on av_vels and the final state, as the port's other f64 tests).
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
from lbm_tpu_torch.core.params import Obstacles, Params
from lbm_tpu_torch.models import lbm
from lbm_tpu_torch.ops import d2q9_kstep, d2q9_kstep_inplace

AMPLE = 1 << 40
GRIDS = [(1024, 1024), (4096, 4096), (1001, 64), (36, 64), (64, 1001)]


def lattice_bytes(h, w, dtype):
    return 9 * h * w * torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("h, w", GRIDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_grid_goes_to_the_fastest_kernel_that_fits(h, w, dtype):
    assert d2q9_kstep.AUTO_ENGINES == ("cuda", "cuda-inplace")
    assert d2q9_kstep.choose_engine(h, w, dtype, free_bytes=AMPLE) == "cuda"
    b2 = d2q9_kstep.simulate_bytes("cuda", h, w, dtype)
    b1 = d2q9_kstep.simulate_bytes("cuda-inplace", h, w, dtype)
    assert b1 < b2
    # just over, at and just under each kernel's need
    assert d2q9_kstep.choose_engine(h, w, dtype, free_bytes=b2) == "cuda"
    assert d2q9_kstep.choose_engine(h, w, dtype, free_bytes=b2 - 1) == "cuda-inplace"
    assert d2q9_kstep.choose_engine(h, w, dtype, free_bytes=b1 + 1) == "cuda-inplace"
    assert d2q9_kstep.choose_engine(h, w, dtype, free_bytes=b1) == "cuda-inplace"
    with pytest.raises(torch.OutOfMemoryError, match="needs"):
        d2q9_kstep.choose_engine(h, w, dtype, free_bytes=b1 - 1)


@pytest.mark.parametrize("h, w", [(3, 64), (64, 3), (1, 1)])
def test_a_side_under_k_runs_on_the_plain_engine(h, w):
    assert min(h, w) < d2q9_kstep.PREFERRED_K
    assert d2q9_kstep.choose_engine(h, w, free_bytes=AMPLE) == "torch"
    # the plain engine is not a kernel's: no memory is reckoned, nothing raises
    assert d2q9_kstep.choose_engine(h, w, free_bytes=0) == "torch"
    # the smallest grid that a kernel takes
    assert d2q9_kstep.choose_engine(4, 4, free_bytes=AMPLE) == "cuda"


@pytest.mark.parametrize("h, w", GRIDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_simulate_bytes_counts_what_the_wrappers_allocate(h, w, dtype):
    """B2's run: the caller's lattice, the first-accelerated copy and two
    ping-pong lattices; B1's: the two lattices and two boundary snapshots of
    the shapes its wrapper allocates (`_snapshot`); both the mask, the
    per-step sums and the partials."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    th, tw, k = d2q9_kstep.choose_config(h, w, dtype)
    steps = 100
    small = h * w + (steps + k * -(-h // th) * -(-w // tw)) * itemsize
    lattice = lattice_bytes(h, w, dtype)
    assert d2q9_kstep.simulate_bytes("cuda", h, w, dtype, steps) == 4 * lattice + small
    assert d2q9_kstep.simulate_bytes("cuda-manual", h, w, dtype, steps) == 4 * lattice + small
    f = torch.empty((9, h, w), dtype=dtype)
    snap = sum(t.numel() for t in d2q9_kstep_inplace._snapshot(f, (th, tw), k)) * itemsize
    assert d2q9_kstep.simulate_bytes("cuda-inplace", h, w, dtype, steps) == (
        2 * lattice + 2 * snap + small)
    with pytest.raises(ValueError, match="no kernel engine"):
        d2q9_kstep.simulate_bytes("torch", h, w, dtype)


def test_b1_saves_half_a_lattice_at_the_flagship_tile():
    """At 16x32, K=4 each snapshot is 2K/16 + 2K/32 = 0.75 of a lattice: B1
    holds 3.5 lattices against B2's 4."""
    lattice = lattice_bytes(1024, 1024, torch.float32)
    b2 = d2q9_kstep.simulate_bytes("cuda", 1024, 1024)
    b1 = d2q9_kstep.simulate_bytes("cuda-inplace", 1024, 1024)
    assert (b2 - b1) / lattice == 0.5
    # beside the lattices: the mask (1/36 of a lattice in float32) and a little
    assert 3.5 < b1 / lattice < 3.53 and 4.0 < b2 / lattice < 4.03


def test_the_model_never_asks_cuda_for_a_cpu_run():
    """On a CPU device memory counts as ample (this torch has no CUDA: a
    query would raise) and the rule picks B2's engine."""
    p = Params(nx=64, ny=36, max_iters=8, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    assert lbm.choose_engine(p, torch.float64, torch.device("cpu")) == "cuda"
    small = dataclasses.replace(p, ny=3)
    assert lbm.choose_engine(small, torch.float64, torch.device("cpu")) == "torch"


def flagship_like(ny, nx, steps):
    p = Params(nx=nx, ny=ny, max_iters=steps, reynolds_dim=10, density=0.1, accel=0.005,
               omega=1.85)
    mask = np.zeros((ny, nx), bool)
    mask[0, :] = mask[-1, :] = True
    mask[ny // 3: ny // 2, nx // 4: nx // 3] = True
    return p, Obstacles(mask)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("ny, nx, steps", [(36, 64, 12), (1001 // 11, 64, 8)])
def test_auto_on_a_height_not_a_multiple_of_8_matches_the_jax_engine(ny, nx, steps):
    """`auto` at 36x64 (and 91x64) runs a kernel engine, whose CPU route is
    its plain version, where the JAX package's `auto` would run eager `jax`:
    the two agree to 1e-12 in float64."""
    p, obs = flagship_like(ny, nx, steps)
    res = lbm.run_simulation(p, obs, engine="auto", dtype=torch.float64, device="cpu")
    assert res.engine == "cuda"
    with jax.enable_x64(True):
        jres = jlbm.run_simulation(JParams(**dataclasses.asdict(p)), JObstacles(obs.mask.copy()),
                                   engine="jax", dtype=jnp.float64)
    assert res.av_vels.shape == (steps,)
    assert rel(res.av_vels, jres.av_vels) <= 1e-12
    assert rel(res.f_final, jres.f_final) <= 1e-12
