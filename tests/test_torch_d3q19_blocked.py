"""The blocked D3Q19 K-step wrappers of the port
(lbm_tpu_torch.ops.d3q19_kstep_blocked, kernel B7, and
d3q19_kstep_inplace_blocked, kernel B5) on the CPU, against the JAX Pallas
(z, y)-blocked kernels run in interpret mode
(lbm_tpu.ops.d3q19_pallas.stepk(by=8) and
d3q19_pallas_inplace_blocked.stepk), as tests/test_d3q19_inplace_blocked.py
runs them, at its sizes (8x16x128 and 16x32x128, bz 4, by 8).

On the CPU the wrappers run their kernels' plain version,
`d3q19_kstep.stepk_plain`; the CUDA kernels themselves are held against it on
the card by chip_smoke.py.

Tolerances (max abs difference over max abs value): float32 <= 1e-5 on state
and Sum|u|. The Pallas kernels keep Sum|u| in float32 and do not run in
float64, so the float64 case holds the wrappers to K steps of the JAX engine
`lbm_tpu.ops.d3q19.run` instead, at <= 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import d3q19 as j3
from lbm_tpu.ops import d3q19_pallas
from lbm_tpu.ops import d3q19_pallas_inplace_blocked as jblk
from lbm_tpu_torch.core import state
from lbm_tpu_torch.ops import (d3q19, d3q19_kstep, d3q19_kstep_blocked as b7,
                               d3q19_kstep_inplace, d3q19_kstep_inplace_blocked as b5,
                               d3q19_lattice)
from lbm_tpu_torch.parallel import kstep_sharded_3d as ks3

KW = dict(omega=1.85, density=0.1, accel=0.005)
# each port function and the JAX Pallas function it is held against
PAIRS = {
    "b7": (b7.stepk, d3q19_pallas.stepk),
    "b5": (b5.stepk, jblk.stepk),
}
MODS = {"b7": b7, "b5": b5}
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def make_case(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    f = d3q19_lattice.initial_distributions(*shape, 0.1, np.float64)
    f = (f * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, f.shape))).astype(dtype)
    mask = rng.uniform(size=shape) < 0.05
    mask[0] = mask[-1] = True
    return f, mask


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@functools.lru_cache(maxsize=None)
def pallas_result(jax_fn, shape, seed, kw_items):
    """One interpret-mode run of a blocked Pallas kernel (bz 4, by 8)."""
    f, mask = make_case(np.float32, shape, seed)
    jf, jt = jax_fn(jnp.asarray(f), jnp.asarray(mask.astype(np.float32)), bz=4, by=8,
                    interpret=True, **dict(kw_items))
    return np.asarray(jf), np.asarray(jt)


def compare_float32(name, shape, k, seed=0, jax_fn=None, **window):
    port_fn, pair_fn = PAIRS[name]
    f, mask = make_case(np.float32, shape, seed)
    kw = dict(k_steps=k, accel_plane=window.pop("accel_plane", shape[0] - 2), **KW, **window)
    jf, jt = pallas_result(jax_fn or pair_fn, shape, seed, tuple(sorted(kw.items())))
    tf, tm = state.to_torch3d(f, mask, device="cpu")
    pf, pt = port_fn(tf, tm, **kw)
    assert pt.shape == (k,)
    assert rel(pf.numpy(), jf) <= 1e-5
    assert rel(pt.numpy(), jt) <= 1e-5


@pytest.mark.parametrize("shape, k", [((8, 16, 128), 1), ((8, 16, 128), 2), ((16, 32, 128), 2)])
@pytest.mark.parametrize("name", list(PAIRS))
def test_stepk_float32_matches_pallas(name, shape, k):
    compare_float32(name, shape, k)


@pytest.mark.parametrize("name", list(PAIRS))
def test_stepk_ghost_window_matches_pallas(name):
    """A ghost-extended block: local plane p is global plane p + 4 of a
    16-plane grid, so the accelerated plane 8 is local plane 4, more than K
    planes from both ends (where the TPU kernels' unwrapped halo test and the
    port's wrapped one agree), and only planes [2, 6) x rows [2, 6) count."""
    compare_float32(name, (8, 16, 128), 2, seed=2, plane_offset=4, valid_planes=(2, 6),
                    valid_rows=(2, 6), global_nz=16, accel_plane=8)


@pytest.mark.parametrize("name", list(PAIRS))
def test_stepk_k3_matches_the_inplace_pallas_kernel(name):
    """K=3 has no two-stream Pallas counterpart (it needs k | bz); both
    wrappers are held to the in-place blocked kernel, which only needs
    k <= bz."""
    compare_float32(name, (8, 16, 128), 3, seed=3, jax_fn=jblk.stepk)


@pytest.mark.parametrize("name", list(PAIRS))
def test_stepk_float64_matches_the_jax_engine(name):
    shape = (8, 16, 128)
    f, mask = make_case(np.float64, shape, seed=1)
    with jax.enable_x64(True):
        amask = j3.accel_plane_mask(*shape, shape[0] - 2, dtype=np.float64)
        jf, jt = j3.run(jnp.asarray(f), jnp.asarray(mask), amask, num_steps=3, **KW)
        jf, jt = np.asarray(jf), np.asarray(jt)
    tf, tm = state.to_torch3d(f, mask, device="cpu")
    pf, pt = PAIRS[name][0](tf, tm, k_steps=3, accel_plane=shape[0] - 2, **KW)
    assert pf.dtype == torch.float64 and pt.dtype == torch.float64
    assert rel(pf.numpy(), jf) <= 1e-12
    assert rel(pt.numpy(), jt) <= 1e-12


def test_inplace_stepk_overwrites_its_input():
    shape = (8, 16, 128)
    f, mask = make_case(np.float32, shape)
    tf, tm = state.to_torch3d(f, mask, device="cpu")
    kw = dict(k_steps=2, accel_plane=shape[0] - 2, **KW)
    expected, _ = d3q19_kstep.stepk_plain(tf, tm, **kw)
    ptr = tf.data_ptr()
    out, _ = b5.stepk(tf, tm, **kw)
    assert out is tf and tf.data_ptr() == ptr
    assert torch.equal(tf, expected)
    # the two-stream wrapper leaves its input alone
    tf2, _ = state.to_torch3d(f, mask, device="cpu")
    out2, _ = b7.stepk(tf2, tm, **kw)
    assert out2.data_ptr() != tf2.data_ptr() and torch.equal(out2, expected)
    np.testing.assert_array_equal(tf2.numpy(), f)


@pytest.mark.parametrize("name", list(MODS))
def test_run_equals_the_plain_engine(name):
    """K-step passes of the plain version are K single steps: `run` over 8
    steps on the CPU equals the plain engine bit for bit, at every K."""
    shape = (8, 16, 32)
    f, mask = make_case(np.float64, shape)
    tf, tm = state.to_torch3d(f, mask, device="cpu")
    amask = d3q19.accel_plane_mask(*shape, shape[0] - 2, dtype=tf.dtype)
    ref_f, ref_t = d3q19.run(tf, tm, amask, num_steps=8, **KW)
    for k in (1, 2, 4):
        got_f, got_t = MODS[name].run(tf.clone(), tm, num_steps=8, k_steps=k,
                                      accel_plane=shape[0] - 2, **KW)
        assert torch.equal(got_f, ref_f) and torch.equal(got_t, ref_t)
    with pytest.raises(ValueError, match="multiple of k_steps"):
        MODS[name].run(tf, tm, num_steps=8, k_steps=3, accel_plane=6, **KW)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("name", list(MODS))
def test_choose_config_fits_an_h100(name, dname, k):
    """On the CPU the tile is sized for an H100's 227 KB a block."""
    dtype = DTYPES[dname]
    tile = MODS[name].choose_config(32, 256, 256, k, dtype, "cpu")
    assert min(tile) >= 1
    need = b7.shared_bytes(tile, k, dtype)
    assert need == b7.extended_cells(tile, k) * (19 * (4 if dname == "float32" else 8) + 1)
    assert need + b7.STATIC_SMEM <= 227 * 1024 == b7.smem_per_block("cpu")
    if name == "b5":
        # ring and snapshot stay under 0.45 of the lattice, so a run peaks
        # under 1.5 x (lattice + mask)
        assert sum(b7.scratch_planes(tile, k, 32)) <= int(0.45 * 32)
        lag = -(-k // tile[0])
        assert b7.scratch_planes(tile, k, 32) == ((lag + 2) * tile[0], k)


def test_choose_config_follows_the_grid_and_the_device(monkeypatch):
    # a shallow, narrow grid gets a tile no larger than itself
    tz, ty, tx = b7.choose_config(3, 5, 8, 2)
    assert tz <= 3 and ty <= 5 and tx == 8
    big = b7.choose_config(32, 256, 256, 2)
    assert b7.loaded_per_kept(big, 2) < b7.loaded_per_kept((2, 2, 8), 2)
    # less shared memory, smaller tile; next to none raises and names the engines
    monkeypatch.setattr(b7, "smem_per_block", lambda device: 48 * 1024)
    small = b7.choose_config(32, 256, 256, 2)
    # each on the path its launch takes (the box path's buffer is smaller)
    assert (b7.block_bytes(32, 256, 256, small, 2) <= 48 * 1024 - b7.STATIC_SMEM
            < b7.block_bytes(32, 256, 256, big, 2))
    monkeypatch.setattr(b7, "smem_per_block", lambda device: 4 * 1024)
    with pytest.raises(ValueError, match="no tile of the blocked kernel fits.*engine='cuda'"):
        b7.choose_config(32, 256, 256, 2)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="k_steps must be in 1..4"):
        b7.choose_config(32, 256, 256, 5)
    # a shallow grid may spend more than 0.45 of itself on the ring
    assert b5.max_scratch_planes(8, 2) == 10 and b5.max_scratch_planes(64, 2) == 28
    tile = b5.choose_config(8, 256, 256, 2)
    assert sum(b7.scratch_planes(tile, 2, 8)) <= 10


@pytest.mark.parametrize("step_counts", [(1200,), (600, 300), (100,), (7,), (9, 3), (6000,)])
def test_the_engine_names_route_to_the_one_step_kernels(step_counts):
    """The one route from a 3-D engine name to a kernel: 'cuda' is B6 and
    'cuda-inplace' B4, both at the one-step kernels' K, and the sharded
    engines' local kernel 'inplace' is B4, whatever the run (the blocked
    sweep found B7 and B5 the slower at every K, so they run only when
    named)."""
    k = d3q19_kstep.choose_k(*step_counts)
    assert d3q19.resolve_engine("cuda", step_counts) == (d3q19_kstep.run, "slab", k, {})
    assert (d3q19.resolve_engine("cuda-inplace", step_counts)
            == (d3q19_kstep_inplace.run, "slab", k, {}))
    assert ks3.local_kernel("inplace") is d3q19_kstep_inplace.stepk
    assert ks3.local_kernel("two-stream") is d3q19_kstep.stepk


@pytest.mark.parametrize("step_counts, k, k_blocked", [((1200,), 4, 2), ((600, 300), 4, 2),
                                                       ((100,), 4, 2), ((7,), 1, 1),
                                                       ((9, 3), 3, 1)])
def test_choose_k_gates_k_by_the_step_counts(step_counts, k, k_blocked):
    """The slab kind runs at the one-step kernels' K (`d3q19_kstep.choose_k`:
    K = 4 preferred since their wave path), the blocked pair at its own."""
    assert d3q19.resolve_engine("cuda-inplace", step_counts)[1:3] == ("slab", k)
    assert d3q19.resolve_engine("cuda", step_counts)[1:3] == ("slab", k)
    assert d3q19.resolve_engine("cuda-inplace-blocked", step_counts)[1:3] == ("blocked",
                                                                             k_blocked)
    assert d3q19_kstep.choose_k(*step_counts) == k
    assert b7.choose_k(*step_counts) == k_blocked
    assert all(n % k == 0 and n % k_blocked == 0 for n in step_counts)
    assert 1 <= b7.PREFERRED_K <= d3q19_kstep.MAX_K and b5.PREFERRED_K == b7.PREFERRED_K


@pytest.mark.parametrize("engine, mod", [("cuda-blocked", b7), ("cuda-inplace-blocked", b5)])
def test_resolve_engine_forces_the_blocked_pair(engine, mod):
    run_fn, kind, k, extra = d3q19.resolve_engine(engine, (1200, 300))
    assert run_fn is mod.run and kind == "blocked" and k == b7.choose_k(1200, 300)
    assert extra == dict(tile=None)
    assert d3q19.resolve_engine(engine, (9,), k_steps=3)[2] == 3
    with pytest.raises(ValueError, match="no feasible kernel configuration"):
        d3q19.resolve_engine(engine, (10,), k_steps=3)
    with pytest.raises(ValueError, match="unknown engine"):
        d3q19.resolve_engine("pallas-blocked", (10,))
    family = d3q19.resolve_engine(engine[:-len("-blocked")], (1200,))
    assert family[1] == "slab" and family[2] == d3q19_kstep.choose_k(1200)


@pytest.mark.parametrize("name", list(MODS))
def test_kernel_path_checks_its_arguments(name):
    """A tensor that is not on the CPU goes to the kernel's checks (never to
    the plain version), which refuse what the kernel does not take."""
    mod = MODS[name]
    f = torch.empty((19, 4, 8, 32), device="meta")
    mask = torch.empty((4, 8, 32), dtype=torch.bool, device="meta")
    before = mod.launches
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        mod.stepk(f, mask, k_steps=2, accel_plane=2, **KW)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        mod.run(f, mask, num_steps=4, k_steps=2, accel_plane=2, **KW)
    assert mod.launches == before


def test_kernel_args_refuse_what_the_kernel_does_not_take(monkeypatch):
    """The checks past the device test, reached here by letting a CPU tensor
    through it."""
    monkeypatch.setattr(d3q19_kstep, "check_state", lambda f, mask_u8, k_steps: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    f = torch.zeros((19, 8, 16, 32))
    mask = torch.zeros((8, 16, 32), dtype=torch.uint8)
    kw = dict(k_steps=2, accel_plane=6, **KW)
    tile, ntiles, scalars = b7.kernel_args(f, mask, tile=(4, 6, 16), **kw)
    assert tile == (4, 6, 16) and ntiles == 2 * 3 * 2
    assert scalars[:8] == [8, 16, 32, 4, 6, 16, 512, 2] and len(scalars) == 23
    with pytest.raises(ValueError, match="shared memory.*engine='cuda'"):
        b7.kernel_args(f, mask, tile=(8, 16, 32), **kw)
    with pytest.raises(ValueError, match="positive extents"):
        b7.kernel_args(f, mask, tile=(0, 4, 16), **kw)
    with pytest.raises(ValueError, match="threads must be a multiple of 32"):
        b7.kernel_args(f, mask, tile=(4, 4, 16), threads=48, **kw)
    with pytest.raises(ValueError, match="threads must be a multiple of 32"):
        b7.kernel_args(f.double(), mask, tile=(2, 2, 8), threads=512, **kw)
