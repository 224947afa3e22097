"""The resident-blur variants of the port (lbm_tpu_torch.ops.blur_resident_opt,
kernel B13) on the CPU, against the TPU kernels they replace: the eight
bodies of experiments/blur-resident-opt/run.py, loaded from that file by its
path and built through `pl.pallas_call(..., interpret=True)` in place of the
file's `_vmem_call` (on the loaded module object; the file is not edited).

Every factor of a pass is a power of two and the port adds in each body's
order, rounding to bfloat16 where the body does, so each variant equals its
interpret-mode kernel bit for bit, in float32 and bfloat16 I/O.
"""

import ast
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lbm_tpu_torch.ops import blur_resident_opt as bro
from lbm_tpu_torch.ops import stencil

REPO = Path(__file__).resolve().parent.parent
RUN = REPO / "experiments" / "blur-resident-opt" / "run.py"
HARNESS = REPO / "experiments" / "cuda-kstep-tiles" / "blur_resident_opt.py"
SMALL = ((4, 24, 40), (20, 35))
ODD = ((3, 19, 27), (15, 22))  # three channels: v2's halo is 3 columns
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the study's images at 132 SMs x 232,448 B: (tile, bytes a block) of each
# variant, None where it does not fit (the table of the resident-blur slice;
# the mask is held in the state's type, so v3 needs 6 B a value)
BRICKS = ((4, 304, 512), (302, 499))
LEAF = ((4, 1032, 896), (1024, 768))
FIT_TABLE = {
    "bricks": {"v0-roll": ((28, 171), 60_672), "v1-concat": ((28, 171), 60_672),
               "v2-rank2": ((7, 683), 68_876), "v3-bf16": ((28, 171), 30_336),
               "v4-folded": ((28, 171), 60_672), "v5-ringzero": ((28, 171), 41_520),
               "v6-bf16-fold": ((28, 171), 20_760), "v7-bf16-arith": ((28, 171), 20_760)},
    "leaf": {"v0-roll": None, "v1-concat": None, "v2-rank2": None,
             "v3-bf16": ((94, 299), 171_796), "v4-folded": None,
             "v5-ringzero": ((94, 299), 231_168), "v6-bf16-fold": ((94, 299), 115_584),
             "v7-bf16-arith": ((94, 299), 115_584)},
}


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret_call(kernel, shape, dtype, scratch):
    """run.py's `_vmem_call` in interpret mode."""
    return pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(shape, dtype),
        scratch_shapes=scratch,
        interpret=True,
    )


@functools.lru_cache(maxsize=None)
def run_py():
    mod = load(RUN, "blur_resident_opt_run")
    mod._vmem_call = _interpret_call
    return mod


def case(shape, hw0):
    """run.py main's image and interior: default_rng(0).random x interior."""
    (c, h, w), (h0, w0) = shape, hw0
    interior = np.zeros((h, w), np.float32)
    interior[1:1 + h0, 1:1 + w0] = 1
    return np.random.default_rng(0).random((c, h, w)).astype(np.float32) * interior, interior


@functools.lru_cache(maxsize=None)
def tpu_call(variant, dname, shape, hw0):
    """The interpret-mode kernel, jitted once: its pass count is a runtime
    scalar, as on the TPU."""
    img, interior = case(shape, hw0)
    x = jnp.asarray(img, DTYPES[dname][0])
    call, layout = run_py().build(variant, x, hw0)
    return jax.jit(call), layout


def tpu_kernel(variant, dname, shape, hw0, n):
    img, interior = case(shape, hw0)
    c, h, w = shape
    x, m = jnp.asarray(img, DTYPES[dname][0]), jnp.asarray(interior, DTYPES[dname][0])
    call, layout = tpu_call(variant, dname, shape, hw0)
    if layout == "rank2":
        x, m = jnp.transpose(x, (1, 2, 0)).reshape(h, w * c), jnp.repeat(m, c, axis=1)
    return np.asarray(call(jnp.asarray([n], jnp.int32), x, m).astype(jnp.float32))


def port(variant, dname, shape, hw0, n):
    img, interior = case(shape, hw0)
    x = torch.from_numpy(img).to(DTYPES[dname][1])
    m = torch.from_numpy(interior).to(DTYPES[dname][1])
    call, layout = bro.build(variant, x, hw0)
    if layout == "rank2":
        x, m = bro.to_rank2(x).contiguous(), bro.rank2_interior(m, shape[0])
    out = call(n, x, m)
    assert out.dtype == x.dtype and out.shape == x.shape
    return out.float().numpy()


def test_variants_are_run_py_s():
    """VARIANTS is run.py main's list, letter for letter and in order, and
    build's table has the same names."""
    tree = ast.parse(RUN.read_text())
    lists = [ast.literal_eval(node.value) for node in ast.walk(tree)
             if isinstance(node, ast.Assign) and any(
                 isinstance(t, ast.Name) and t.id == "variants" for t in node.targets)]
    assert lists == [list(bro.VARIANTS)]
    tables = [[ast.literal_eval(k) for k in node.value.keys] for node in ast.walk(tree)
              if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
              and any(isinstance(t, ast.Name) and t.id == "table" for t in node.targets)]
    assert tables == [list(bro.VARIANTS)] and list(bro.SPECS) == list(bro.VARIANTS)


@pytest.mark.parametrize("n", [0, 2, 6, 7])
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("variant", bro.VARIANTS)
def test_variant_is_bit_equal_to_the_tpu_kernel(variant, dname, n):
    ref = tpu_kernel(variant, dname, *SMALL, n)
    np.testing.assert_array_equal(port(variant, dname, *SMALL, n), ref)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("variant", bro.VARIANTS)
def test_three_channels_at_odd_sides_are_bit_equal(variant, dname):
    ref = tpu_kernel(variant, dname, *ODD, 6)
    np.testing.assert_array_equal(port(variant, dname, *ODD, 6), ref)


@pytest.mark.parametrize("variant", bro.VARIANTS)
def test_an_odd_pass_count_runs_one_pass_fewer(variant):
    """run.py's `_pingpong` runs n // 2 pairs: 7 passes are 6, not 8."""
    seven, six, eight = (port(variant, "float32", *SMALL, n) for n in (7, 6, 8))
    np.testing.assert_array_equal(seven, six)
    assert not np.array_equal(seven, eight)
    assert not np.array_equal(six, port(variant, "float32", *SMALL, 4))


@pytest.mark.parametrize("dname", list(DTYPES))
def test_v0_and_v1_are_b8(dname):
    """v0 and v1 share B8's instance: equal to stencil.blur_resident, which
    raises on the odd count that the variants round down."""
    img, interior = case(*SMALL)
    x = torch.from_numpy(img).to(DTYPES[dname][1])
    m = torch.from_numpy(interior).to(DTYPES[dname][1])
    b8 = stencil.blur_resident(x, m, num_passes=6)
    for variant in ("v0-roll", "v1-concat"):
        assert bro.SPECS[variant].instance == "v0"
        call, _ = bro.build(variant, x, SMALL[1])
        assert torch.equal(call(7, x, m), b8)
    with pytest.raises(ValueError, match="even"):
        stencil.blur_resident(x, m, num_passes=7)


@pytest.mark.parametrize("shape", [(4, 24, 40), (3, 19, 27), (1, 5, 7)])
def test_to_rank2_round_trips(shape):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    c, h, w = shape
    x2 = bro.to_rank2(torch.from_numpy(img))
    np.testing.assert_array_equal(x2.numpy(), img.transpose(1, 2, 0).reshape(h, w * c))
    back = bro.from_rank2(x2, c)
    assert back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(), img)
    mask = img[0] > 0.5
    np.testing.assert_array_equal(bro.rank2_interior(torch.from_numpy(mask), c).numpy(),
                                  np.repeat(mask, c, axis=1))


@pytest.mark.parametrize("dname", list(DTYPES))
def test_v2_is_v0_in_the_other_layout(dname):
    v0 = port("v0-roll", dname, *ODD, 6)
    v2 = port("v2-rank2", dname, *ODD, 6)
    np.testing.assert_array_equal(bro.from_rank2(torch.from_numpy(v2), ODD[0][0]).numpy(), v0)


@pytest.mark.parametrize("variant", bro.VARIANTS)
@pytest.mark.parametrize("image", list(FIT_TABLE))
def test_fit_table_at_132_sms(image, variant):
    shape, hw0 = {"bricks": BRICKS, "leaf": LEAF}[image]
    want = FIT_TABLE[image][variant]
    tile = bro.tiling(variant, *shape, 132, 232_448)
    if want is None:
        assert tile is None
        x = torch.zeros(shape, dtype=torch.bfloat16)  # a CPU tensor: the H100's figures
        with pytest.raises(ValueError, match=f"{bro.needed_bytes(variant, *shape):,} B"):
            bro.build(variant, x, hw0)
        assert bro.needed_bytes(variant, *shape) > 232_448
        return
    assert (tile, bro.resident_bytes(variant, tile, shape[0])) == want
    call, _ = bro.build(variant, torch.zeros(shape, dtype=torch.bfloat16), hw0)
    # a block holds a halo as deep as the passes it runs between exchanges
    assert call.tile == tile and call.blocks <= 132
    assert call.block_bytes == bro.resident_bytes(variant, tile, shape[0], call.depth) <= 232_448


def b8_tiling(c, h, w, sms=132, smem=232_448):
    """B8's tiling rule as B8 states it, written out on its own: one block
    per SM at most, 12 B a value and a 1-cell halo, the fewest cells a
    block, then the shortest edges."""
    best = None
    for rows in range(1, min(h, sms // c) + 1):
        th = -(-h // rows)
        for cols in range(1, min(w, sms // c // -(-h // th)) + 1):
            tw = -(-w // cols)
            nbytes = (2 * (th + 2) * (tw + 2) + th * tw) * 4
            if tw > 1021 or (th + 2) * (tw + 2) >= 65536 or nbytes > smem:
                continue
            if best is None or (th * tw, th + tw) < best[0]:
                best = ((th * tw, th + tw), (th, tw))
    return None if best is None else best[1]


@pytest.mark.parametrize("shape", [(4, 304, 512), (4, 320, 512), (3, 37, 53), (1, 8, 9)])
def test_v0_tiles_as_b8(shape):
    """B8 is v0's instance and takes its tiles from v0's rule, which is
    B8's own: bytes a block and tile as B8 states them."""
    tile = bro.tiling("v0-roll", *shape)
    assert stencil.resident_tiling(*shape) == tile == b8_tiling(*shape)
    th, tw = tile
    assert stencil.resident_smem_bytes(th, tw) == (2 * (th + 2) * (tw + 2) + th * tw) * 4


def test_rank2_tiles_hold_the_column_halo():
    """The last tile of a rank-2 row is at least C columns wide, so that a
    neighbour's halo comes from one tile."""
    for c, h, w in [(3, 19, 27), (4, 24, 40), (3, 37, 53), (4, 304, 512)]:
        th, tw = bro.tiling("v2-rank2", c, h, w)
        width = w * c
        assert tw >= c and width - (-(-width // tw) - 1) * tw >= c
        assert tw + 2 * c <= bro.MAX_ROW


def test_harness_inputs_are_run_py_main_s():
    """The harness makes run.py main's images and long-run pass counts."""
    harness = load(HARNESS, "cuda_kstep_tiles_blur_resident_opt")
    assert harness.IMAGES == {"bricks": BRICKS, "leaf": LEAF}
    img, interior = harness.study_case(*BRICKS)
    ref_img, ref_int = case(*BRICKS)
    np.testing.assert_array_equal(img, ref_img)
    np.testing.assert_array_equal(interior, ref_int)
    # run.py: n_hi = n_lo + 2 * (max(4000, int(1.8e10 / n_vals)) // 2)
    assert harness.N_LO == 2000
    assert harness.n_hi(4 * 304 * 512) == 2000 + 28_910
    assert harness.n_hi(4 * 1032 * 896) == 2000 + 4_866
    assert harness.FLOP_PER_VALUE["v0-roll"] == stencil_flops()


def stencil_flops():
    """chip_smoke's FLOP_PER_VALUE_SEPARABLE, B8's count a value and pass."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    return next(ast.literal_eval(node.value) for node in ast.walk(tree)
                if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "FLOP_PER_VALUE_SEPARABLE"
                    for t in node.targets))


def test_build_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((4, 24, 40))
    with pytest.raises(ValueError, match="unknown variant"):
        bro.build("v8-fast", x, (20, 35))
    with pytest.raises(ValueError, match=r"\(C, H, W\)"):
        bro.build("v0-roll", x[0], (20, 35))
    call, _ = bro.build("v0-roll", x, (20, 35))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        call(2, x.double(), torch.zeros((24, 40), dtype=torch.float64))
    with pytest.raises(ValueError, match="interior"):
        call(2, x, torch.zeros((24, 40), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="shape"):
        call(2, bro.to_rank2(x), torch.zeros((24, 160)))
