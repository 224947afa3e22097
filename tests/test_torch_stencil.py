"""The blur engines of the port (lbm_tpu_torch.ops.stencil) on the CPU against
lbm_tpu.ops.stencil: the same numpy-seeded image through the JAX function
(its Pallas kernels in interpret mode, as tests/test_stencil.py runs them)
and through the port's.

On the CPU the wrappers `blur_step` (kernel B10), `blur_k` (B9) and
`blur_resident` (B8) run their kernels' plain version; the CUDA kernels are
held against those on the card by chip_smoke.py.

Tolerances: `blur_step_conv` float32 rtol 1e-5 (two convolution libraries
sum nine products in their own order); the kernels' plain versions against
the Pallas kernels float32 rtol 1e-6 / atol 1e-7 (the same operations in the
same order; XLA may contract a multiply-add) and bfloat16 one unit in the
last place (the two frameworks round to bfloat16 at the same points).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm_tpu.ops import stencil as ref
from lbm_tpu.utils import image as ref_image
from lbm_tpu_torch.ops import stencil

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@functools.lru_cache(maxsize=None)
def padded_case(h=30, w=126, seed=3):
    """An image that fills its padding: 30 x 126 -> 32 x 128, a ring of one."""
    chans = np.random.default_rng(seed).uniform(0, 1, size=(4, h, w)).astype(np.float32)
    padded, interior, _ = ref_image.pad_to_tile(chans)
    return padded, interior


@functools.lru_cache(maxsize=None)
def ringed_case(seed=5):
    """An image whose ring is NOT zero and whose mask has holes: only the
    periodic wraparound of the kernels gives the reference's answer."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, size=(4, 32, 128)).astype(np.float32)
    mask = (rng.uniform(size=(32, 128)) < 0.9).astype(np.float32)
    return img, mask


def to_jax(arrays, dname):
    return tuple(jnp.asarray(a, JAX_DTYPES[dname]) for a in arrays)


def to_torch(arrays, dname):
    return tuple(torch.from_numpy(a).to(TORCH_DTYPES[dname]) for a in arrays)


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def assert_agree(port_out, ref_out, dname):
    a, b = as_f32(port_out), as_f32(ref_out)
    assert a.shape == b.shape
    if dname == "float32":
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    else:
        # one unit in the last place of bfloat16: neighbouring bit patterns
        bits = [torch.from_numpy(v).bfloat16().view(torch.int16).to(torch.int32) for v in (a, b)]
        assert int((bits[0] - bits[1]).abs().max()) <= 1


def np_blur(padded, interior):
    """The reference's serial kernel in float64: zero outside, masked."""
    ext = np.pad(padded.astype(np.float64), ((0, 0), (1, 1), (1, 1)))
    acc = sum(ref.KERNEL[i, j] * ext[:, i:i + padded.shape[1], j:j + padded.shape[2]]
              for i in range(3) for j in range(3))
    return acc * interior


def test_kernel_weights_and_limits_match():
    np.testing.assert_array_equal(stencil.KERNEL, ref.KERNEL)
    assert stencil.MAX_PASSES_PER_SWEEP == ref.MAX_PASSES_PER_SWEEP == 8


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_blur_step_conv_matches_jax(dname):
    case = padded_case()
    out = stencil.blur_step_conv(*to_torch(case, dname))
    expected = ref.blur_step_conv(*to_jax(case, dname))
    assert out.dtype == TORCH_DTYPES[dname]
    if dname == "float32":
        np.testing.assert_allclose(as_f32(out), as_f32(expected), rtol=1e-5, atol=1e-7)
    else:
        # bfloat16 in, bfloat16 out: each library accumulates as it likes
        np.testing.assert_allclose(as_f32(out), as_f32(expected), atol=2 ** -7)
    np.testing.assert_array_equal(as_f32(out) * (1 - case[1]), 0.0)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_blur_step_matches_pallas(dname):
    case = padded_case()
    out = stencil.blur_step(*to_torch(case, dname))
    expected = ref.blur_step_pallas(*to_jax(case, dname), interpret=True)
    assert out.dtype == TORCH_DTYPES[dname]
    assert_agree(out, expected, dname)
    np.testing.assert_array_equal(as_f32(out) * (1 - case[1]), 0.0)


@pytest.mark.parametrize("k,dname", [(k, "float32") for k in (1, 2, 3, 4, 6, 8)]
                         + [(4, "bfloat16"), (8, "bfloat16")])
def test_blur_k_matches_pallas(k, dname):
    case = padded_case()
    out = stencil.blur_k(*to_torch(case, dname), k_passes=k)
    expected = ref.blur_k_pallas(*to_jax(case, dname), k_passes=k, interpret=True)
    assert out.dtype == TORCH_DTYPES[dname]
    assert_agree(out, expected, dname)
    np.testing.assert_array_equal(as_f32(out) * (1 - case[1]), 0.0)


@pytest.mark.parametrize("passes,dname", [(n, "float32") for n in (2, 6, 8)]
                         + [(6, "bfloat16")])
def test_blur_resident_matches_pallas(passes, dname):
    case = padded_case()
    out = stencil.blur_resident(*to_torch(case, dname), num_passes=passes)
    expected = ref.blur_resident(*to_jax(case, dname), num_passes=passes, interpret=True)
    assert out.dtype == TORCH_DTYPES[dname]
    assert_agree(out, expected, dname)


# the port's engine and k_passes beside the reference's
ENGINE_PAIRS = {
    "conv": (dict(engine="conv"), dict(engine="conv")),
    "cuda": (dict(engine="cuda"), dict(engine="pallas")),
    "cuda-k4": (dict(engine="cuda", k_passes=4), dict(engine="pallas", k_passes=4)),
    "cuda-k2-band8": (dict(engine="cuda", k_passes=2, band=8),
                      dict(engine="pallas", k_passes=2, band=8)),
    "resident": (dict(engine="resident"), dict(engine="resident")),
}


@pytest.mark.parametrize("name", list(ENGINE_PAIRS))
def test_blur_many_matches_jax(name):
    port_kw, ref_kw = ENGINE_PAIRS[name]
    case = padded_case(14, 62)
    out = stencil.blur_many(*to_torch(case, "float32"), num_iters=2, **port_kw)
    expected = ref.blur_many(*to_jax(case, "float32"), num_iters=2, **ref_kw)
    if name == "conv":
        np.testing.assert_allclose(as_f32(out), as_f32(expected), rtol=1e-5, atol=1e-7)
    else:
        assert_agree(out, expected, "float32")
    # and all of them blur: four passes of the serial kernel in float64
    oracle = case[0]
    for _ in range(4):
        oracle = np_blur(oracle, case[1])
    np.testing.assert_allclose(as_f32(out), oracle, rtol=1e-4, atol=1e-6)


def test_bfloat16_engines_round_at_different_points():
    """B10 rounds after every pass, B9 once per k, B8 once per run: in
    bfloat16 the engines differ by design, each as its reference does."""
    x, m = to_torch(padded_case(), "bfloat16")
    jx, jm = to_jax(padded_case(), "bfloat16")
    outs = {}
    for name in ("cuda", "cuda-k4", "resident"):
        port_kw, ref_kw = ENGINE_PAIRS[name]
        outs[name] = stencil.blur_many(x, m, num_iters=2, **port_kw)
        assert_agree(outs[name], ref.blur_many(jx, jm, num_iters=2, **ref_kw), "bfloat16")
    assert not torch.equal(outs["cuda"], outs["resident"])


PORT_KERNELS = {
    "step": (lambda x, m: stencil.blur_step(x, m),
             lambda x, m: ref.blur_step_pallas(x, m, interpret=True)),
    "k8": (lambda x, m: stencil.blur_k(x, m, k_passes=8),
           lambda x, m: ref.blur_k_pallas(x, m, k_passes=8, interpret=True)),
    "resident": (lambda x, m: stencil.blur_resident(x, m, num_passes=4),
                 lambda x, m: ref.blur_resident(x, m, num_passes=4, interpret=True)),
}


@pytest.mark.parametrize("name", list(PORT_KERNELS))
def test_non_zero_ring_wraps_as_the_reference_does(name):
    port_fn, ref_fn = PORT_KERNELS[name]
    case = ringed_case()
    out = port_fn(*to_torch(case, "float32"))
    assert_agree(out, ref_fn(*to_jax(case, "float32")), "float32")
    # the conv engine sees zeros outside, so here it must differ
    zero_outside = stencil.blur_step_conv(*to_torch(case, "float32"))
    assert not np.allclose(as_f32(stencil.blur_step(*to_torch(case, "float32"))),
                           as_f32(zero_outside), atol=1e-3)


def test_plain_versions_are_what_the_wrappers_run_on_the_cpu():
    x, m = to_torch(padded_case(), "float32")
    assert torch.equal(stencil.blur_step(x, m), stencil.blur_step_plain(x, m))
    assert torch.equal(stencil.blur_k(x, m, k_passes=3), stencil.blur_k_plain(x, m, k_passes=3))
    assert torch.equal(stencil.blur_resident(x, m, num_passes=4),
                       stencil.blur_resident_plain(x, m, num_passes=4))
    # the tile is a matter of the kernel alone
    assert torch.equal(stencil.blur_k(x, m, k_passes=3, band=8),
                       stencil.blur_k(x, m, k_passes=3, band=16))


def test_k_pass_and_engine_arguments_are_rejected_as_in_the_reference():
    x, m = to_torch(padded_case(14, 62), "float32")
    with pytest.raises(ValueError, match="k_passes must be in 1..8"):
        stencil.blur_k(x, m, k_passes=9)
    with pytest.raises(ValueError, match="k_passes must be in 1..8"):
        stencil.blur_k(x, m, k_passes=0)
    with pytest.raises(ValueError, match="k_passes 4 must divide 2\\*num_iters 6"):
        stencil.blur_many(x, m, num_iters=3, engine="cuda", k_passes=4)
    with pytest.raises(ValueError, match="at least two 8-row blocks"):
        stencil.blur_k(x[:, :8], m[:8], k_passes=2)
    with pytest.raises(ValueError, match="bad band"):
        stencil.blur_k(x, m, k_passes=2, band=0)
    with pytest.raises(ValueError, match="unknown engine"):
        stencil.blur_many(x, m, num_iters=1, engine="pallas")


def test_resident_rejects_odd_passes_and_oversized_images():
    x, m = to_torch(padded_case(14, 62), "float32")
    with pytest.raises(ValueError, match="pairs"):
        stencil.blur_resident(x, m, num_passes=3)
    big = torch.empty((4, 2048, 2048), device="meta")
    inter = torch.empty((2048, 2048), device="meta")
    assert not stencil.resident_fits(big)
    with pytest.raises(ValueError, match="resident engine.*engine='cuda'"):
        stencil.blur_resident(big, inter, num_passes=2)


@pytest.mark.parametrize("shape,fits", [((4, 320, 512), True), ((4, 32, 128), True),
                                        ((4, 768, 768), True), ((1, 1024, 2048), True),
                                        ((4, 1032, 896), False), ((4, 4128, 4224), False)])
def test_resident_fits_is_the_cards_own_predicate(shape, fits):
    """One tile per SM of an H100 (132, 227 KB each) at 12 bytes per value:
    the bricks shape fits, the leaf shape and 4096^2 do not."""
    assert stencil.resident_fits(torch.empty(shape, device="meta")) is fits
    assert stencil.resident_fits(torch.empty(shape, dtype=torch.bfloat16, device="meta")) is fits
    tile = stencil.resident_tiling(*shape)
    assert (tile is not None) is fits
    if fits:
        c, h, w = shape
        th, tw = tile
        assert c * -(-h // th) * -(-w // tw) <= stencil.H100_SMS
        assert stencil.resident_smem_bytes(th, tw) <= stencil.SMEM_PER_BLOCK
        assert tw <= stencil.RESIDENT_MAX_TILE_W


def test_resident_tiling_follows_the_device():
    # half the SMs hold half as much; a quarter of the shared memory too
    assert stencil.resident_tiling(4, 768, 768, 132, 232448) is not None
    assert stencil.resident_tiling(4, 768, 768, 64, 232448) is None
    assert stencil.resident_tiling(4, 768, 768, 132, 232448 // 4) is None
    assert stencil.resident_tiling(200, 8, 8, 132, 232448) is None  # more channels than SMs


def test_shared_memory_formulas():
    # B9: nine ring rows at k = 4 (k + 1 + 4), each with two 8-byte barriers
    # and the span of two windows (120 + 128 float32 columns) of the mask and
    # of each of four channels
    assert stencil.blur_k_smem_bytes(4, 2, 4) == 9 * (2 * 8 + 5 * 248 * 4)
    assert stencil.resident_smem_bytes(40, 128) == (2 * 42 * 130 + 40 * 128) * 4
    # a halo of k cells: the buffers k deep, the mask k - 1
    assert stencil.resident_smem_bytes(40, 128, 3) == (2 * 46 * 134 + 44 * 132) * 4
