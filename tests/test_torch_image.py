"""The port's image helpers (lbm_tpu_torch.utils.image) against their twins in
lbm_tpu.utils.image: the same numpy-seeded input through both, results equal
exactly (both are numpy code), PNG round trip included."""

import dataclasses

import numpy as np
import pytest

from lbm_tpu.utils import image as ref
from lbm_tpu_torch.utils import image as port


def rgba_case(seed, h=20, w=30, constant_channel=None):
    rng = np.random.default_rng(seed)
    rgba = rng.integers(10, 250, size=(h, w, 4), dtype=np.uint8)
    if constant_channel is not None:
        rgba[..., constant_channel] = 77
    return rgba


def test_module_constants_and_dataclass_match():
    assert port.NUM_CHANNELS == ref.NUM_CHANNELS
    assert ([f.name for f in dataclasses.fields(port.FloatImage)]
            == [f.name for f in dataclasses.fields(ref.FloatImage)])


@pytest.mark.parametrize("constant_channel", [None, 3])
def test_to_float_image_matches(constant_channel):
    rgba = rgba_case(1, constant_channel=constant_channel)
    a, b = port.to_float_image(rgba), ref.to_float_image(rgba)
    np.testing.assert_array_equal(a.intensities, b.intensities)
    np.testing.assert_array_equal(a.orig_chan_min, b.orig_chan_min)
    np.testing.assert_array_equal(a.orig_chan_max, b.orig_chan_max)
    assert a.intensities.dtype == np.float32
    assert (a.height, a.width) == (b.height, b.width) == (20, 30)


@pytest.mark.parametrize("constant_channel", [None, 0])
def test_to_char_image_matches_and_round_trips(constant_channel):
    rgba = rgba_case(2, constant_channel=constant_channel)
    f = port.to_float_image(rgba)
    back = port.to_char_image(f)
    np.testing.assert_array_equal(
        back, ref.to_char_image(ref.FloatImage(f.intensities, f.orig_chan_min,
                                               f.orig_chan_max)))
    if constant_channel is None:
        np.testing.assert_allclose(back.astype(int), rgba.astype(int), atol=1)


def test_to_char_image_on_a_blurred_range_matches():
    rng = np.random.default_rng(3)
    f = port.to_float_image(rgba_case(3))
    squeezed = (0.2 + 0.5 * rng.uniform(size=f.intensities.shape)).astype(np.float32)
    a = port.to_char_image(port.FloatImage(squeezed, f.orig_chan_min, f.orig_chan_max))
    b = ref.to_char_image(ref.FloatImage(squeezed, f.orig_chan_min, f.orig_chan_max))
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.uint8 and a.shape == (20, 30, 4)


@pytest.mark.parametrize("pad", [1, 2])
def test_zero_pad_and_strip_padding_match(pad):
    chans = np.random.default_rng(4).uniform(size=(4, 7, 9)).astype(np.float32)
    padded = port.zero_pad(chans, pad)
    np.testing.assert_array_equal(padded, ref.zero_pad(chans, pad))
    np.testing.assert_array_equal(port.strip_padding(padded, pad), chans)
    np.testing.assert_array_equal(port.strip_padding(padded, pad),
                                  ref.strip_padding(padded, pad))


@pytest.mark.parametrize("shape,row_mult", [((4, 30, 126), 8), ((4, 30, 126), 32),
                                            ((4, 302, 499), 32), ((3, 17, 130), 8)])
def test_pad_to_tile_matches(shape, row_mult):
    chans = np.random.default_rng(5).uniform(size=shape).astype(np.float32)
    a = port.pad_to_tile(chans, row_mult=row_mult)
    b = ref.pad_to_tile(chans, row_mult=row_mult)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2] == shape[1:]
    padded, interior, (h, w) = a
    assert padded.shape[1] % row_mult == 0 and padded.shape[2] % 128 == 0
    assert interior.sum() == h * w
    np.testing.assert_array_equal(padded * (1 - interior), 0.0)


def test_png_round_trip_through_both_packages(tmp_path):
    rgba = np.random.default_rng(6).integers(0, 255, size=(12, 17, 4), dtype=np.uint8)
    port.save_png(tmp_path / "port.png", rgba)
    ref.save_png(tmp_path / "ref.png", rgba)
    for name in ("port.png", "ref.png"):
        np.testing.assert_array_equal(port.load_png(tmp_path / name), rgba)
        np.testing.assert_array_equal(ref.load_png(tmp_path / name), rgba)


def test_load_png_converts_to_rgba(tmp_path):
    from PIL import Image

    grey = np.random.default_rng(7).integers(0, 255, size=(5, 6), dtype=np.uint8)
    Image.fromarray(grey, mode="L").save(tmp_path / "grey.png")
    a, b = port.load_png(tmp_path / "grey.png"), ref.load_png(tmp_path / "grey.png")
    np.testing.assert_array_equal(a, b)
    assert a.shape == (5, 6, 4) and a.dtype == np.uint8
