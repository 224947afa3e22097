"""PNG image I/O and float conversions for the blur workload.

The port's own copy of `lbm_tpu.utils.image` (numpy only; the port imports
nothing of `lbm_tpu`): load_png/save_png through PIL, per-channel min/max
normalisation, the zero ghost ring, and `pad_to_tile`, which keeps the
reference's alignment (rows to `row_mult`, columns to 128) so that both
packages blur arrays of one shape.

`to_char_image` renormalises with `(v - min) / (max - min)` in a
channels-first layout, as the reference package does.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

NUM_CHANNELS = 4  # RGBA


@dataclasses.dataclass
class FloatImage:
    """Channels-first float image (C, H, W) in [0,1] plus the original
    per-channel intensity ranges for denormalisation."""

    intensities: np.ndarray  # (C, H, W) float32
    orig_chan_min: np.ndarray  # (C,)
    orig_chan_max: np.ndarray  # (C,)

    @property
    def height(self) -> int:
        return self.intensities.shape[1]

    @property
    def width(self) -> int:
        return self.intensities.shape[2]


def load_png(path: str | Path) -> np.ndarray:
    """Returns (H, W, 4) uint8 RGBA."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def save_png(path: str | Path, rgba: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(rgba.astype(np.uint8), mode="RGBA").save(path)


def to_float_image(rgba: np.ndarray, dtype=np.float32) -> FloatImage:
    """Per-channel min/max normalisation to [0,1], channels-first."""
    chans = rgba.astype(np.float32).transpose(2, 0, 1)  # (C, H, W)
    mn = chans.min(axis=(1, 2))
    mx = chans.max(axis=(1, 2))
    span = np.where(mx > mn, mx - mn, 1.0)
    out = (chans - mn[:, None, None]) / span[:, None, None]
    out = np.where((mx == mn)[:, None, None], 0.0, out)
    return FloatImage(
        intensities=out.astype(dtype),
        orig_chan_min=mn,
        orig_chan_max=mx,
    )


def to_char_image(img: FloatImage) -> np.ndarray:
    """Rescale back to the original intensity ranges, channels-last uint8."""
    f = img.intensities.astype(np.float32)
    mn = f.min(axis=(1, 2))
    mx = f.max(axis=(1, 2))
    span = np.where(mx > mn, mx - mn, 1.0)
    rescaled = (f - mn[:, None, None]) / span[:, None, None]
    rescaled = np.where((mx == mn)[:, None, None], 0.0, rescaled)
    orig_span = (img.orig_chan_max - img.orig_chan_min)[:, None, None]
    vals = rescaled * orig_span + img.orig_chan_min[:, None, None]
    vals = np.clip(vals, 0.0, 255.0)
    return vals.transpose(1, 2, 0).round().astype(np.uint8)


def zero_pad(chans: np.ndarray, pad: int = 1) -> np.ndarray:
    """Zero ghost ring around each channel."""
    return np.pad(chans, ((0, 0), (pad, pad), (pad, pad)))


def strip_padding(chans: np.ndarray, pad: int = 1) -> np.ndarray:
    return chans[:, pad:-pad, pad:-pad]


def pad_to_tile(chans: np.ndarray, row_mult: int = 8, col_mult: int = 128,
                pad: int = 1) -> tuple[np.ndarray, np.ndarray, tuple[int, int]]:
    """Zero-pad (C, H, W) to (C, Hp, Wp) with at least a 1-cell ghost ring,
    Hp a multiple of row_mult and Wp of col_mult, plus an interior {0,1}
    mask. The extra zeros stay zero under the masked stencil, so the
    alignment padding changes no result."""
    c, h, w = chans.shape
    hp = -(-(h + 2 * pad) // row_mult) * row_mult
    wp = -(-(w + 2 * pad) // col_mult) * col_mult
    out = np.zeros((c, hp, wp), dtype=chans.dtype)
    out[:, pad : pad + h, pad : pad + w] = chans
    interior = np.zeros((hp, wp), dtype=chans.dtype)
    interior[pad : pad + h, pad : pad + w] = 1
    return out, interior, (h, w)
