"""Torus-roll slice algebra: a 2-D periodic roll expressed as region copies.

The port's numpy-only copy of `lbm_tpu.utils.roll_slices`: the reference's
DoubleRoll.hpp (determineSrcAndDstSlices + doubleRolledCopy,
main/include/DoubleRoll.hpp:42-127) decomposed a (+-1, +-1) torus roll of a
2-D tensor into up to 4 contiguous region copies. `torch.roll` does the same
on the card, so this module serves the tooling that wants the explicit region
map (e.g. predicting inter-shard copy volumes) and the reference's
table-driven unit tests (test/lbm/main.cpp:116-412).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RegionCopy:
    """One contiguous block copy: dst[dst_rows, dst_cols] = src[src_rows, src_cols].
    All ranges half-open."""

    src_rows: tuple[int, int]
    src_cols: tuple[int, int]
    dst_rows: tuple[int, int]
    dst_cols: tuple[int, int]


def _axis_splits(n: int, shift: int) -> list[tuple[tuple[int, int], tuple[int, int]]]:
    """1-D roll by `shift` in {-1, 0, 1} (or any |shift| < n) as (src, dst)
    range pairs."""
    shift %= n
    if shift == 0:
        return [((0, n), (0, n))]
    # dst[shift:] = src[:n-shift]; dst[:shift] = src[n-shift:]
    return [
        ((0, n - shift), (shift, n)),
        ((n - shift, n), (0, shift)),
    ]


def determine_src_dst_slices(
    shape: tuple[int, int], roll: tuple[int, int]
) -> list[RegionCopy]:
    """All region copies implementing dst = roll(src, roll) on a (ny, nx)
    grid — 1, 2 or 4 regions depending on how many axes roll
    (reference: determineSrcAndDstSlices, DoubleRoll.hpp:42-94)."""
    ny, nx = shape
    out = []
    for (sr, dr) in _axis_splits(ny, roll[0]):
        for (sc, dc) in _axis_splits(nx, roll[1]):
            out.append(RegionCopy(sr, sc, dr, dc))
    return out


def rolled_copy(src: np.ndarray, roll: tuple[int, int]) -> np.ndarray:
    """Apply the region copies (the doubleRolledCopy analogue). Equivalent to
    np.roll(src, roll, axis=(0, 1)) — asserted by the test suite."""
    dst = np.empty_like(src)
    for rc in determine_src_dst_slices(src.shape[:2], roll):
        dst[rc.dst_rows[0] : rc.dst_rows[1], rc.dst_cols[0] : rc.dst_cols[1]] = (
            src[rc.src_rows[0] : rc.src_rows[1], rc.src_cols[0] : rc.src_cols[1]]
        )
    return dst


def copy_volumes(shape: tuple[int, int], roll: tuple[int, int]) -> list[int]:
    """Cells moved by each region copy — what the tooling uses to predict
    shard-boundary traffic."""
    return [
        (rc.src_rows[1] - rc.src_rows[0]) * (rc.src_cols[1] - rc.src_cols[0])
        for rc in determine_src_dst_slices(shape, roll)
    ]
