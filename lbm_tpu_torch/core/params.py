"""Host data model: simulation parameters and obstacle masks.

A copy of `lbm_tpu.core.params` (the port imports nothing of `lbm_tpu`). File
formats are those of the original `lbm::Params` / `lbm::Obstacles`
(main/include/LbmParams.hpp:16-128), so its `params/*.params` and
`params/obstacles_*.dat` load unchanged. The obstacle reader takes the
native library's fast path (`utils.native_io`) where it is already built,
and the pure-Python reader otherwise, or where the native one refuses a
file (for the Python reader's precise error).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass(frozen=True)
class Params:
    """The 7-line text parameter file.

    Line order (main/LastChance.cpp:361-388):
      nx, ny, max_iters, reynolds_dim, density, accel, omega
    """

    nx: int
    ny: int
    max_iters: int
    reynolds_dim: int
    density: float
    accel: float
    omega: float

    @classmethod
    def from_file(cls, path: str | Path) -> "Params":
        lines = Path(path).read_text().split()
        if len(lines) < 7:
            raise ValueError(f"params file {path} must have 7 values, got {len(lines)}")
        return cls(
            nx=int(lines[0]),
            ny=int(lines[1]),
            max_iters=int(lines[2]),
            reynolds_dim=int(lines[3]),
            density=float(lines[4]),
            accel=float(lines[5]),
            omega=float(lines[6]),
        )

    def to_file(self, path: str | Path) -> None:
        Path(path).write_text(
            "\n".join(
                str(v)
                for v in (
                    self.nx,
                    self.ny,
                    self.max_iters,
                    self.reynolds_dim,
                    self.density,
                    self.accel,
                    self.omega,
                )
            )
            + "\n"
        )

    @property
    def one_minus_omega(self) -> float:
        return 1.0 - self.omega

    @property
    def viscosity(self) -> float:
        # nu = (2/omega - 1) / 6   (main/LastChance.cpp:531)
        return 1.0 / 6.0 * (2.0 / self.omega - 1.0)


class Obstacles:
    """Boolean obstacle mask of shape (ny, nx), row-major, True = blocked.

    File format: one `x y 1` triplet per line
    (main/include/LbmParams.hpp:92-128, main/LastChance.cpp:471-484).
    """

    def __init__(self, mask: np.ndarray):
        if mask.ndim != 2 or mask.dtype != np.bool_:
            raise ValueError("obstacle mask must be a 2-D bool array (ny, nx)")
        self.mask = mask

    @classmethod
    def from_file(cls, path: str | Path, params: Params) -> "Obstacles":
        from ..utils import native_io

        native = native_io.load(auto_build=False)
        if native is not None:
            try:
                return cls(native.read_obstacles(str(path), params.ny, params.nx))
            except ValueError:
                pass  # the Python reader names what is wrong
        mask = np.zeros((params.ny, params.nx), dtype=np.bool_)
        for line in Path(path).read_text().splitlines():
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 3:
                raise ValueError(f"expected 3 values per obstacle line, got: {line!r}")
            x, y, blocked = int(parts[0]), int(parts[1]), int(parts[2])
            if not (0 <= x < params.nx):
                raise ValueError(f"obstacle x-coord out of range: {x}")
            if not (0 <= y < params.ny):
                raise ValueError(f"obstacle y-coord out of range: {y}")
            if blocked != 1:
                raise ValueError(f"obstacle blocked value should be 1, got {blocked}")
            mask[y, x] = True
        return cls(mask)

    @classmethod
    def empty(cls, params: Params) -> "Obstacles":
        return cls(np.zeros((params.ny, params.nx), dtype=np.bool_))

    def to_file(self, path: str | Path) -> None:
        ys, xs = np.nonzero(self.mask)
        with open(path, "w") as fh:
            for y, x in zip(ys, xs):
                fh.write(f"{x} {y} 1\n")

    def at(self, x: int, y: int) -> bool:
        return bool(self.mask[y, x])

    @property
    def ny(self) -> int:
        return self.mask.shape[0]

    @property
    def nx(self) -> int:
        return self.mask.shape[1]

    @property
    def num_blocked(self) -> int:
        return int(self.mask.sum())

    @property
    def num_free(self) -> int:
        return int(self.mask.size - self.mask.sum())


def reynolds_number(params: Params, average_velocity: float) -> float:
    """Re = u * reynolds_dim / nu (main/LastChance.cpp:529-534)."""
    return average_velocity * params.reynolds_dim / params.viscosity
