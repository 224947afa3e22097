"""Simulation-state checkpoint/resume.

The port's own copy of `lbm_tpu.core.checkpoint` (numpy only), with the same
`.npz` fields, so a checkpoint written by either package loads in the other.
A checkpoint is a single .npz holding the lattice, the av_vels emitted so
far, the step index and the grid signature. Resuming and running the
remaining steps is bit-identical to an uninterrupted run: every chunk runs
the same kernels in the same order, and their Sum|u| is reduced in a fixed
order (tests/test_torch_checkpoint.py, and chip_smoke.py on the card).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .params import Params

FORMAT_VERSION = 1


@dataclasses.dataclass
class Checkpoint:
    f: np.ndarray          # (9, ny, nx) lattice at `step`
    av_vels: np.ndarray    # per-step av_vels for steps [0, step)
    step: int
    params: Params
    # K the writing engine chunked at (kernel engines; 0/None = not
    # applicable or a checkpoint without the field). Resume continues at the
    # same K, as the reference does.
    k_steps: int | None = None

    @property
    def steps_done(self) -> int:
        return self.step


def _atomic_savez(path: Path, **arrays) -> None:
    """tmp-write + rename: a crash mid-save never corrupts the previous
    checkpoint. (np.savez appends .npz to names without it — handled.)"""
    tmp = path.with_suffix(path.suffix + ".tmp")
    np.savez(tmp, **arrays)
    written = tmp if tmp.exists() else tmp.with_suffix(tmp.suffix + ".npz")
    written.replace(path)


def save(path: str | Path, f: np.ndarray, av_vels: np.ndarray, step: int,
         params: Params, k_steps: int | None = None) -> None:
    _atomic_savez(
        Path(path), version=FORMAT_VERSION, f=np.asarray(f),
        av_vels=np.asarray(av_vels, np.float64), step=int(step),
        nx=params.nx, ny=params.ny, max_iters=params.max_iters,
        reynolds_dim=params.reynolds_dim, density=params.density,
        accel=params.accel, omega=params.omega,
        k_steps=int(k_steps or 0),
    )


def load(path: str | Path, expect: Params | None = None) -> Checkpoint:
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        if str(z.get("kind", "")) == "d3q19":
            raise ValueError(
                f"{path} is a 3-D (d3q19) checkpoint — load it with "
                "checkpoint.load3d / the lbm3d CLI")
        params = Params(
            nx=int(z["nx"]), ny=int(z["ny"]), max_iters=int(z["max_iters"]),
            reynolds_dim=int(z["reynolds_dim"]), density=float(z["density"]),
            accel=float(z["accel"]), omega=float(z["omega"]),
        )
        recorded_k = int(z["k_steps"]) if "k_steps" in z.files else 0
        ck = Checkpoint(f=z["f"], av_vels=z["av_vels"], step=int(z["step"]),
                        params=params, k_steps=recorded_k or None)
    if expect is not None and any(
        getattr(params, k) != getattr(expect, k)
        for k in ("nx", "ny", "omega", "density", "accel", "reynolds_dim")
    ):
        raise ValueError(
            f"checkpoint grid/physics ({params}) does not match the "
            f"requested run ({expect})"
        )
    return ck


# ---------------------------------------------------------------------------
# 3-D (D3Q19) checkpoints — same atomic format, 3-D grid signature
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Checkpoint3D:
    f: np.ndarray          # (19, nz, ny, nx) lattice at `step`
    av_vels: np.ndarray    # per-step av_vels for steps [0, step)
    step: int
    shape: tuple           # (nz, ny, nx)
    omega: float
    density: float
    accel: float


def save3d(path: str | Path, f: np.ndarray, av_vels: np.ndarray, step: int,
           *, omega: float, density: float, accel: float) -> None:
    """Atomic write, like `save`, with the 3-D grid/physics signature."""
    f = np.asarray(f)
    _atomic_savez(
        Path(path), version=FORMAT_VERSION, kind="d3q19", f=f,
        av_vels=np.asarray(av_vels, np.float64), step=int(step),
        nz=f.shape[1], ny=f.shape[2], nx=f.shape[3],
        omega=omega, density=density, accel=accel,
    )


def load3d(path: str | Path, expect_shape: tuple | None = None,
           expect_physics: tuple | None = None) -> Checkpoint3D:
    """expect_shape=(nz,ny,nx), expect_physics=(omega,density,accel):
    mismatches raise rather than silently continuing a different run."""
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        if str(z.get("kind", "")) != "d3q19":
            raise ValueError(f"{path} is not a 3-D (d3q19) checkpoint")
        ck = Checkpoint3D(
            f=z["f"], av_vels=z["av_vels"], step=int(z["step"]),
            shape=(int(z["nz"]), int(z["ny"]), int(z["nx"])),
            omega=float(z["omega"]), density=float(z["density"]),
            accel=float(z["accel"]),
        )
    if expect_shape is not None and tuple(expect_shape) != ck.shape:
        raise ValueError(f"checkpoint grid {ck.shape} != requested {tuple(expect_shape)}")
    if expect_physics is not None and tuple(expect_physics) != (
            ck.omega, ck.density, ck.accel):
        raise ValueError(
            f"checkpoint physics (omega,density,accel)="
            f"{(ck.omega, ck.density, ck.accel)} != requested {tuple(expect_physics)}")
    return ck
