"""Simulation-state checkpoint/resume.

The port's own copy of `lbm_tpu.core.checkpoint` (numpy only), with the same
`.npz` fields, so a checkpoint written by either package loads in the other.
A checkpoint is a single .npz holding the lattice, the av_vels emitted so
far, the step index and the grid signature. Resuming and running the
remaining steps is bit-identical to an uninterrupted run: every chunk runs
the same kernels in the same order, and their Sum|u| is reduced in a fixed
order (tests/test_torch_checkpoint.py, and chip_smoke.py on the card).

A bfloat16 lattice (a host tensor, `state.host_state`) is written as the JAX
package writes its ml_dtypes array: the bfloat16 bits as `|V2`. `load`
reads such an `f` back as a bfloat16 tensor, so a bfloat16 run resumes bit
for bit (the JAX package cannot cast `|V2` back and raises there).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .params import Params

FORMAT_VERSION = 1


@dataclasses.dataclass
class Checkpoint:
    f: np.ndarray          # (9, ny, nx) lattice at `step` (bfloat16: a tensor)
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


BF16_BITS = np.dtype("V2")  # how np.savez stores an ml_dtypes bfloat16 array


def lattice_array(f) -> np.ndarray:
    """The lattice as it goes into the file: a numpy array as it is, a
    bfloat16 tensor as its bits in `|V2`."""
    if isinstance(f, torch.Tensor):
        if f.dtype != torch.bfloat16:
            raise ValueError(f"a tensor lattice must be bfloat16, got {f.dtype}")
        return f.detach().cpu().contiguous().view(torch.int16).numpy().view(BF16_BITS)
    return np.asarray(f)


def lattice_of(a: np.ndarray):
    """The lattice of a file: `|V2` bits as a bfloat16 tensor, else as is."""
    if a.dtype == BF16_BITS:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return a


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
        Path(path), version=FORMAT_VERSION, f=lattice_array(f),
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
        ck = Checkpoint(f=lattice_of(z["f"]), av_vels=z["av_vels"], step=int(z["step"]),
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
    f: np.ndarray          # (19, nz, ny, nx) lattice at `step` (bfloat16: a tensor)
    av_vels: np.ndarray    # per-step av_vels for steps [0, step)
    step: int
    shape: tuple           # (nz, ny, nx)
    omega: float
    density: float
    accel: float


def save3d(path: str | Path, f: np.ndarray, av_vels: np.ndarray, step: int,
           *, omega: float, density: float, accel: float) -> None:
    """Atomic write, like `save`, with the 3-D grid/physics signature."""
    f = lattice_array(f)
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
            f=lattice_of(z["f"]), av_vels=z["av_vels"], step=int(z["step"]),
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
