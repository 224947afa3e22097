"""Exact-format `.dat` output writers / readers.

A copy of the numpy writers and readers of `lbm_tpu.core.io`; output files
are byte-identical to it for the same arrays. Formats:
  * av_vels.dat     — `<step>:\\t<%.12E>` per line
                      (main/LastChance.cpp:627-630)
  * final_state.dat — `x y u_x u_y u pressure obstacle` per cell, %.12E
                      floats (main/LastChance.cpp:571-616)

The obstacle column holds the correct flag (the original writer transposes
its index, main/LastChance.cpp:614); the checker compares only columns 0, 1
and 5. The writers go through the native C++ library (`native/lbmio.cpp`,
`utils.native_io`) when it loads, else through the pure-Python code below;
the bytes are the same either way. A native writer that fails raises
OSError.

A bfloat16 state (a host tensor, `state.host_state`) has its fields computed
per operation in bfloat16, as the JAX package computes them on an ml_dtypes
array, and written from their exact float32 values: the same bytes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .params import Params
from .state import macroscopics


def write_av_vels(path: str | Path, av_vels: np.ndarray) -> None:
    native = _try_native()
    if native is not None:
        native.write_av_vels(str(path), np.asarray(av_vels))
        return
    with open(path, "w") as fh:
        fh.writelines(f"{i}:\t{float(v):.12E}\n" for i, v in enumerate(np.asarray(av_vels)))


def read_av_vels(path: str | Path) -> np.ndarray:
    vals = []
    for line in Path(path).read_text().splitlines():
        if line:
            vals.append(float(line.split(":\t")[1]))
    return np.asarray(vals, dtype=np.float64)


def _fields_bf16(params: Params, obstacle_mask: np.ndarray, f: torch.Tensor):
    """`final_state_fields` of a host bfloat16 state: every operation in
    bfloat16, in numpy's order (the sum over speeds one speed after the
    other); float32 arrays of the results."""
    def c(x):
        return torch.tensor(x, dtype=torch.bfloat16)

    rho = f[0] + f[1] + f[2] + f[3] + f[4] + f[5] + f[6] + f[7] + f[8]
    u_x = (f[1] + f[5] + f[8] - (f[3] + f[6] + f[7])) / rho
    u_y = (f[2] + f[5] + f[6] - (f[4] + f[7] + f[8])) / rho
    u = torch.sqrt(u_x * u_x + u_y * u_y)
    c_sq = c(1.0) / c(3.0)
    pressure = rho * c_sq
    obs = torch.from_numpy(np.asarray(obstacle_mask, bool))
    zero = c(0.0)
    fields = (torch.where(obs, zero, u_x), torch.where(obs, zero, u_y), torch.where(obs, zero, u),
              torch.where(obs, c(params.density) * c_sq, pressure))
    return tuple(x.float().numpy() for x in fields)


def final_state_fields(params: Params, obstacle_mask: np.ndarray, f):
    """Per-cell (u_x, u_y, u, pressure) with obstacle-cell conventions applied."""
    if isinstance(f, torch.Tensor):
        return _fields_bf16(params, obstacle_mask, f)
    dtype = f.dtype
    _, u_x, u_y, u = macroscopics(f)
    rho = f.sum(axis=0, dtype=dtype)
    c_sq = np.asarray(1.0, dtype=dtype) / np.asarray(3.0, dtype=dtype)
    pressure = rho * c_sq
    obs_pressure = np.asarray(params.density, dtype=dtype) * c_sq
    zero = np.asarray(0.0, dtype=dtype)
    u_x = np.where(obstacle_mask, zero, u_x)
    u_y = np.where(obstacle_mask, zero, u_y)
    u = np.where(obstacle_mask, zero, u)
    pressure = np.where(obstacle_mask, obs_pressure, pressure)
    return u_x, u_y, u, pressure


def write_final_state_arrays(path: str | Path, u_x, u_y, u, pressure,
                             obstacle_mask) -> None:
    """Write per-cell fields in the final_state.dat row format
    (`x y u_x u_y u pressure obstacle`, %.12E). Native fast path when the
    library loads."""
    ny, nx = obstacle_mask.shape
    native = _try_native()
    if native is not None:
        native.write_final_state(str(path), u_x, u_y, u, pressure, obstacle_mask)
        return
    with open(path, "w") as fh:
        for jj in range(ny):
            ux_r, uy_r, u_r, p_r, o_r = u_x[jj], u_y[jj], u[jj], pressure[jj], obstacle_mask[jj]
            fh.writelines(
                f"{ii} {jj} {float(ux_r[ii]):.12E} {float(uy_r[ii]):.12E}"
                f" {float(u_r[ii]):.12E} {float(p_r[ii]):.12E} {int(o_r[ii])}\n"
                for ii in range(nx)
            )


def write_final_state(
    path: str | Path, params: Params, obstacle_mask: np.ndarray, f: np.ndarray
) -> None:
    u_x, u_y, u, pressure = final_state_fields(params, obstacle_mask, f)
    write_final_state_arrays(path, u_x, u_y, u, pressure, obstacle_mask)


def read_final_state(path: str | Path) -> np.ndarray:
    """Returns an (N, 7) float64 array of the final_state columns."""
    return np.loadtxt(path, dtype=np.float64, ndmin=2)


_NATIVE = None
_NATIVE_CHECKED = False


def _try_native():
    """The native I/O library (utils.native_io), built on first use; None
    when it cannot be built or loaded. Asked once a process."""
    global _NATIVE, _NATIVE_CHECKED
    if not _NATIVE_CHECKED:
        from ..utils import native_io

        _NATIVE_CHECKED = True
        _NATIVE = native_io.load()
    return _NATIVE
