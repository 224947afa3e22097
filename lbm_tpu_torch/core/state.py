"""Lattice state: initialisation and macroscopic quantities (host/numpy side).

A copy of the numpy helpers of `lbm_tpu.core.state`, plus `to_torch` and its
3-D counterpart `to_torch3d`, which hand a numpy state and mask to the port
as tensors on a chosen device.

A bfloat16 state lives on the host as a CPU tensor, not a numpy array: numpy
has no bfloat16 of its own (the JAX package takes ml_dtypes', which the port
does not need). `initial_distributions` makes one, per operation in
bfloat16 as ml_dtypes computes it, and `host_state` keeps a state so.

The distribution state is one array `f` of shape (9, ny, nx): the nine D2Q9
speed planes. Speed numbering follows the original serial kernel
(main/LastChance.cpp:7-13):

        6 2 5
         \\|/
        3-0-1
         /|\\
        7 4 8

i.e. 0=rest, 1=E, 2=N, 3=W, 4=S, 5=NE, 6=NW, 7=SW, 8=SE, with row index jj
increasing northwards and column index ii increasing eastwards.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import Params

NUM_SPEEDS = 9

# (drow, dcol) unit velocity of each speed, in (jj, ii) grid coordinates.
SPEED_VECTORS = np.array(
    [
        (0, 0),  # 0 rest
        (0, 1),  # 1 east
        (1, 0),  # 2 north
        (0, -1),  # 3 west
        (-1, 0),  # 4 south
        (1, 1),  # 5 north-east
        (1, -1),  # 6 north-west
        (-1, -1),  # 7 south-west
        (-1, 1),  # 8 south-east
    ],
    dtype=np.int32,
)

# Index of the opposite speed (for bounce-back rebound),
# matching main/LastChance.cpp:213-223.
OPPOSITE = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)


def initial_distributions(params: Params, dtype=np.float32):
    """Uniform-density initial state (main/LastChance.cpp:428-450).

    w0 = 4*rho/9 (rest), w1 = rho/9 (axis), w2 = rho/36 (diagonal). A numpy
    array, or for dtype=torch.bfloat16 a CPU tensor whose every operation
    rounds to bfloat16.
    """
    if dtype == torch.bfloat16:
        def c(x):
            return torch.tensor(x, dtype=torch.bfloat16)

        d = c(params.density)
        f = torch.empty((NUM_SPEEDS, params.ny, params.nx), dtype=torch.bfloat16)
        f[0] = d * c(4.0) / c(9.0)
        f[1:5] = d / c(9.0)
        f[5:9] = d / c(36.0)
        return f
    dtype = np.dtype(dtype)
    d = np.asarray(params.density, dtype=dtype)
    w0 = d * np.asarray(4.0, dtype) / np.asarray(9.0, dtype)
    w1 = d / np.asarray(9.0, dtype)
    w2 = d / np.asarray(36.0, dtype)
    f = np.empty((NUM_SPEEDS, params.ny, params.nx), dtype=dtype)
    f[0] = w0
    f[1:5] = w1
    f[5:9] = w2
    return f


def macroscopics(f: np.ndarray):
    """Per-cell density, u_x, u_y, |u| from a (9, ny, nx) state, in the
    expression grouping of main/LastChance.cpp:227-231."""
    rho = f[0] + f[1] + f[2] + f[3] + f[4] + f[5] + f[6] + f[7] + f[8]
    u_x = (f[1] + f[5] + f[8] - (f[3] + f[6] + f[7])) / rho
    u_y = (f[2] + f[5] + f[6] - (f[4] + f[7] + f[8])) / rho
    u = np.sqrt(u_x * u_x + u_y * u_y)
    return rho, u_x, u_y, u


def average_velocity(f: np.ndarray, obstacle_mask: np.ndarray) -> float:
    """Mean |u| over non-obstacle cells (main/LastChance.cpp:290-339)."""
    _, _, _, u = macroscopics(f)
    free = ~obstacle_mask
    return float(u[free].sum() / free.sum())


def total_density(f) -> float:
    """Conserved quantity check (main/LastChance.cpp:536-552); f a numpy
    array or a host bfloat16 tensor (`host_state`)."""
    if isinstance(f, torch.Tensor):
        f = f.float().numpy()  # exact: every bfloat16 is a float32
    return float(f.sum(dtype=np.float64))


def host_state(f: torch.Tensor):
    """A state tensor on the host as the port keeps it there: a numpy array,
    or a CPU tensor for bfloat16, which numpy cannot hold."""
    f = f.detach().cpu()
    return f if f.dtype == torch.bfloat16 else f.numpy()


def as_host(f, dtype):
    """A host state (numpy array or bfloat16 tensor) in `dtype`: a numpy
    type, or torch.bfloat16 (rounding to nearest, as numpy's cast does)."""
    if dtype == torch.bfloat16:
        return (f if isinstance(f, torch.Tensor) else torch.from_numpy(np.asarray(f))).to(
            torch.bfloat16)
    if isinstance(f, torch.Tensor):
        f = f.float().numpy()
    return np.asarray(f, dtype)


def _to_tensors(f_np, mask_np, speeds: int, axes: str, *, device, dtype):
    if f_np.ndim != axes.count(",") + 2 or f_np.shape[0] != speeds:
        raise ValueError(f"state must have shape ({speeds}, {axes}), got {f_np.shape}")
    if tuple(mask_np.shape) != tuple(f_np.shape[1:]):
        raise ValueError(f"mask shape {mask_np.shape} != grid {f_np.shape[1:]}")
    if isinstance(f_np, torch.Tensor):  # a host bfloat16 state
        f = f_np.detach().to(device=device, copy=True).contiguous()
    else:
        f = torch.tensor(np.ascontiguousarray(f_np), device=device)
    if dtype is not None:
        f = f.to(dtype)
    mask = torch.tensor(np.ascontiguousarray(mask_np, dtype=np.bool_), device=device)
    return f, mask


def to_torch(f_np: np.ndarray, mask_np: np.ndarray, *, device, dtype=None):
    """(9, ny, nx) numpy state (or host bfloat16 tensor) and (ny, nx)
    obstacle mask -> the port's tensors on `device`: the state in `dtype`
    (default: its own dtype) and the mask as bool. Both are contiguous
    copies."""
    return _to_tensors(f_np, mask_np, NUM_SPEEDS, "ny, nx", device=device, dtype=dtype)


def to_torch3d(f_np: np.ndarray, mask_np: np.ndarray, *, device, dtype=None):
    """The D3Q19 counterpart of `to_torch`: (19, nz, ny, nx) numpy state and
    (nz, ny, nx) obstacle mask."""
    return _to_tensors(f_np, mask_np, 19, "nz, ny, nx", device=device, dtype=dtype)
