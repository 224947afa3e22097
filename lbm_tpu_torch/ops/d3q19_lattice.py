"""D3Q19 lattice constants and state initialisation (numpy; a bfloat16
state as a torch tensor).

The port's own copy of `lbm_tpu.ops.d3q19_lattice`; `initial_distributions`
of the two packages are bit-equal for the same arguments.

Axis order (z, y, x); speed k has unit velocity E[k] = (dz, dy, dx).
Weights: 1/3 (rest), 1/18 (6 axis), 1/36 (12 edge). The CUDA kernels
(csrc/d3q19_kstep.cu) carry the same table.
"""

from __future__ import annotations

import numpy as np
import torch

_E = [(0, 0, 0)]
_E += [(0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0), (1, 0, 0), (-1, 0, 0)]
_E += [
    (0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1),
    (1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1),
    (1, 1, 0), (1, -1, 0), (-1, 1, 0), (-1, -1, 0),
]
E = np.array(_E, dtype=np.int32)  # (19, 3) as (dz, dy, dx)
W = np.array([1 / 3] + [1 / 18] * 6 + [1 / 36] * 12)
OPPOSITE = np.array(
    [int(np.where((E == -E[k]).all(axis=1))[0][0]) for k in range(19)],
    dtype=np.int32,
)
NUM_SPEEDS = 19


def initial_distributions(nz: int, ny: int, nx: int, density: float = 0.1,
                          dtype=np.float32) -> np.ndarray:
    """Uniform state at rest: speed k holds density * W[k] everywhere. For
    dtype=torch.bfloat16 a CPU tensor (numpy has no bfloat16), each value
    rounded from the double product."""
    if dtype == torch.bfloat16:
        f = torch.empty((NUM_SPEEDS, nz, ny, nx), dtype=torch.bfloat16)
        for k in range(NUM_SPEEDS):
            f[k] = torch.tensor(density * W[k], dtype=torch.bfloat16)
        return f
    dtype = np.dtype(dtype).type
    f = np.empty((NUM_SPEEDS, nz, ny, nx), dtype=dtype)
    for k in range(NUM_SPEEDS):
        f[k] = dtype(density * W[k])
    return f
