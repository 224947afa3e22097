"""Plain PyTorch D2Q9 BGK: the reference of the 2-D cells.

The semantics of the original serial kernel (main/LastChance.cpp of
thorbenlouw/lbm-graphcore): a uniform start state at rest, one guarded
acceleration of row ny-2 before the loop, then each step a periodic pull
stream, bounce-back on obstacle cells, the BGK collision in the rearranged
c_sq = 1 - 1.5 u^2 form with the body force on row ny-2, and Sum|u| over the
free cells. av_vels is Sum|u| over the number of free cells. Every
operation rounds on its own, in the serial kernel's grouping, and divides
where it divides.

Speeds (row jj grows northwards, column ii eastwards):

        6 2 5
         \\|/
        3-0-1
         /|\\
        7 4 8

FLOP per cell update of `step`, counted line by line in its code (one for
each add, subtract, negation, multiply, divide and square root; the Sum|u|
reduction as one add a cell):

    rho                         8 adds                          8
    u_x, u_y                    4 adds, 1 subtract, 1 divide    12
    u_sq                        2 multiplies, 1 add             3
    c_sq                        1 multiply, 1 subtract          2
    ld0, ld1, ld2               2 operations each               6
    u_s, u_d                    1 add; 1 negation, 1 add        3
    out0                        2 multiplies, 1 add             3
    out1 .. out8                7 operations each               56
    |u|, Sum|u|                 1 square root, 1 add            2
                                                                --
                                                                95

plus ROW_FLOP on each cell of the accelerated row (the body force), which
the roofline leaves out: a lower bound stays one.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lattice

# (drow, dcol) of each speed, and the index of its opposite
E = ((0, 0), (0, 1), (1, 0), (0, -1), (-1, 0), (1, 1), (1, -1), (-1, -1), (-1, 1))
OPPOSITE = (0, 3, 4, 1, 2, 7, 8, 5, 6)
FLOP_PER_UPDATE = 95
ROW_FLOP = 6


def initial_state(ny: int, nx: int, density: float, storage: torch.dtype, device) -> torch.Tensor:
    """Uniform density at rest: 4/9, 1/9 and 1/36 of the density, each
    computed in the storage type (float8, which has no arithmetic, in
    float32 and rounded)."""
    arith = storage if storage in (torch.float32, torch.float64, torch.bfloat16) else torch.float32

    def c(x):
        return torch.tensor(x, dtype=arith, device=device)

    d = c(density)
    f = torch.empty((9, ny, nx), dtype=arith, device=device)
    f[0] = d * c(4.0) / c(9.0)
    f[1:5] = d / c(9.0)
    f[5:9] = d / c(36.0)
    return f.to(storage)


def first_accelerate(f: torch.Tensor, obstacle: torch.Tensor, row: int, w1: float,
                     w2: float) -> torch.Tensor:
    """The one guarded acceleration of `row` before the loop: cells whose
    west-moving densities would go negative are skipped. In the storage
    type's arithmetic (float8's in float32, then rounded)."""
    arith = f.dtype if f.dtype in (torch.float32, torch.float64, torch.bfloat16) else torch.float32
    g = f.to(arith).clone()
    a1 = torch.tensor(w1, dtype=arith, device=f.device)
    a2 = torch.tensor(w2, dtype=arith, device=f.device)
    r = g[:, row, :]
    ok = (~obstacle[row]) & (r[3] - a1 > 0) & (r[6] - a2 > 0) & (r[7] - a2 > 0)
    zero = torch.zeros((), dtype=arith, device=f.device)
    d1 = torch.where(ok, a1, zero)
    d2 = torch.where(ok, a2, zero)
    for k, d in ((1, d1), (3, -d1), (5, d2), (6, -d2), (7, -d2), (8, d2)):
        g[k, row] = g[k, row] + d
    return g.to(f.dtype)


def make_step(obstacle: torch.Tensor, *, omega: float, w1: float, w2: float, row: int,
              dtype: torch.dtype):
    """The step of `dtype` states on the grid of `obstacle` (bool): a
    function of a (9, ny, nx) state to (the next state, Sum|u|)."""
    dev = obstacle.device

    def c(x):
        return torch.tensor(x, dtype=dtype, device=dev)

    omm, om = c(1.0 - omega), c(omega)
    one, k15, k45, km45, two3 = c(1.0), c(1.5), c(4.5), c(-4.5), c(2.0 / 3.0)
    four9, nine, thirty6 = c(4.0 / 9.0), c(9.0), c(36.0)
    a1, a2 = c(w1), c(w2)
    zero = c(0.0)

    def step(f):
        s = [f[0]] + [torch.roll(f[k], E[k], dims=(0, 1)) for k in range(1, 9)]
        s0, s1, s2, s3, s4, s5, s6, s7, s8 = s
        rho = s0 + s1 + s2 + s3 + s4 + s5 + s6 + s7 + s8
        u_x = (s1 + s5 + s8 - (s3 + s6 + s7)) / rho
        u_y = (s2 + s5 + s6 - (s4 + s7 + s8)) / rho
        u_sq = u_x * u_x + u_y * u_y
        c_sq = one - u_sq * k15
        ld0 = four9 * rho * om
        ld1 = rho / nine * om
        ld2 = rho / thirty6 * om
        u_s = u_x + u_y
        u_d = -u_x + u_y
        out = [
            s0 * omm + ld0 * c_sq,
            s1 * omm + ld1 * ((k45 * u_x) * (two3 + u_x) + c_sq),
            s2 * omm + ld1 * ((k45 * u_y) * (two3 + u_y) + c_sq),
            s3 * omm + ld1 * ((km45 * u_x) * (two3 - u_x) + c_sq),
            s4 * omm + ld1 * ((km45 * u_y) * (two3 - u_y) + c_sq),
            s5 * omm + ld2 * ((k45 * u_s) * (two3 + u_s) + c_sq),
            s6 * omm + ld2 * ((k45 * u_d) * (two3 + u_d) + c_sq),
            s7 * omm + ld2 * ((km45 * u_s) * (two3 - u_s) + c_sq),
            s8 * omm + ld2 * ((km45 * u_d) * (two3 - u_d) + c_sq),
        ]
        for k, sign in ((1, 1), (3, -1), (5, 1), (6, -1), (7, -1), (8, 1)):
            a = a1 if k in (1, 3) else a2
            out[k][row] = out[k][row] + a if sign > 0 else out[k][row] - a
        g = torch.empty_like(f)
        for k in range(9):
            torch.where(obstacle, s[OPPOSITE[k]], out[k], out=g[k])
        speed = torch.where(obstacle, zero, torch.sqrt(u_sq))
        return g, speed.sum()

    return step


def solve(*, ny: int, nx: int, steps: int, density: float, accel: float, omega: float,
          mask: np.ndarray, storage: torch.dtype, store_every: int, device):
    """A whole job from its host inputs: the start state, the first
    acceleration and `steps` steps, stored as `storage`. Returns (the final
    state as `storage`, av_vels as float64), on `device`."""
    obstacle = torch.as_tensor(np.ascontiguousarray(mask, dtype=np.bool_), device=device)
    row = ny - 2
    w1, w2 = density * accel / 9.0, density * accel / 36.0
    f = first_accelerate(initial_state(ny, nx, density, storage, device), obstacle, row, w1, w2)
    compute = lattice.compute_dtype(storage)
    step = make_step(obstacle, omega=omega, w1=w1, w2=w2, row=row, dtype=compute)
    f, tots = lattice.run(step, f, steps=steps, storage=storage, store_every=store_every)
    free = int((~obstacle).sum())
    return f, tots.double() / free


def speed(f: torch.Tensor, obstacle: torch.Tensor) -> torch.Tensor:
    """|u| of each cell of a state, in float64, 0 on obstacle cells: sums
    over the speeds in their order, cell by cell, so a cell's |u| does not
    depend on the cells around it (`compare` takes blocks of rows)."""
    f = f.double()
    s0, s1, s2, s3, s4, s5, s6, s7, s8 = f
    rho = s0 + s1 + s2 + s3 + s4 + s5 + s6 + s7 + s8
    u_x = (s1 + s5 + s8 - s3 - s6 - s7) / rho
    u_y = (s2 + s5 + s6 - s4 - s7 - s8) / rho
    return torch.where(obstacle, 0.0, torch.sqrt(u_x * u_x + u_y * u_y))
