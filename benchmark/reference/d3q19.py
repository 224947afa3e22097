"""Plain PyTorch D3Q19 BGK: the reference of the 3-D cells.

A channel between wall planes (bounce-back on the obstacle cells), periodic
elsewhere, driven by a body force on the plane z = nz-2: each step a
periodic pull stream, bounce-back, the BGK collision and the force, and
Sum|u| over the free cells; av_vels is Sum|u| over the number of free cells.
The collision takes the paired grouping of the JAX package's D3Q19 step,
which the serial C++ oracle and the committed float64 traces carry: each
pair of opposite speeds shares e.u, the quadratic term and the weight's
omega * rho product.

State (19, nz, ny, nx), axes (z, y, x); speed k moves by E[k] = (dz, dy,
dx). Weights 1/3 (rest), 1/18 (axes), 1/36 (edges).

FLOP per cell update of `step`, counted line by line in its code (one for
each add, subtract, negation, multiply, divide and square root; the Sum|u| reduction
as one add a cell):

    rho                         18 adds                         18
    u_x, u_y, u_z               9 adds or subtracts, 1 divide   30
    u_sq                        3 multiplies, 2 adds            5
    c_sq                        1 multiply, 1 subtract          2
    (w omega) rho               1 multiply a weight class       3
    out0                        2 multiplies, 1 add             3
    3 axis pairs                e.u none; 12 each               36
    6 edge pairs                e.u 1 (3 of them 2: a negation  81
                                and an add); 12 each
      (quad 3, lin 1, out_k 4, out_kb 4)
    |u|, Sum|u|                 1 square root, 1 add            2
                                                                ---
                                                                180

plus PLANE_FLOP on each cell of the accelerated plane (the force on the
five pairs that move along x), which the roofline leaves out.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lattice

E = ((0, 0, 0),
     (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0), (1, 0, 0), (-1, 0, 0),
     (0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1),
     (1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1),
     (1, 1, 0), (1, -1, 0), (-1, 1, 0), (-1, -1, 0))
W = (1 / 3,) + (1 / 18,) * 6 + (1 / 36,) * 12
OPPOSITE = tuple(E.index(tuple(-c for c in e)) for e in E)
FLOP_PER_UPDATE = 180
PLANE_FLOP = 10


def _signed_sum(terms):
    """+-t0 +- t1 +- ... in order, from (sign, tensor) pairs."""
    acc = terms[0][1] if terms[0][0] > 0 else -terms[0][1]
    for sign, t in terms[1:]:
        acc = acc + t if sign > 0 else acc - t
    return acc


def make_step(obstacle: torch.Tensor, *, omega: float, density: float, accel: float,
              plane: int, dtype: torch.dtype):
    """The step of `dtype` states on the grid of `obstacle` (bool): a
    function of a (19, nz, ny, nx) state to (the next state, Sum|u|)."""
    dev = obstacle.device

    def c(x):
        return torch.tensor(x, dtype=dtype, device=dev)

    omm, one, k15, k45, k3 = c(1.0 - omega), c(1.0), c(1.5), c(4.5), c(3.0)
    wo = {w: c(w * omega) for w in (W[0], W[1], W[7])}
    force = {k: c(E[k][2] * (density * accel * W[k])) for k in range(19) if E[k][2]}
    zero = c(0.0)
    pairs = [k for k in range(1, 19) if OPPOSITE[k] > k]
    axis = {a: [(E[k][a], k) for k in range(19) if E[k][a]] for a in range(3)}

    def step(f):
        s = [f[k] if not any(E[k]) else
             torch.roll(f[k], tuple(d for d in E[k] if d),
                        dims=tuple(a for a in range(3) if E[k][a]))
             for k in range(19)]
        rho = s[0]
        for k in range(1, 19):
            rho = rho + s[k]
        u = [_signed_sum([(sg, s[k]) for sg, k in axis[a]]) / rho for a in range(3)]
        u_z, u_y, u_x = u
        u_sq = u_x * u_x + u_y * u_y + u_z * u_z
        c_sq = one - u_sq * k15
        wro = {w: wo[w] * rho for w in wo}
        out = [None] * 19
        out[0] = s[0] * omm + wro[W[0]] * c_sq
        for k in pairs:
            kb = OPPOSITE[k]
            comps = [(E[k][2], u_x), (E[k][1], u_y), (E[k][0], u_z)]
            eu = _signed_sum([(sg, t) for sg, t in comps if sg])
            quad = (k45 * eu) * eu + c_sq
            lin = k3 * eu
            w = wro[W[k]]
            out[k] = s[k] * omm + w * (quad + lin)
            out[kb] = s[kb] * omm + w * (quad - lin)
            if k in force:
                out[k][plane] = out[k][plane] + force[k]
                out[kb][plane] = out[kb][plane] - force[k]
        g = torch.empty_like(f)
        for k in range(19):
            torch.where(obstacle, s[OPPOSITE[k]], out[k], out=g[k])
        speed = torch.where(obstacle, zero, torch.sqrt(u_sq))
        return g, speed.sum()

    return step


def solve(f0: torch.Tensor, mask: np.ndarray, *, steps: int, omega: float, density: float,
          accel: float, storage: torch.dtype, store_every: int, device):
    """A whole job from its host inputs: the start state `f0` (a host
    tensor, rounded to `storage`) and the obstacle mask, `steps` steps with
    the force on plane nz-2. Returns (the final state as `storage`, av_vels
    as float64), on `device`."""
    obstacle = torch.as_tensor(np.ascontiguousarray(mask, dtype=np.bool_), device=device)
    f = f0.to(device=device).to(storage)
    nz = f.shape[1]
    step = make_step(obstacle, omega=omega, density=density, accel=accel, plane=nz - 2,
                     dtype=lattice.compute_dtype(storage))
    f, tots = lattice.run(step, f, steps=steps, storage=storage, store_every=store_every)
    free = int((~obstacle).sum())
    return f, tots.double() / free


def speed(f: torch.Tensor, obstacle: torch.Tensor) -> torch.Tensor:
    """|u| of each cell of a state, in float64, 0 on obstacle cells."""
    f = f.double()
    rho = f.sum(0)
    comps = []
    for a in range(3):
        e = torch.tensor([float(x[a]) for x in E], dtype=torch.float64, device=f.device)
        comps.append(torch.tensordot(e, f, dims=1) / rho)
    return torch.where(obstacle, 0.0, torch.sqrt(sum(u * u for u in comps)))
