"""D2Q9 BGK lattice-Boltzmann in plain PyTorch: the port's reference engine.

The counterpart of `lbm_tpu.ops.d2q9`. One `step` fuses periodic pull
streaming (`torch.roll`), obstacle bounce-back, BGK collision in the
rearranged `c_sq = 1 - 1.5 u^2` form and the accelerated-row body force, and
returns the per-step Sum|u| — the semantics of the original serial kernel
(main/LastChance.cpp:185-267).

Every operation is elementwise and rounds on its own, in the grouping of
`collide_fields`, so on the same inputs this engine and the CUDA kernels
(csrc/d2q9_kstep.cu, compiled without FMA contraction) produce the same
state; only the order of the Sum|u| reduction differs. It is the engine for
the CPU, the oracle of the kernels, and the 'torch' engine of the driver.

A bfloat16 state steps in bfloat16, every operation rounding to it, as the
JAX package's plain engine does. JAX rounds a Python scalar to bfloat16
before it meets a bfloat16 array; PyTorch keeps it in float32. So every
scalar of the step is first made a 0-dim bfloat16 tensor (`scalar`). In
float32 and float64 the scalars stay Python floats, as before.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.params import Params
from ..utils import profiling


def scalar(x: float, like: torch.Tensor, tensor: bool = False):
    """x as it meets `like` in the JAX package's arithmetic: for a bfloat16
    tensor a 0-dim bfloat16 tensor (rounded first, as JAX's weak typing
    rounds a Python scalar to the array's type); else the Python float, or
    with `tensor` a 0-dim tensor of like's type on like's device."""
    if like.dtype == torch.bfloat16 or tensor:
        return torch.tensor(x, dtype=like.dtype, device=like.device)
    return x


class AccelWeights(NamedTuple):
    """Body-force row weights w1 = rho*accel/9, w2 = rho*accel/36
    (main/LastChance.cpp:158-159)."""

    w1: float
    w2: float

    @classmethod
    def from_params(cls, params: Params) -> "AccelWeights":
        return cls(params.density * params.accel / 9.0, params.density * params.accel / 36.0)


def stream_pull(f: torch.Tensor, roll=torch.roll) -> tuple[torch.Tensor, ...]:
    """Periodic pull streaming: speed k at cell x comes from x - e_k.

    Matches main/LastChance.cpp:203-211. `f` has shape (9, ny, nx); the row
    axis is -2 (jj, northwards), the column axis -1 (ii, eastwards). `roll`
    is torch.roll's stand-in for a DTensor state (`parallel.halo`).
    """
    return (
        f[0],
        roll(f[1], 1, dims=-1),  # east: from west neighbour
        roll(f[2], 1, dims=-2),  # north: from south neighbour
        roll(f[3], -1, dims=-1),  # west: from east neighbour
        roll(f[4], -1, dims=-2),  # south: from north neighbour
        roll(f[5], (1, 1), dims=(-2, -1)),  # north-east
        roll(f[6], (1, -1), dims=(-2, -1)),  # north-west
        roll(f[7], (-1, -1), dims=(-2, -1)),  # south-west
        roll(f[8], (-1, 1), dims=(-2, -1)),  # south-east
    )


def collide_fields(
    s: tuple[torch.Tensor, ...],
    obstacle_mask: torch.Tensor,
    accel_mask: torch.Tensor | None,
    *,
    omega: float,
    accel_w1: float,
    accel_w2: float,
    shared_reciprocal: bool = False,
    tensor_scalars: bool = False,
):
    """BGK collision + rebound + accelerated-row force on streamed planes.

    `s` are the nine post-streaming planes; `obstacle_mask` is bool;
    `accel_mask` is a {0,1} float plane (1 on the accelerated row,
    broadcastable) or None for no force. Returns (f_new (9, ny, nx), u_plane)
    where u_plane is |u| with obstacle cells zeroed.

    The expression grouping is that of main/LastChance.cpp:213-262 and of
    `lbm_tpu.ops.d2q9.collide_fields`. shared_reciprocal=True computes 1/rho
    once and multiplies (one division instead of two), ~1 ulp different per
    step. tensor_scalars=True makes every scalar a 0-dim tensor on the
    planes' device: the same values, but on CUDA a division by it divides,
    where PyTorch multiplies by a Python scalar's reciprocal. The kernels'
    plain version takes it for the float32 pass of a bfloat16 state, whose
    rounding at the pass's end would turn that ulp into a bfloat16 unit.
    """
    s0, s1, s2, s3, s4, s5, s6, s7, s8 = s

    def c(x):
        return scalar(x, s0, tensor_scalars)

    one_minus_omega = c(1.0 - omega)
    omega_ = c(omega)

    rho = s0 + s1 + s2 + s3 + s4 + s5 + s6 + s7 + s8
    if shared_reciprocal:
        inv_rho = c(1.0) / rho
        u_x = (s1 + s5 + s8 - (s3 + s6 + s7)) * inv_rho
        u_y = (s2 + s5 + s6 - (s4 + s7 + s8)) * inv_rho
    else:
        u_x = (s1 + s5 + s8 - (s3 + s6 + s7)) / rho
        u_y = (s2 + s5 + s6 - (s4 + s7 + s8)) / rho
    u_sq = u_x * u_x + u_y * u_y

    c_sq = c(1.0) - u_sq * c(1.5)
    ld0 = c(4.0 / 9.0) * rho * omega_
    ld1 = rho / c(9.0) * omega_
    ld2 = rho / c(36.0) * omega_
    u_s = u_x + u_y
    u_d = -u_x + u_y

    two_thirds, p45, m45 = c(2.0 / 3.0), c(4.5), c(-4.5)
    out0 = s0 * one_minus_omega + ld0 * c_sq
    out1 = s1 * one_minus_omega + ld1 * ((p45 * u_x) * (two_thirds + u_x) + c_sq)
    out2 = s2 * one_minus_omega + ld1 * ((p45 * u_y) * (two_thirds + u_y) + c_sq)
    out3 = s3 * one_minus_omega + ld1 * ((m45 * u_x) * (two_thirds - u_x) + c_sq)
    out4 = s4 * one_minus_omega + ld1 * ((m45 * u_y) * (two_thirds - u_y) + c_sq)
    out5 = s5 * one_minus_omega + ld2 * ((p45 * u_s) * (two_thirds + u_s) + c_sq)
    out6 = s6 * one_minus_omega + ld2 * ((p45 * u_d) * (two_thirds + u_d) + c_sq)
    out7 = s7 * one_minus_omega + ld2 * ((m45 * u_s) * (two_thirds - u_s) + c_sq)
    out8 = s8 * one_minus_omega + ld2 * ((m45 * u_d) * (two_thirds - u_d) + c_sq)

    # accelerated-row body force folded into the collided state
    # (main/LastChance.cpp:253-261); the adds are exact no-ops off the row
    if accel_mask is not None:
        aw1 = accel_mask * c(accel_w1)
        aw2 = accel_mask * c(accel_w2)
        out1 = out1 + aw1
        out3 = out3 - aw1
        out5 = out5 + aw2
        out6 = out6 - aw2
        out7 = out7 - aw2
        out8 = out8 + aw2

    # obstacle cells: pure bounce-back of the streamed speeds
    # (main/LastChance.cpp:213-223)
    f_new = torch.stack(
        [
            torch.where(obstacle_mask, s0, out0),
            torch.where(obstacle_mask, s3, out1),
            torch.where(obstacle_mask, s4, out2),
            torch.where(obstacle_mask, s1, out3),
            torch.where(obstacle_mask, s2, out4),
            torch.where(obstacle_mask, s7, out5),
            torch.where(obstacle_mask, s8, out6),
            torch.where(obstacle_mask, s5, out7),
            torch.where(obstacle_mask, s6, out8),
        ]
    )

    u_plane = torch.where(obstacle_mask, torch.zeros((), dtype=u_sq.dtype, device=u_sq.device),
                          torch.sqrt(u_sq))
    return f_new, u_plane


def collide(
    s: tuple[torch.Tensor, ...],
    obstacle_mask: torch.Tensor,
    accel_mask: torch.Tensor | None,
    *,
    omega: float,
    accel_w1: float,
    accel_w2: float,
):
    """`collide_fields` with the |u| plane reduced to the scalar tot_u."""
    f_new, u_plane = collide_fields(
        s, obstacle_mask, accel_mask,
        omega=omega, accel_w1=accel_w1, accel_w2=accel_w2,
    )
    return f_new, u_plane.sum()


def equilibrium(rho: torch.Tensor, u_x: torch.Tensor, u_y: torch.Tensor) -> torch.Tensor:
    """Maxwell-Boltzmann equilibrium distributions at (rho, u), in the
    `(4.5 eu)(2/3 + eu) + c_sq` grouping of `collide_fields`, so an
    equilibrium state is a fixed point of the collision operator up to
    rounding. Inputs broadcast together to the grid; returns (9, ny, nx)."""
    u_sq = u_x * u_x + u_y * u_y
    c_sq = 1.0 - u_sq * 1.5
    u_s = u_x + u_y
    u_d = -u_x + u_y
    w0 = 4.0 / 9.0 * rho
    w1 = rho / 9.0
    w2 = rho / 36.0

    def term(eu):
        return (4.5 * eu) * (2.0 / 3.0 + eu) + c_sq

    return torch.stack(
        [
            w0 * c_sq,
            w1 * term(u_x),
            w1 * term(u_y),
            w1 * term(-u_x),
            w1 * term(-u_y),
            w2 * term(u_s),
            w2 * term(u_d),
            w2 * term(-u_s),
            w2 * term(-u_d),
        ]
    )


def accel_row_mask(ny: int, nx: int, accel_row: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """{0,1} column mask selecting the accelerated row (broadcasts over nx)."""
    rows = torch.arange(ny, dtype=torch.int32, device=device)
    return (rows == accel_row).to(dtype)[:, None]


def step(
    f: torch.Tensor,
    obstacle_mask: torch.Tensor,
    accel_mask: torch.Tensor | None,
    *,
    omega: float,
    accel_w1: float,
    accel_w2: float,
):
    """One fused timestep on the full periodic grid. Returns (f', tot_u)."""
    return collide(stream_pull(f), obstacle_mask, accel_mask,
                   omega=omega, accel_w1=accel_w1, accel_w2=accel_w2)


class Step(torch.nn.Module):
    """`step` as a module of (f, mask) -> (f', tot_u), with the
    accelerated-row mask (a buffer) and the scalars of `params` baked in:
    the step that `torch.export` exports (`cli.lbm --compile-only`). The
    obstacle mask stays an input, so one exported step serves any obstacle
    file of its grid (the reference's compile-then-run split). f is not
    changed."""

    def __init__(self, params: Params, dtype=torch.float32, device=None):
        super().__init__()
        aw = AccelWeights.from_params(params)
        self.omega, self.accel_w1, self.accel_w2 = params.omega, aw.w1, aw.w2
        self.register_buffer("accel_mask", accel_row_mask(params.ny, params.nx, params.ny - 2,
                                                          dtype=dtype, device=device))

    def forward(self, f: torch.Tensor, obstacle_mask: torch.Tensor):
        return step(f, obstacle_mask, self.accel_mask, omega=self.omega,
                    accel_w1=self.accel_w1, accel_w2=self.accel_w2)


def first_accelerate(
    f: torch.Tensor,
    obstacle_mask: torch.Tensor,
    *,
    accel_row: int,
    accel_w1: float,
    accel_w2: float,
) -> torch.Tensor:
    """One-off guarded acceleration of the target row before the loop.

    Unlike the in-step force, this variant skips cells whose densities it
    would drive negative (main/LastChance.cpp:163-183). Returns a new tensor.
    """
    w1 = torch.tensor(accel_w1, dtype=f.dtype, device=f.device)
    w2 = torch.tensor(accel_w2, dtype=f.dtype, device=f.device)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    row = f[:, accel_row, :]
    obs = obstacle_mask[accel_row, :]
    ok = (~obs) & (row[3] - w1 > 0) & (row[6] - w2 > 0) & (row[7] - w2 > 0)
    dw1 = torch.where(ok, w1, zero)
    dw2 = torch.where(ok, w2, zero)
    f = f.clone()
    f[1, accel_row] += dw1
    f[3, accel_row] += -dw1
    f[5, accel_row] += dw2
    f[6, accel_row] += -dw2
    f[7, accel_row] += -dw2
    f[8, accel_row] += dw2
    return f


def run(
    f: torch.Tensor,
    obstacle_mask: torch.Tensor,
    accel_mask: torch.Tensor | None,
    *,
    num_steps: int,
    omega: float,
    accel_w1: float,
    accel_w2: float,
):
    """`num_steps` fused timesteps in a Python loop. Returns (f_final,
    tot_u per step of shape (num_steps,)), both on f's device."""
    tots = []
    for i in profiling.passes(num_steps, "torch", "plain", 1):
        f, tot_u = step(f, obstacle_mask, accel_mask,
                        omega=omega, accel_w1=accel_w1, accel_w2=accel_w2)
        tots.append(tot_u)
        if profiling.NAN_DEBUG:
            profiling.check_nans(f, i + 1, "the torch engine")
    if not tots:
        return f, torch.zeros(0, dtype=f.dtype, device=f.device)
    return f, torch.stack(tots)


def simulate(params: Params, f: torch.Tensor, obstacle_mask: torch.Tensor):
    """Full simulation: first-accelerate, then max_iters fused steps. Returns
    (f_final, av_vels) with av_vels already divided by the free-cell count
    (main/LastChance.cpp:266)."""
    aw = AccelWeights.from_params(params)
    accel_row = params.ny - 2
    f = first_accelerate(f, obstacle_mask, accel_row=accel_row,
                         accel_w1=aw.w1, accel_w2=aw.w2)
    amask = accel_row_mask(params.ny, params.nx, accel_row, dtype=f.dtype, device=f.device)
    f_final, tot_u = run(f, obstacle_mask, amask, num_steps=params.max_iters,
                         omega=params.omega, accel_w1=aw.w1, accel_w2=aw.w2)
    num_free = (~obstacle_mask).sum().to(f.dtype)
    return f_final, tot_u / num_free
