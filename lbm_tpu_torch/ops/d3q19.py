"""D3Q19 BGK lattice-Boltzmann in plain PyTorch: the port's 3-D reference
engine and the entry point `simulate` of all the 3-D engines.

The counterpart of `lbm_tpu.ops.d3q19`. One `step` fuses periodic pull
streaming (`torch.roll`), obstacle bounce-back, BGK collision and the
accelerated-plane body force, and returns the per-step Sum|u|.

State: (19, nz, ny, nx), axis order (z, y, x); see `d3q19_lattice`. The
accelerated-plane force generalises the 2-D accelerated row: speed k on the
target z-plane gains sign(e_x[k]) * density * accel * W[k].

`collide_fields` carries the reference's default 'paired' grouping operation
for operation (the serial C++ oracle and the committed golden traces carry it
too), and every operation rounds on its own, so the CUDA kernels
(csrc/d3q19_kstep.cu, compiled without FMA contraction) reproduce it; only
the order of the Sum|u| reduction differs.

`GROUPING` is read from LBM_D3Q19_GROUPING at import, as the JAX package
reads it: 'paired' (the default) or any other value for the reference's
per-speed grouping, which `collide_fields` then takes and the 3-D kernels
run from a library of their own (`kernel_variant`).

A bfloat16 state steps in bfloat16 with every scalar rounded to it first, as
`d2q9` does (`d2q9.scalar`).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..utils import profiling
from .d2q9 import scalar
from .d3q19_lattice import (  # noqa: F401  (re-exported for callers)
    E, NUM_SPEEDS, OPPOSITE, W, initial_distributions,
)

# The grouping of the equilibrium, fixed per process as in the JAX package
# (lbm_tpu/ops/d3q19.py): 'paired' or the reference's per-speed grouping.
GROUPING = os.environ.get("LBM_D3Q19_GROUPING", "paired")


def kernel_variant() -> str | None:
    """The build variant of the 3-D kernels' library for GROUPING
    (`_build.VARIANTS`): None for 'paired', "per_speed" otherwise."""
    return None if GROUPING == "paired" else "per_speed"

# 'native' is the serial C++ engine on the host (ops/d3q19_native.py)
ENGINES = ("torch", "cuda", "cuda-inplace", "cuda-blocked", "cuda-inplace-blocked", "native")
# the multi-device engines (`parallel/`): 'sharded' (the plain step on a
# (z, y)-sharded DTensor), 'sharded-cuda' (ghost planes around B4 over a
# z-mesh) and 'sharded-cuda-zy' (ghost planes and rows on a (z, y) mesh)
SHARDED_ENGINES = ("sharded", "sharded-cuda", "sharded-cuda-zy")


def _e_dot_u(k: int, u_x, u_y, u_z):
    """e_k . u, added in the order x, y, z from 0.0 as the reference does."""
    eu = 0.0
    if E[k, 2]:
        eu = eu + int(E[k, 2]) * u_x
    if E[k, 1]:
        eu = eu + int(E[k, 1]) * u_y
    if E[k, 0]:
        eu = eu + int(E[k, 0]) * u_z
    return eu


def equilibrium(rho, u_x, u_y, u_z) -> torch.Tensor:
    """Maxwell-Boltzmann equilibrium at (rho, u) on the D3Q19 lattice, in the
    per-speed `(4.5 eu)(2/3 + eu) + c_sq` grouping; `collide_fields`' paired
    grouping computes the algebraically identical value, so an equilibrium
    state is a fixed point of the collision up to rounding. Inputs broadcast
    to the grid; returns (19, nz, ny, nx)."""
    u_sq = u_x * u_x + u_y * u_y + u_z * u_z
    c_sq = 1.0 - u_sq * 1.5
    outs = []
    for k in range(NUM_SPEEDS):
        wk = float(W[k])
        if not E[k].any():
            outs.append(wk * rho * c_sq)
            continue
        eu = _e_dot_u(k, u_x, u_y, u_z)
        outs.append(wk * rho * ((4.5 * eu) * (2.0 / 3.0 + eu) + c_sq))
    return torch.stack(outs)


def stream_pull(f: torch.Tensor, roll=torch.roll) -> list[torch.Tensor]:
    """Periodic pull: speed k at x comes from x - e_k, rolled along the axes
    it moves on. `roll` has `torch.roll`'s signature
    (`parallel.halo.dtensor_roll` for a DTensor, which gathers each rolled
    axis)."""
    out = []
    for k in range(NUM_SPEEDS):
        axes = [a for a in range(3) if E[k, a]]
        out.append(roll(f[k], tuple(int(E[k, a]) for a in axes), dims=tuple(a - 3 for a in axes))
                   if axes else f[k])
    return out


def collide_fields(
    s: list[torch.Tensor],
    obstacle_mask: torch.Tensor,
    accel_mask: torch.Tensor,
    *,
    omega: float,
    density: float,
    accel: float,
):
    """BGK collide + bounce-back + accelerated-plane force on streamed planes.
    `obstacle_mask` is bool; `accel_mask` is a {0,1} float array (1 on the
    accelerated plane, broadcastable). Returns (f_new (19, ...), u_plane |u|
    with obstacles zeroed).

    GROUPING 'paired': opposite speed pairs share eu (eu_opp = -eu), the
    quadratic equilibrium term, the per-weight-class (w * omega) * rho
    product and the force product, as `lbm_tpu.ops.d3q19.collide_fields`;
    otherwise its per-speed branch, operation for operation."""

    def c(x):
        return scalar(x, s[0])

    rho = functools.reduce(torch.add, s)
    u_x = functools.reduce(
        torch.add, (int(E[k, 2]) * s[k] for k in range(NUM_SPEEDS) if E[k, 2])
    ) / rho
    u_y = functools.reduce(
        torch.add, (int(E[k, 1]) * s[k] for k in range(NUM_SPEEDS) if E[k, 1])
    ) / rho
    u_z = functools.reduce(
        torch.add, (int(E[k, 0]) * s[k] for k in range(NUM_SPEEDS) if E[k, 0])
    ) / rho
    u_sq = u_x * u_x + u_y * u_y + u_z * u_z
    c_sq = c(1.0) - u_sq * c(1.5)
    one_minus_omega = c(1.0 - omega)

    outs = [None] * NUM_SPEEDS
    if GROUPING == "paired":
        wro = {w: c(float(w) * omega) * rho for w in (W[0], W[1], W[7])}
        outs[0] = s[0] * one_minus_omega + wro[W[0]] * c_sq
        for k in range(1, NUM_SPEEDS):
            kb = int(OPPOSITE[k])
            if kb < k:
                continue
            eu = _e_dot_u(k, u_x, u_y, u_z)
            quad = (c(4.5) * eu) * eu + c_sq
            lin = c(3.0) * eu
            w = wro[W[k]]
            out_k = s[k] * one_minus_omega + w * (quad + lin)
            out_kb = s[kb] * one_minus_omega + w * (quad - lin)
            if E[k, 2]:  # accelerated-plane force on x-moving speeds
                t = accel_mask * c(int(E[k, 2]) * (density * accel * float(W[k])))
                out_k = out_k + t
                out_kb = out_kb - t
            outs[k] = out_k
            outs[kb] = out_kb
    else:
        for k in range(NUM_SPEEDS):
            eu = _e_dot_u(k, u_x, u_y, u_z)
            wk = float(W[k])
            if isinstance(eu, float):  # rest speed
                feq_term = c(wk) * rho * c(omega) * c_sq
            else:
                # w rho omega (c_sq + 3 eu + 4.5 eu^2), in the reference's
                # rearranged (4.5 eu)(2/3 + eu) + c_sq form
                feq_term = c(wk) * rho * c(omega) * ((c(4.5) * eu) * (c(2.0 / 3.0) + eu) + c_sq)
            out = s[k] * one_minus_omega + feq_term
            if E[k, 2]:  # accelerated-plane force on x-moving speeds
                out = out + accel_mask * c(int(E[k, 2]) * (density * accel * wk))
            outs[k] = out

    f_new = torch.stack(
        [torch.where(obstacle_mask, s[int(OPPOSITE[k])], outs[k])
         for k in range(NUM_SPEEDS)]
    )
    zero = torch.zeros((), dtype=u_sq.dtype, device=u_sq.device)
    u_plane = torch.where(obstacle_mask, zero, torch.sqrt(u_sq))
    return f_new, u_plane


def step(
    f: torch.Tensor,
    obstacle_mask: torch.Tensor,
    accel_mask: torch.Tensor,
    *,
    omega: float,
    density: float,
    accel: float,
    roll=torch.roll,
):
    """One fused timestep on the full periodic grid. Returns (f', tot_u).
    On DTensors (with roll=`parallel.halo.dtensor_roll`) tot_u comes out as
    partial sums, one a rank."""
    f_new, u = collide_fields(
        stream_pull(f, roll=roll), obstacle_mask, accel_mask,
        omega=omega, density=density, accel=accel,
    )
    return f_new, u.sum()


def accel_plane_mask(nz: int, ny: int, nx: int, plane_z: int,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """{0,1} mask selecting the accelerated z-plane (broadcasts over y, x)."""
    zs = torch.arange(nz, dtype=torch.int32, device=device)
    return (zs == plane_z).to(dtype)[:, None, None]


def run(
    f: torch.Tensor,
    obstacle_mask: torch.Tensor,
    accel_mask: torch.Tensor,
    *,
    num_steps: int,
    omega: float,
    density: float,
    accel: float,
):
    """`num_steps` fused timesteps in a Python loop. Returns (f_final,
    tot_u per step of shape (num_steps,)), both on f's device."""
    tots = []
    for _ in profiling.passes(num_steps, "torch", "plain", 1):
        f, tot = step(f, obstacle_mask, accel_mask,
                      omega=omega, density=density, accel=accel)
        tots.append(tot)
    if not tots:
        return f, torch.zeros(0, dtype=f.dtype, device=f.device)
    return f, torch.stack(tots)


def default_obstacle_mask(nz: int, ny: int, nx: int) -> np.ndarray:
    """Wall planes at z = 0 and z = nz-1, the default geometry of `simulate`."""
    mask = np.zeros((nz, ny, nx), bool)
    mask[0] = True
    mask[-1] = True
    return mask


def resolve_engine(engine: str, step_counts, *, k_steps: int | None = None):
    """The kernel of a kernel engine and its K, the one route from a 3-D
    engine name to a kernel. Returns (run function, kind, k_steps, keyword
    arguments of run):
      'cuda'                  two-stream: kernel B6 (`d3q19_kstep`), kind 'slab';
      'cuda-inplace'          in place: B4 (`d3q19_kstep_inplace`), kind 'slab';
      'cuda-blocked'          B7 (`d3q19_kstep_blocked`), kind 'blocked';
      'cuda-inplace-blocked'  B5 (`d3q19_kstep_inplace_blocked`), kind 'blocked'.
    The slab kind runs at `d3q19_kstep.choose_k`'s K, the blocked at
    `d3q19_kstep_blocked.choose_k`'s and at the tile its launch chooses. A
    blocked kernel runs only when named: it was the slower at every K in both
    types (experiments/cuda-kstep-tiles/results3d_blocked.csv, PERF.md), and
    the one-step kernels take any shape, where the TPU's did not.
    `step_counts` are the counts K must divide (the total, and the chunk of a
    checkpointed run). k_steps=None picks the kind's preferred K among those;
    an explicit k_steps is honoured exactly or raises."""
    with profiling.span(profiling.CHOOSE_ENGINE):
        from . import (d3q19_kstep, d3q19_kstep_blocked, d3q19_kstep_inplace,
                       d3q19_kstep_inplace_blocked)

        kernels = {"cuda": d3q19_kstep, "cuda-inplace": d3q19_kstep_inplace,
                   "cuda-blocked": d3q19_kstep_blocked,
                   "cuda-inplace-blocked": d3q19_kstep_inplace_blocked}
        if engine not in kernels:
            raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
        if k_steps is not None and (not 1 <= k_steps <= d3q19_kstep.MAX_K
                                    or any(n % k_steps for n in step_counts)):
            raise ValueError(
                f"k_steps={k_steps} has no feasible kernel configuration for step counts "
                f"{tuple(step_counts)} (it must lie in 1..{d3q19_kstep.MAX_K} and divide "
                "them); pass k_steps=None to pick one")
        if engine.endswith("-blocked"):
            return (kernels[engine].run, "blocked",
                    k_steps or d3q19_kstep_blocked.choose_k(*step_counts), dict(tile=None))
        return kernels[engine].run, "slab", k_steps or d3q19_kstep.choose_k(*step_counts), {}


def initial_state(nz: int, ny: int, nx: int, *, density: float = 0.1, obstacle_mask=None,
                  dtype=torch.float32, device=None):
    """The uniform state at rest and the obstacle mask (default: wall planes
    at z = 0 and z = nz-1; else a numpy (nz, ny, nx) array) as tensors on
    `device` (default: CUDA)."""
    from ..core import state
    from ..models.lbm import host_dtype, resolve_device

    device = resolve_device(device)
    if obstacle_mask is None:
        obstacle_mask = default_obstacle_mask(nz, ny, nx)
    return state.to_torch3d(initial_distributions(nz, ny, nx, density, host_dtype(dtype)),
                            np.asarray(obstacle_mask, bool), device=device)


def advance(
    f: torch.Tensor,
    mask: torch.Tensor,
    *,
    num_steps: int,
    omega: float = 1.85,
    density: float = 0.1,
    accel: float = 0.005,
    engine: str = "torch",
    k_steps: int | None = None,
):
    """`num_steps` steps from state f with the accelerated plane at
    z = nz-2, on f's device. engine='torch' is the plain engine above; the
    kernel engines are those of `resolve_engine` (the in-place ones overwrite
    f). k_steps=None picks the kernels' measured-best steps per pass; an
    explicit k_steps is honoured exactly or raises. Returns (f_final,
    av_vels): Sum|u| of each step over the free cells."""
    _, nz, ny, nx = f.shape
    if engine == "torch":
        amask = accel_plane_mask(nz, ny, nx, nz - 2, dtype=f.dtype, device=f.device)
        f_final, tot = run(f, mask, amask, num_steps=num_steps, omega=omega,
                           density=density, accel=accel)
    else:
        run_fn, _, k_steps, extra = resolve_engine(engine, (num_steps,), k_steps=k_steps)
        f_final, tot = run_fn(f, mask, num_steps=num_steps, k_steps=k_steps,
                              omega=omega, density=density, accel=accel,
                              accel_plane=nz - 2, **extra)
    num_free = (~mask).sum().to(f.dtype)
    return f_final, tot / num_free


def simulate(
    nz: int, ny: int, nx: int, *,
    num_steps: int,
    omega: float = 1.85,
    density: float = 0.1,
    accel: float = 0.005,
    obstacle_mask=None,
    dtype=torch.float32,
    engine: str = "torch",
    k_steps: int | None = None,
    device=None,
    num_devices: int | None = None,
    overlap: bool = False,
    mesh_shape: tuple | None = None,
):
    """Lid-driven-style 3-D run on `device` (default: CUDA): `advance` from
    `initial_state`. Returns (f_final, av_vels) as tensors on the device.

    The multi-device engines (SHARDED_ENGINES) run on `num_devices` ranks of
    torch.distributed (default: every GPU on CUDA, 1 on the CPU), through
    `parallel.launch` (in the process group the caller is in, else on ranks
    it starts: NCCL on CUDA, gloo on the CPU): 'sharded-cuda' the ghost-plane
    path over a z-mesh (`parallel.kstep_sharded_3d.simulate`; overlap=True
    rides the exchange under an interior kernel), 'sharded-cuda-zy' over a
    (z, y) mesh of `mesh_shape` (n_z, n_y) and 'sharded' `step` on a
    DTensor state (`models.lbm3d.setup_engine`). k_steps=None takes the
    kernels' preferred K among those the z-split admits
    (`kstep_sharded_3d.choose_k`); the reference takes 2, and the state
    does not depend on K.

    engine='native' runs the serial C++ engine on the host
    (`d3q19_native.simulate`) whatever `device` says, and returns CPU
    tensors."""
    if overlap and engine != "sharded-cuda":
        raise ValueError(
            f"overlap=True is only implemented for engine='sharded-cuda' (ghost-plane "
            f"exchange/compute overlap), not engine={engine!r}")
    if mesh_shape is not None and engine != "sharded-cuda-zy":
        raise ValueError(f"mesh_shape applies to engine='sharded-cuda-zy' only, not {engine!r}")
    if engine == "native":
        from ..models.lbm import numpy_dtype
        from . import d3q19_native

        if num_devices is not None or k_steps is not None:
            raise ValueError("engine 'native' takes no num_devices or k_steps")
        f, av = d3q19_native.simulate(nz, ny, nx, num_steps=num_steps, omega=omega,
                                      density=density, accel=accel,
                                      obstacle_mask=obstacle_mask, dtype=numpy_dtype(dtype))
        return torch.from_numpy(f), torch.from_numpy(av)
    if engine in SHARDED_ENGINES:
        from ..models.lbm import default_num_devices, resolve_device
        from ..models.lbm3d import simulate_engine
        from ..parallel import launch

        device = resolve_device(device)
        n = num_devices or default_num_devices(device)
        launch.check_world(n, device.type)
        f, av = launch.run(
            simulate_engine, n, engine, nz, ny, nx, num_steps=num_steps,
            omega=omega, density=density, accel=accel, dtype=dtype, k_steps=k_steps,
            overlap=overlap, mesh_shape=mesh_shape,
            obstacle_mask=None if obstacle_mask is None else np.asarray(obstacle_mask, bool),
            device_type=device.type)
        return f.to(device), av.to(device)
    if num_devices is not None:
        raise ValueError(f"num_devices applies to the multi-device engines "
                         f"{SHARDED_ENGINES}, not {engine!r}")
    f, mask = initial_state(nz, ny, nx, density=density, obstacle_mask=obstacle_mask,
                            dtype=dtype, device=device)
    return advance(f, mask, num_steps=num_steps, omega=omega, density=density, accel=accel,
                   engine=engine, k_steps=k_steps)
