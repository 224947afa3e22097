"""End-to-end D3Q19 runs in chunks, with checkpoint and resume.

The counterpart of `lbm_tpu.models.lbm3d`, and the 3-D counterpart of
`models.lbm.run_simulation_with_checkpoints` (the 2-D docstring's contract
applies: chunking is bit-identical to one uninterrupted run of the same
engine at the same K; atomic .npz checkpoints; resume validates the grid and
physics signature). Engines: 'torch' (plain) and the kernel engines of
`ops.d3q19.resolve_engine`: 'cuda' (kernel B6 or B7), 'cuda-inplace' (B4 or
B5), 'cuda-blocked' (B7) and 'cuda-inplace-blocked' (B5).

The 3-D checkpoint records no K. The state a kernel engine leaves does not
depend on K, on the tile or on which of the four kernels ran (they are
bit-identical on the state); Sum|u| may differ in its last bits between
kernels, tiles and K, by the order of its sum. So a run resumed with another
engine or K continues from the same state, and equals an uninterrupted run
bit for bit in av_vels too when engine, K and tile are the same, which
`select_k_steps` ensures for the same total and chunk.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..core import checkpoint, state
from ..ops import d3q19, d3q19_kstep, d3q19_lattice
from .lbm import numpy_dtype, resolve_device


def select_k_steps(engine: str, num_steps: int, checkpoint_every: int, shape=None) -> int:
    """K for this engine that keeps chunking bit-exact: of the K dividing both
    the total and the chunk, the one its kernel's `choose_k` prefers (the
    preferred K where it divides, else the least ms a step, for the one-step
    kernels; the deepest up to their preferred K for the blocked pair). The
    kernels take any grid
    shape, so the shape sets no limit (unlike the TPU's K-plane-aligned halo
    blocks); given `shape` (nz, ny, nx), 'cuda' and 'cuda-inplace' take the K
    of the kind their `pick_engine` names there, else that of the one-step
    kernels. 1 for the plain engine, which has no K."""
    if engine == "torch":
        return 1
    if shape is None and not engine.endswith("-blocked"):
        return d3q19_kstep.choose_k(num_steps, checkpoint_every)
    return d3q19.resolve_engine(engine, *(shape or (0, 0, 0)),
                                (num_steps, checkpoint_every))[2]


def run_simulation_with_checkpoints(
    nz: int, ny: int, nx: int, *,
    num_steps: int,
    checkpoint_path: str | Path,
    checkpoint_every: int,
    omega: float = 1.85,
    density: float = 0.1,
    accel: float = 0.005,
    obstacle_mask=None,
    dtype=torch.float32,
    engine: str = "torch",
    resume: bool = False,
    k_steps: int | None = None,
    device=None,
):
    """Returns (f_final, av_vels, compute_seconds, steps_run), the first two
    as numpy arrays. k_steps=None picks the deepest K dividing the total and
    the chunk size (`select_k_steps`), so any step count the plain CLI
    accepts also checkpoints. The checkpoint holds the state on the host."""
    device = resolve_device(device)
    np_dtype = numpy_dtype(dtype)
    if obstacle_mask is None:
        obstacle_mask = d3q19.default_obstacle_mask(nz, ny, nx)
    mask_np = np.asarray(obstacle_mask, bool)
    accel_plane = nz - 2

    kernel_engine = engine != "torch"
    if kernel_engine:
        if k_steps is not None and not 1 <= k_steps <= d3q19_kstep.MAX_K:
            raise ValueError(f"k_steps must be in 1..{d3q19_kstep.MAX_K}, got {k_steps}")
        if k_steps is not None and (num_steps % k_steps or checkpoint_every % k_steps):
            raise ValueError(
                f"kernel checkpointing needs num_steps ({num_steps}) and checkpoint_every "
                f"({checkpoint_every}) divisible by k_steps ({k_steps}) for bit-exact chunking")
        run_fn, _, k_steps, extra = d3q19.resolve_engine(
            engine, nz, ny, nx, (num_steps, checkpoint_every), k_steps=k_steps, dtype=dtype,
            device=device)

    ck_path = Path(checkpoint_path)
    if resume and ck_path.exists():
        ck = checkpoint.load3d(ck_path, expect_shape=(nz, ny, nx),
                               expect_physics=(omega, density, accel))
        f_host = np.asarray(ck.f, np_dtype)
        start = ck.step
        if start > num_steps:
            raise ValueError(f"checkpoint is at step {start}, beyond the requested "
                             f"{num_steps} steps: nothing to resume")
        if kernel_engine and start % k_steps:
            raise ValueError(f"checkpoint step {start} is not a multiple of k_steps "
                             f"({k_steps}); resume with the engine config that wrote it")
        av_parts = [np.asarray(ck.av_vels, np.float64)]
    else:
        f_host = d3q19_lattice.initial_distributions(nz, ny, nx, density, np_dtype)
        start = 0
        av_parts = []

    f, mask = state.to_torch3d(f_host, mask_np, device=device)
    amask = d3q19.accel_plane_mask(nz, ny, nx, accel_plane, dtype=f.dtype, device=device)
    num_free = (~mask).sum().to(f.dtype)
    kw = dict(omega=omega, density=density, accel=accel)

    steps_run = num_steps - start
    t0 = time.perf_counter()
    while start < num_steps:
        n = min(checkpoint_every, num_steps - start)
        if kernel_engine:
            f, tot = run_fn(f, mask, num_steps=n, k_steps=k_steps, accel_plane=accel_plane,
                            **kw, **extra)
        else:
            f, tot = d3q19.run(f, mask, amask, num_steps=n, **kw)
        # divide in f's dtype on the device, as d3q19.simulate does
        av_parts.append((tot / num_free).cpu().numpy().astype(np.float64))
        start += n
        checkpoint.save3d(ck_path, f.cpu().numpy(), np.concatenate(av_parts), start,
                          omega=omega, density=density, accel=accel)
    compute_seconds = time.perf_counter() - t0
    av = np.concatenate(av_parts) if av_parts else np.zeros(0)
    return f.cpu().numpy(), av, compute_seconds, steps_run


def final_state_slice_fields(f: np.ndarray, mask: np.ndarray, z: int, density: float):
    """Macroscopic (u_x, u_y, u, pressure, obstacle) on plane z.

    u_x/u_y are the in-plane velocity components; `u` is the full 3-D speed
    |u| (so the checker column keeps its physical meaning); pressure is
    rho * c_s^2 with the 2-D writer's obstacle conventions
    (core/io.final_state_fields)."""
    dtype = f.dtype
    fz = np.asarray(f[:, z])
    rho = fz.sum(axis=0, dtype=dtype)
    ex, ey, ez = (d3q19_lattice.E[:, 2], d3q19_lattice.E[:, 1], d3q19_lattice.E[:, 0])
    u_x = np.tensordot(ex.astype(dtype), fz, axes=1) / rho
    u_y = np.tensordot(ey.astype(dtype), fz, axes=1) / rho
    u_z = np.tensordot(ez.astype(dtype), fz, axes=1) / rho
    u = np.sqrt(u_x * u_x + u_y * u_y + u_z * u_z)
    c_sq = np.asarray(1.0, dtype) / np.asarray(3.0, dtype)
    pressure = rho * c_sq
    obs = np.asarray(mask[z], bool)
    zero = np.asarray(0.0, dtype)
    u_x = np.where(obs, zero, u_x)
    u_y = np.where(obs, zero, u_y)
    u = np.where(obs, zero, u)
    pressure = np.where(obs, np.asarray(density, dtype) * c_sq, pressure)
    return u_x, u_y, u, pressure, obs


def write_final_state_slice(path, f: np.ndarray, mask: np.ndarray, z: int,
                            density: float) -> None:
    """Write plane z in the exact 2-D final_state.dat format
    (`x y u_x u_y u pressure obstacle`), so the checker and the 2-D tools
    take 3-D results unchanged."""
    from ..core import io

    u_x, u_y, u, pressure, obs = final_state_slice_fields(f, mask, z, density)
    io.write_final_state_arrays(path, u_x, u_y, u, pressure, obs)
