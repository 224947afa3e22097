"""End-to-end D3Q19 runs: in chunks, with checkpoint and resume, and timed
runs of the multi-device engines.

The counterpart of `lbm_tpu.models.lbm3d`, and the 3-D counterpart of
`models.lbm.run_simulation_with_checkpoints` (the 2-D docstring's contract
applies: chunking is bit-identical to one uninterrupted run of the same
engine at the same K; atomic .npz checkpoints; resume validates the grid and
physics signature). Engines: 'torch' (plain) and the kernel engines of
`ops.d3q19.resolve_engine`: 'cuda' (kernel B6), 'cuda-inplace' (B4),
'cuda-blocked' (B7) and 'cuda-inplace-blocked' (B5); 'native', the
serial C++ engine on the host (`ops.d3q19_native`); and 'sharded-cuda', the
ghost-plane path over a z-mesh of ranks (`parallel.kstep_sharded_3d`), whose
checkpoint holds the gathered global state (valid planes only), so that it
resumes on another z-mesh. `run_simulation_sharded` times a run of any multi-device engine
(`ops.d3q19.SHARDED_ENGINES`) for the CLI.

The 3-D checkpoint records no K. The state a kernel engine leaves does not
depend on K, on the tile or on which of the four kernels ran (they are
bit-identical on the state); Sum|u| may differ in its last bits between
kernels, tiles and K, by the order of its sum. So a run resumed with another
engine or K continues from the same state, and equals an uninterrupted run
bit for bit in av_vels too when engine, K and tile are the same, which
`select_k_steps` ensures for the same total and chunk.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..core import checkpoint, state
from ..ops import d3q19, d3q19_kstep, d3q19_lattice
from ..parallel import halo, kstep_sharded_3d, launch, mesh as mesh_lib
from .lbm import default_num_devices, host_dtype, numpy_dtype, resolve_device


def select_k_steps(engine: str, num_steps: int, checkpoint_every: int, shape=None,
                   n_shards: int | None = None) -> int:
    """K for this engine that keeps chunking bit-exact: of the K dividing both
    the total and the chunk, the one its kernel's `choose_k` prefers (the
    preferred K where it divides, else the least ms a step, for the one-step
    kernels; the deepest up to their preferred K for the blocked pair), as
    `ops.d3q19.resolve_engine` gives it for the single-device kernel engines.
    The kernels take any grid shape, so the shape sets no limit (unlike the
    TPU's K-plane-aligned halo blocks). 1 for the plain engines, which have
    no K. 'sharded-cuda' given `shape` (nz, ny, nx) takes
    `kstep_sharded_3d.choose_k` for `n_shards` z-shards of its nz (the
    reference's rule checks `plan_planes` for the real shard count too, at
    K = 2 or 1); the other engines the one-step kernels' K."""
    if engine in ("torch", "sharded"):
        return 1
    if engine == "sharded-cuda" and shape is not None:
        return kstep_sharded_3d.choose_k(shape[0], n_shards or 1, num_steps, checkpoint_every)
    if engine.startswith("cuda"):
        return d3q19.resolve_engine(engine, (num_steps, checkpoint_every))[2]
    return d3q19_kstep.choose_k(num_steps, checkpoint_every)


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
    num_devices: int | None = None,
):
    """Returns (f_final, av_vels, compute_seconds, steps_run), the first two
    as numpy arrays. k_steps=None picks the deepest K dividing the total and
    the chunk size (`select_k_steps`), so any step count the plain CLI
    accepts also checkpoints. The checkpoint holds the state on the host.
    engine='sharded-cuda' runs on `num_devices` ranks (default: every GPU on
    CUDA, 1 on the CPU; `parallel.launch`) and checkpoints the gathered
    global state (valid planes only), so a checkpoint written on one z-mesh
    resumes on any other; rank 0 writes it. The other multi-device engines
    are refused: they have no chunked runner, as in the reference.
    engine='native' runs on the host whatever `device` says."""
    if obstacle_mask is None:
        obstacle_mask = d3q19.default_obstacle_mask(nz, ny, nx)
    mask_np = np.asarray(obstacle_mask, bool)
    physics = dict(omega=omega, density=density, accel=accel)
    if engine == "native":
        if num_devices is not None or k_steps is not None:
            raise ValueError("engine 'native' takes no num_devices or k_steps")
        return _checkpointed_native(mask_np, Path(checkpoint_path), num_steps, checkpoint_every,
                                    physics, dtype, resume)
    device = resolve_device(device)
    if engine in d3q19.SHARDED_ENGINES:
        if engine != "sharded-cuda":
            raise ValueError(
                f"checkpointing supports engines {d3q19.ENGINES + ('sharded-cuda',)}, not "
                f"{engine!r} (use the z-mesh engine sharded-cuda for checkpointed runs)")
        n = num_devices or default_num_devices(device)
        launch.check_world(n, device.type)
        return launch.run(_checkpoint_rank, n, mask_np, Path(checkpoint_path), num_steps,
                          checkpoint_every, physics, dtype, resume, k_steps,
                          device_type=device.type)
    if num_devices is not None:
        raise ValueError(f"num_devices applies to engine 'sharded-cuda', not {engine!r}")
    accel_plane = nz - 2
    kernel_engine = engine != "torch"
    if kernel_engine:
        _check_k(k_steps, num_steps, checkpoint_every)
        run_fn, _, k_steps, extra = d3q19.resolve_engine(
            engine, (num_steps, checkpoint_every), k_steps=k_steps)
    f_host, start, av_parts = _start_or_resume(
        Path(checkpoint_path), resume, (nz, ny, nx), physics, host_dtype(dtype), num_steps,
        k_steps if kernel_engine else None)

    f, mask = state.to_torch3d(f_host, mask_np, device=device)
    amask = d3q19.accel_plane_mask(nz, ny, nx, accel_plane, dtype=f.dtype, device=device)

    def run_chunk(f, n):
        if kernel_engine:
            return run_fn(f, mask, num_steps=n, k_steps=k_steps, accel_plane=accel_plane,
                          **physics, **extra)
        return d3q19.run(f, mask, amask, num_steps=n, **physics)

    return _chunks(run_chunk, lambda f: f, f, start, num_steps, checkpoint_every, av_parts,
                   (~mask).sum().to(f.dtype), Path(checkpoint_path), physics, write=True)


def _checkpointed_native(mask_np, ck_path: Path, num_steps, checkpoint_every, physics, dtype,
                         resume):
    """run_simulation_with_checkpoints' 'native' engine: each chunk a call
    of `d3q19_native.run`, which advances the numpy state in place."""
    from ..ops import d3q19_native

    np_dtype = numpy_dtype(dtype)
    nz = mask_np.shape[0]
    f_host, start, av_parts = _start_or_resume(ck_path, resume, mask_np.shape, physics, np_dtype,
                                               num_steps, None)
    f = np.ascontiguousarray(f_host)

    def run_chunk(f, n):
        tot = d3q19_native.run(f, mask_np, num_steps=n, accel_plane=nz - 2, **physics)
        # Sum|u| in the state's type, as d3q19_native.simulate divides it
        return f, torch.from_numpy(tot.astype(np_dtype))

    return _chunks(run_chunk, torch.from_numpy, f, start, num_steps, checkpoint_every, av_parts,
                   torch.tensor(np_dtype((~mask_np).sum())), ck_path, physics, write=True)


def _check_k(k_steps, num_steps, checkpoint_every):
    if k_steps is not None and not 1 <= k_steps <= d3q19_kstep.MAX_K:
        raise ValueError(f"k_steps must be in 1..{d3q19_kstep.MAX_K}, got {k_steps}")
    if k_steps is not None and (num_steps % k_steps or checkpoint_every % k_steps):
        raise ValueError(
            f"kernel checkpointing needs num_steps ({num_steps}) and checkpoint_every "
            f"({checkpoint_every}) divisible by k_steps ({k_steps}) for bit-exact chunking")


def _start_or_resume(ck_path: Path, resume: bool, shape, physics, np_dtype, num_steps,
                     k_steps):
    """(state on the host, first step, av_vels so far) of a checkpointed run:
    the checkpoint's when resuming, else the state at rest. k_steps is None
    for an engine without K."""
    if not (resume and ck_path.exists()):
        return d3q19_lattice.initial_distributions(*shape, physics["density"], np_dtype), 0, []
    ck = checkpoint.load3d(ck_path, expect_shape=shape,
                           expect_physics=(physics["omega"], physics["density"],
                                           physics["accel"]))
    start = ck.step
    if start > num_steps:
        raise ValueError(f"checkpoint is at step {start}, beyond the requested "
                         f"{num_steps} steps: nothing to resume")
    if k_steps is not None and start % k_steps:
        raise ValueError(f"checkpoint step {start} is not a multiple of k_steps "
                         f"({k_steps}); resume with the engine config that wrote it")
    return state.as_host(ck.f, np_dtype), start, [np.asarray(ck.av_vels, np.float64)]


def _chunks(run_chunk, gather, f, start, num_steps, checkpoint_every, av_parts, num_free,
            ck_path: Path, physics, write: bool):
    """The chunks of a checkpointed run from `start` to num_steps:
    run_chunk(f, n) -> (f, Sum|u| (n,)), gather(f) -> the full state as a
    tensor; `write` on the rank that writes the checkpoint. Returns
    (f_final, av_vels, compute_seconds, steps_run); f_final is None where
    not `write`."""
    steps_run = num_steps - start
    f_host = None
    t0 = time.perf_counter()
    while start < num_steps:
        n = min(checkpoint_every, num_steps - start)
        f, tot = run_chunk(f, n)
        # divide in f's dtype on the device, as d3q19.simulate does
        av_parts.append((tot / num_free).double().cpu().numpy())
        start += n
        full = gather(f)  # every rank takes part in the gather
        if write:
            f_host = state.host_state(full)
            checkpoint.save3d(ck_path, f_host, np.concatenate(av_parts), start, **physics)
    compute_seconds = time.perf_counter() - t0
    if steps_run == 0:  # resumed at the end: the checkpoint's state
        full = gather(f)
        f_host = state.host_state(full) if write else None
    av = np.concatenate(av_parts) if av_parts else np.zeros(0)
    return f_host, av, compute_seconds, steps_run


def _checkpoint_rank(mask_np, ck_path, num_steps, checkpoint_every, physics, dtype, resume,
                     k_steps):
    """The body of a checkpointed 'sharded-cuda' run on each rank; rank 0
    writes the checkpoint and returns the result."""
    import torch.distributed as dist

    nz, ny, nx = mask_np.shape
    n = dist.get_world_size()
    _check_k(k_steps, num_steps, checkpoint_every)
    k_steps = k_steps or select_k_steps("sharded-cuda", num_steps, checkpoint_every,
                                        (nz, ny, nx), n)
    f_host, start, av_parts = _start_or_resume(ck_path, resume, (nz, ny, nx), physics,
                                               host_dtype(dtype), num_steps, k_steps)
    mesh = kstep_sharded_3d.make_z_mesh(n)
    f, mask_ext = kstep_sharded_3d.prepare(f_host, mask_np, mesh, k_steps=k_steps,
                                           density=physics["density"])

    def run_chunk(f, steps):
        return kstep_sharded_3d.run(f, mask_ext, mesh=mesh, num_steps=steps, k_steps=k_steps,
                                    accel_plane=nz - 2, nz=nz, **physics)

    # the free-cell count in the state's type, as on one device
    num_free = torch.tensor(int((~mask_np).sum()), dtype=f.dtype, device=f.to_local().device)
    result = _chunks(run_chunk, lambda f: f.full_tensor()[:, :nz], f, start, num_steps,
                     checkpoint_every, av_parts, num_free, ck_path, physics,
                     write=launch.is_rank0())
    return result if launch.is_rank0() else None


@dataclasses.dataclass
class ShardedRun:
    f_final: np.ndarray
    av_vels: np.ndarray
    compute_seconds: float
    k_steps: int | None  # None: the plain 'sharded' engine
    mesh_shape: tuple
    kernel: str | None = None  # the local kernel's wrapper module
    block: tuple | None = None  # the block it runs on


def setup_engine(engine: str, nz: int, ny: int, nx: int, *, num_steps: int,
                 omega: float = 1.85, density: float = 0.1, accel: float = 0.005,
                 obstacle_mask=None, dtype=torch.float32, k_steps: int | None = None,
                 overlap: bool = False, mesh_shape=None, local_engine: str = "inplace"):
    """A run of a 3-D multi-device engine laid out on the ranks of the process
    group, from the uniform state at rest: 'sharded-cuda'
    (`kstep_sharded_3d.run` over a z-mesh of every rank), 'sharded-cuda-zy'
    (`kstep_sharded_3d.run_zy` on a mesh of `mesh_shape`, default
    `kstep_sharded_3d.default_zy_shape`) or 'sharded' (`ops.d3q19.step` on a
    DTensor sharded over z and y of `mesh.make_mesh`, even splits only, its
    rolls through `halo.dtensor_roll` and the accelerated-plane mask sharded
    over 'ry' alone). k_steps=None takes `kstep_sharded_3d.choose_k` for the
    run's z-shards; local_engine picks the kernel engines' local kernel
    (`kstep_sharded_3d.local_kernel`). Returns (advance, finish, info):
    advance() runs num_steps from the laid-out state (which it leaves as it
    was) and returns (f_final DTensor, tot_u), finish(f_final, tot_u) the
    full (19, nz, ny, nx) state and av_vels on this rank's device, the same
    on every rank; info holds the mesh's shape and K, and for the kernel
    engines the local kernel's module and the block it runs on (the
    overlap's interior block)."""
    n = dist.get_world_size()
    physics = dict(omega=omega, density=density, accel=accel)
    if engine == "sharded":
        if k_steps is not None or overlap or mesh_shape is not None or local_engine != "inplace":
            raise ValueError("engine 'sharded' takes no k_steps, overlap, mesh_shape or "
                             "local_engine")
        return _setup_plain(nz, ny, nx, n, num_steps, obstacle_mask, dtype, physics)
    if engine == "sharded-cuda-zy":
        shape = (tuple(mesh_shape) if mesh_shape is not None
                 else kstep_sharded_3d.default_zy_shape(n, nz, ny))
        k_steps = k_steps or kstep_sharded_3d.choose_k(nz, shape[0], num_steps)
        mesh = kstep_sharded_3d.make_zy_mesh(*shape)
    elif engine == "sharded-cuda":
        if mesh_shape is not None:
            raise ValueError("mesh_shape applies to engine 'sharded-cuda-zy' only")
        k_steps = k_steps or kstep_sharded_3d.choose_k(nz, n, num_steps, overlap=overlap)
        mesh = kstep_sharded_3d.make_z_mesh(n)
    else:
        raise ValueError(f"unknown multi-device engine {engine!r}")
    advance, finish, block = kstep_sharded_3d.laid_out(
        nz, ny, nx, mesh, zy=engine == "sharded-cuda-zy", num_steps=num_steps,
        k_steps=k_steps, obstacle_mask=obstacle_mask, dtype=dtype, overlap=overlap,
        local_engine=local_engine, **physics)
    stepk = kstep_sharded_3d.local_kernel(local_engine)
    return advance, finish, dict(mesh_shape=tuple(mesh.shape), k_steps=k_steps, block=block,
                                 kernel=stepk.__module__.rsplit(".", 1)[1])


def _setup_plain(nz, ny, nx, n, num_steps, obstacle_mask, dtype, physics):
    """setup_engine's 'sharded' engine."""
    from torch.distributed.tensor import Replicate, Shard

    f0, mask = kstep_sharded_3d.start_state(nz, ny, nx, obstacle_mask, physics["density"],
                                            dtype)
    mesh = mesh_lib.make_mesh(n, nz, ny, require_even=True)
    f = mesh_lib.shard(f0, mesh, (Shard(1), Shard(2)))
    mask_sh = mesh_lib.shard(mask, mesh, (Shard(0), Shard(1)))
    amask = mesh_lib.shard(
        d3q19.accel_plane_mask(nz, ny, nx, nz - 2, dtype=f.dtype, device=mesh_lib.local_device()),
        mesh, (Shard(0), Replicate()))

    def step(f):
        return d3q19.step(f, mask_sh, amask, roll=halo.dtensor_roll, **physics)

    def advance():
        return halo.run_global_step(step, f, num_steps)

    return (advance, kstep_sharded_3d.finisher(mask, nz, ny),
            dict(mesh_shape=tuple(mesh.shape), k_steps=None))


def simulate_engine(engine: str, nz: int, ny: int, nx: int, **kw):
    """One run of a 3-D multi-device engine on the ranks of the process group
    (the body of `ops.d3q19.simulate` on each rank; the keywords of
    `setup_engine`). Returns (f_final, av_vels), the same on every rank."""
    advance, finish, _ = setup_engine(engine, nz, ny, nx, **kw)
    return finish(*advance())


def run_simulation_sharded(
    nz: int, ny: int, nx: int, *,
    num_steps: int,
    engine: str = "sharded-cuda",
    omega: float = 1.85,
    density: float = 0.1,
    accel: float = 0.005,
    dtype=torch.float32,
    num_devices: int | None = None,
    overlap: bool = False,
    mesh_shape=None,
    local_engine: str = "inplace",
    device=None,
) -> ShardedRun:
    """A timed run of a multi-device engine (`ops.d3q19.SHARDED_ENGINES`) on
    `num_devices` ranks (default: every GPU on CUDA, 1 on the CPU), from the
    state at rest with the default walls, at the K `kstep_sharded_3d.choose_k`
    gives, through `parallel.launch`: `setup_engine` lays the run out, a
    warm-up run builds and loads the kernels, and the timed run follows a
    barrier, timed by events on rank 0's device on CUDA. The time covers the
    steps, the exchanges and the one all-reduce of Sum|u|, not laying the
    state out or gathering it. local_engine='two-stream' runs B6 on each
    block of the kernel engines."""
    device = resolve_device(device)
    if engine not in d3q19.SHARDED_ENGINES:
        raise ValueError(f"unknown multi-device engine {engine!r}; choose from "
                         f"{d3q19.SHARDED_ENGINES}")
    if overlap and engine != "sharded-cuda":
        raise ValueError("overlap=True applies to engine='sharded-cuda' only")
    n = num_devices or default_num_devices(device)
    launch.check_world(n, device.type)
    return launch.run(_sharded_rank, n, engine, nz, ny, nx, dict(
        num_steps=num_steps, omega=omega, density=density, accel=accel, dtype=dtype,
        overlap=overlap, mesh_shape=mesh_shape, local_engine=local_engine),
        device_type=device.type)


def _sharded_rank(engine, nz, ny, nx, kw) -> ShardedRun | None:
    """The body of run_simulation_sharded on each rank."""
    advance, finish, info = setup_engine(engine, nz, ny, nx, **kw)
    finish(*advance())[1].cpu()  # warm-up (kernel build and load)
    dist.barrier()
    if mesh_lib.device_type() == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = advance()
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        result = advance()
        seconds = time.perf_counter() - t0
    f_final, av = finish(*result)
    if not launch.is_rank0():
        return None
    return ShardedRun(state.host_state(f_final), av.double().cpu().numpy(), seconds,
                      info["k_steps"], info["mesh_shape"], info.get("kernel"),
                      info.get("block"))


def _slice_fields_bf16(f: torch.Tensor, mask: np.ndarray, z: int, density: float):
    """`final_state_slice_fields` of a host bfloat16 state, each operation as
    numpy computes it on an ml_dtypes array: rho a sum over the speeds one
    after the other in bfloat16, each velocity component a dot product
    accumulated in float32 and rounded once (ml_dtypes' dot), the rest in
    bfloat16. Returns float32 arrays of the values."""
    def c(x):
        return torch.tensor(x, dtype=torch.bfloat16)

    def dot(e):
        acc = torch.zeros(fz.shape[1:], dtype=torch.float32)
        for k in range(d3q19_lattice.NUM_SPEEDS):
            acc = acc + float(e[k]) * fz[k].float()
        return acc.to(torch.bfloat16)

    fz = f[:, z]
    rho = fz[0]
    for k in range(1, d3q19_lattice.NUM_SPEEDS):
        rho = rho + fz[k]
    E = d3q19_lattice.E
    u_x, u_y, u_z = (dot(E[:, 2]) / rho, dot(E[:, 1]) / rho, dot(E[:, 0]) / rho)
    u = torch.sqrt(u_x * u_x + u_y * u_y + u_z * u_z)
    c_sq = c(1.0) / c(3.0)
    obs = np.asarray(mask[z], bool)
    tobs, zero = torch.from_numpy(obs), c(0.0)
    fields = (torch.where(tobs, zero, u_x), torch.where(tobs, zero, u_y),
              torch.where(tobs, zero, u), torch.where(tobs, c(density) * c_sq, rho * c_sq))
    return (*(x.float().numpy() for x in fields), obs)


def final_state_slice_fields(f: np.ndarray, mask: np.ndarray, z: int, density: float):
    """Macroscopic (u_x, u_y, u, pressure, obstacle) on plane z.

    u_x/u_y are the in-plane velocity components; `u` is the full 3-D speed
    |u| (so the checker column keeps its physical meaning); pressure is
    rho * c_s^2 with the 2-D writer's obstacle conventions
    (core/io.final_state_fields). f is a numpy array or a host bfloat16
    tensor (`core.state.host_state`)."""
    if isinstance(f, torch.Tensor):
        return _slice_fields_bf16(f, mask, z, density)
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
