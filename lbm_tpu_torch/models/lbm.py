"""End-to-end D2Q9 lattice-Boltzmann simulation driver.

The counterpart of `lbm_tpu.models.lbm` (`run_simulation`,
`run_simulation_sharded`, `run_simulation_with_checkpoints`, `write_outputs`,
`print_summary`): load params and obstacles, initialise, run the timestep
loop on the device, or on the ranks of a mesh (`parallel/`), or on the host
through the native serial engine (`ops/d2q9_native.py`), write
av_vels.dat / final_state.dat and print the `==done==` summary block
(main/LastChance.cpp:279-284). The timed run of `run_simulation` is the
range `utils.profiling.TIMED_RUN` in a profiler's trace.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path

import numpy as np
import torch

from ..core import io, state
from ..core.params import Obstacles, Params, reynolds_number
from ..ops import d2q9, d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual
from ..parallel import halo, kstep_sharded, launch, mesh as mesh_lib
from ..utils import profiling

# 'native' is the serial C++ engine on the host (ops/d2q9_native.py): choosing
# it asks for the host, and 'auto' never picks it
ENGINES = ("torch", "cuda", "cuda-inplace", "cuda-manual", "auto", "native")
# the multi-device engines: 'sharded' (a halo strategy of parallel/halo.py
# each step) and 'sharded-cuda' (ghost bands every K steps around B1 or B2,
# parallel/kstep_sharded.py)
SHARDED_ENGINES = ("sharded", "sharded-cuda")
# the halo strategies of --engine sharded ('none', a physically wrong cost
# baseline, is not offered)
STRATEGIES = ("implicit", "ppermute", "manytensors", "allgather", "naive")


@dataclasses.dataclass
class LbmResult:
    f_final: np.ndarray
    av_vels: np.ndarray
    compute_seconds: float
    reynolds: float
    total_density: float
    engine: str
    # steps executed in the timed window (differs from av_vels.size on a
    # checkpoint resume); None = all of av_vels
    steps_run: int | None = None


NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


def numpy_dtype(dtype):
    """The numpy type of a float32 or float64 run (the engines that hold
    their state in numpy: 'native'); raises for any other."""
    np_dtype = NP_DTYPES.get(dtype)
    if np_dtype is None:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    return np_dtype


def host_dtype(dtype):
    """The type a run's state has on the host: numpy's for float32 and
    float64, torch.bfloat16 for bfloat16 (a CPU tensor, `state.host_state`)."""
    return torch.bfloat16 if dtype == torch.bfloat16 else numpy_dtype(dtype)


def choose_engine(params: Params, dtype, device: torch.device) -> str:
    """The engine of 'auto' for this run: `d2q9_kstep.choose_engine` against
    the free memory of a CUDA `device`; on another device the kernel engines
    run their plain version, so memory counts as ample and CUDA is never
    asked."""
    free = d2q9_kstep.free_device_bytes(device) if device.type == "cuda" else math.inf
    return d2q9_kstep.choose_engine(params.ny, params.nx, dtype, free,
                                    num_steps=params.max_iters)


def run_simulation(
    params: Params,
    obstacles: Obstacles,
    *,
    dtype=torch.float32,
    engine: str = "auto",
    num_steps: int | None = None,
    device=None,
) -> LbmResult:
    """Run the full simulation on `device` (default: CUDA). `engine` selects
    the compute path: 'torch' (the plain PyTorch engine, ops/d2q9.py),
    'cuda' (kernel B2, two-stream, ops/d2q9_kstep.py), 'cuda-inplace'
    (kernel B1, in place, ops/d2q9_kstep_inplace.py), 'cuda-manual' (kernel
    B3, B2 through an explicit copy pipeline, ops/d2q9_kstep_manual.py; the
    counterpart of 'pallas-manual') or 'auto' (`choose_engine`). On the CPU
    the kernel engines run their kernels' plain version. 'native' runs the
    serial C++ engine on the host whatever `device` says, and never asks
    CUDA."""
    p = params if num_steps is None else dataclasses.replace(params, max_iters=num_steps)
    if engine == "native":
        return _run_native(p, obstacles, dtype)
    device = resolve_device(device)
    if engine == "auto":
        engine = choose_engine(p, dtype, device)
    simulate = {"torch": d2q9.simulate, "cuda": d2q9_kstep.simulate,
                "cuda-inplace": d2q9_kstep_inplace.simulate,
                "cuda-manual": d2q9_kstep_manual.simulate}.get(engine)
    if simulate is None:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")

    f0, mask = state.to_torch(state.initial_distributions(p, host_dtype(dtype)),
                              obstacles.mask, device=device)

    # warm-up run (kernel build and load) outside the timed one, as
    # lbm_tpu.models.lbm.run_simulation does; its state is dropped at once,
    # so the timed run holds what choose_engine reckoned
    simulate(p, f0, mask)[1].cpu()

    with profiling.timed_run():
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f_final, av_vels = simulate(p, f0, mask)
            end.record()
            end.synchronize()
            compute_seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            f_final, av_vels = simulate(p, f0, mask)
            compute_seconds = time.perf_counter() - t0

    av_np = av_vels.double().cpu().numpy()
    f_np = state.host_state(f_final)
    return LbmResult(
        f_final=f_np,
        av_vels=av_np,
        compute_seconds=compute_seconds,
        reynolds=reynolds_number(p, float(av_np[-1])),
        total_density=state.total_density(f_np),
        engine=engine,
    )


def _run_native(p: Params, obstacles: Obstacles, dtype) -> LbmResult:
    """run_simulation's 'native' engine: the serial C++ engine on the host,
    timed by the host's clock once its library is built and loaded."""
    from ..ops import d2q9_native

    f_host = state.initial_distributions(p, numpy_dtype(dtype))
    d2q9_native.require()
    with profiling.timed_run():
        t0 = time.perf_counter()
        f_np, av_np = d2q9_native.simulate(p, f_host, obstacles.mask)
        compute_seconds = time.perf_counter() - t0
    if profiling.NAN_DEBUG:
        profiling.check_nans(f_np, p.max_iters, "the native engine", p.max_iters)
    return LbmResult(
        f_final=f_np,
        av_vels=av_np,
        compute_seconds=compute_seconds,
        reynolds=reynolds_number(p, float(av_np[-1])),
        total_density=state.total_density(f_np),
        engine="native",
    )


def run_simulation_with_checkpoints(
    params: Params,
    obstacles: Obstacles,
    *,
    checkpoint_path: str | Path,
    checkpoint_every: int,
    dtype=torch.float32,
    engine: str = "auto",
    resume: bool = False,
    num_steps: int | None = None,
    k_steps: int | None = None,
    device=None,
    strategy: str | None = None,
    num_devices: int | None = None,
) -> LbmResult:
    """Run in chunks of `checkpoint_every` steps, writing an atomic .npz
    checkpoint after each chunk; `resume=True` continues from an existing
    checkpoint. Chunking is bit-identical to one uninterrupted run of the
    same engine at the same K (and mesh): every chunk of a kernel engine
    starts from a fresh boundary snapshot (ghost bands) and Sum|u| is reduced
    in a fixed order. For the kernel engines ('sharded-cuda' too) the total
    and checkpoint_every must be multiples of k_steps. k_steps=None
    continues at the K a checkpoint records, else takes the largest of
    d2q9_kstep.PREFERRED_K, 4, 2, 1 dividing both. The checkpoint holds the
    whole state on the host, so one written on the card resumes on the CPU
    and the other way round (not bit for bit: the kernels and their plain
    version differ in the last digits). The sharded engines run on
    `num_devices` ranks (`parallel.launch`; rank 0 writes the checkpoint),
    'sharded-cuda' over a row mesh as the reference's does. 'native' runs
    the serial C++ engine on the host, whatever `device` says."""
    p = params if num_steps is None else dataclasses.replace(params, max_iters=num_steps)
    if engine == "native":
        return _checkpointed_native(p, obstacles, Path(checkpoint_path), checkpoint_every,
                                    dtype, resume)
    device = resolve_device(device)
    if engine == "auto":
        engine = choose_engine(p, dtype, device)
    if engine in SHARDED_ENGINES:
        n = _sharded_world(engine, strategy, False, num_devices, device)
        return launch.run(_checkpoint_rank, n, p, obstacles.mask, Path(checkpoint_path),
                          checkpoint_every, dtype, engine, strategy or "ppermute", resume,
                          k_steps, device_type=device.type)
    run_fn = {"cuda": d2q9_kstep.run, "cuda-inplace": d2q9_kstep_inplace.run,
              "cuda-manual": d2q9_kstep_manual.run}.get(engine)
    if run_fn is None and engine != "torch":
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES + SHARDED_ENGINES}")
    plan = _resume_plan(p, Path(checkpoint_path), resume, checkpoint_every, k_steps,
                        run_fn is not None, host_dtype(dtype))

    aw = d2q9.AccelWeights.from_params(p)
    accel_row = p.ny - 2
    f, mask = state.to_torch(plan.f_host, obstacles.mask, device=device)
    if plan.start == 0:
        f = d2q9.first_accelerate(f, mask, accel_row=accel_row, accel_w1=aw.w1, accel_w2=aw.w2)
    amask = d2q9.accel_row_mask(p.ny, p.nx, accel_row, dtype=f.dtype, device=device)
    kw = dict(omega=p.omega, accel_w1=aw.w1, accel_w2=aw.w2)

    def run_chunk(f, n):
        if run_fn is None:
            return d2q9.run(f, mask, amask, num_steps=n, **kw)
        return run_fn(f, mask, num_steps=n, accel_row=accel_row, k_steps=plan.k_steps, **kw)

    return _checkpoint_loop(p, plan, run_chunk, lambda f: f, (~mask).sum().to(f.dtype), f,
                            engine, write=True)


def _checkpointed_native(p: Params, obstacles: Obstacles, ck_path: Path, checkpoint_every: int,
                         dtype, resume: bool) -> LbmResult:
    """run_simulation_with_checkpoints' 'native' engine: each chunk a call
    of `d2q9_native.run`, which advances the numpy state in place."""
    from ..ops import d2q9_native

    np_dtype = numpy_dtype(dtype)
    plan = _resume_plan(p, ck_path, resume, checkpoint_every, None, False, np_dtype)
    aw = d2q9.AccelWeights.from_params(p)
    accel_row = p.ny - 2
    f = np.ascontiguousarray(plan.f_host)
    if plan.start == 0:
        d2q9_native.first_accelerate(f, obstacles.mask, accel_row=accel_row,
                                     accel_w1=aw.w1, accel_w2=aw.w2)
    step = plan.start

    def run_chunk(f, n):
        nonlocal step
        tot = d2q9_native.run(f, obstacles.mask, num_steps=n, omega=p.omega,
                              accel_w1=aw.w1, accel_w2=aw.w2, accel_row=accel_row)
        step += n
        if profiling.NAN_DEBUG:
            profiling.check_nans(f, step, "the native engine", n)
        # Sum|u| in the state's type, as d2q9_native.simulate divides it
        return f, torch.from_numpy(tot.astype(np_dtype))

    num_free = torch.tensor(np_dtype((~obstacles.mask).sum()))
    return _checkpoint_loop(p, plan, run_chunk, torch.from_numpy, num_free, f, "native",
                            write=True)


@dataclasses.dataclass
class _ResumePlan:
    ck_path: Path
    checkpoint_every: int
    k_steps: int | None  # None: an engine without K
    f_host: np.ndarray
    start: int
    av_parts: list


def _resume_plan(p: Params, ck_path: Path, resume: bool, checkpoint_every: int,
                 k_steps: int | None, kernel_engine: bool, np_dtype) -> _ResumePlan:
    """Where a checkpointed run starts: the checkpoint's state, step, av_vels
    and K when resuming, else the initial state; checks K against the
    checkpoint and the chunking. np_dtype is `host_dtype`'s (a bfloat16
    state is a host tensor)."""
    from ..core import checkpoint

    total = p.max_iters
    ck = checkpoint.load(ck_path, expect=p) if resume and ck_path.exists() else None

    # K after loading any checkpoint: a resume continues exactly as written
    recorded_k = (ck.k_steps or 0) if ck is not None else 0
    if kernel_engine:
        if k_steps is None:
            k_steps = recorded_k or next(
                k for k in (d2q9_kstep.PREFERRED_K, 4, 2, 1)
                if total % k == 0 and checkpoint_every % k == 0)
        if recorded_k and k_steps != recorded_k:
            raise ValueError(
                f"checkpoint was written at k_steps={recorded_k} but this run uses "
                f"k_steps={k_steps}; pass the writer's k_steps (or k_steps=None to adopt it)")
        if total % k_steps or checkpoint_every % k_steps:
            raise ValueError(
                f"kernel checkpointing needs num_steps ({total}) and checkpoint_every "
                f"({checkpoint_every}) divisible by k_steps ({k_steps}) for bit-exact chunking")
    else:
        k_steps = None

    if ck is not None:
        start = ck.step
        if start > total:
            raise ValueError(f"checkpoint is at step {start}, beyond the requested {total} "
                             "steps: nothing to resume")
        if kernel_engine and start % k_steps:
            raise ValueError(f"checkpoint step {start} is not a multiple of k_steps "
                             f"({k_steps}); resume with the engine that wrote it")
        return _ResumePlan(ck_path, checkpoint_every, k_steps, state.as_host(ck.f, np_dtype),
                           start, [np.asarray(ck.av_vels, np.float64)])
    return _ResumePlan(ck_path, checkpoint_every, k_steps, state.initial_distributions(p, np_dtype),
                       0, [])


def _checkpoint_loop(p: Params, plan: _ResumePlan, run_chunk, gather, num_free, f, engine: str,
                     write: bool) -> LbmResult:
    """The chunks of a checkpointed run from plan.start to p.max_iters:
    run_chunk(f, n) -> (f, Sum|u| (n,)), gather(f) -> the full state as a
    tensor; `write` on the rank that writes the checkpoint."""
    from ..core import checkpoint

    total, start, av_parts = p.max_iters, plan.start, plan.av_parts
    steps_run = total - start
    t0 = time.perf_counter()
    while start < total:
        n = min(plan.checkpoint_every, total - start)
        f, tot = run_chunk(f, n)
        # divide in f's dtype on the device, as each engine's simulate does
        av_parts.append((tot / num_free).double().cpu().numpy())
        start += n
        f_host = state.host_state(gather(f))
        if write:
            checkpoint.save(plan.ck_path, f_host, np.concatenate(av_parts), start, p,
                            k_steps=plan.k_steps)
    compute_seconds = time.perf_counter() - t0

    av_np = np.concatenate(av_parts) if av_parts else np.zeros(0)
    f_np = state.host_state(gather(f))
    return LbmResult(
        f_final=f_np,
        av_vels=av_np,
        compute_seconds=compute_seconds,
        reynolds=reynolds_number(p, float(av_np[-1])),
        total_density=state.total_density(f_np),
        engine=engine,
        steps_run=steps_run,
    )


def _sharded_world(engine: str, strategy: str | None, overlap: bool, num_devices: int | None,
                   device: torch.device) -> int:
    """Checks a sharded run's options and returns its number of ranks:
    num_devices, by default every GPU on CUDA and 1 on the CPU."""
    if engine == "sharded-cuda" and strategy not in (None, "ppermute"):
        raise ValueError(
            f"--strategy {strategy!r} applies to --engine sharded only; "
            "sharded-cuda always uses the ghost-band ring exchange")
    if engine == "sharded" and strategy not in (None, *STRATEGIES):
        raise ValueError(f"unknown strategy {strategy!r}; choose from {STRATEGIES}")
    if engine == "sharded" and overlap:
        raise ValueError("overlap=True applies to engine='sharded-cuda' only")
    n = num_devices or default_num_devices(device)
    launch.check_world(n, device.type)
    return n


def default_num_devices(device: torch.device) -> int:
    """Ranks of a sharded run by default: every GPU on CUDA, 1 on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _sharded_mesh(engine: str, p: Params):
    # the ghost-band engine runs over rows, as the reference's sharded-pallas
    if engine == "sharded-cuda":
        return kstep_sharded.make_row_mesh()
    return mesh_lib.make_mesh(None, p.ny, p.nx)


def _checkpoint_rank(p, mask, ck_path, checkpoint_every, dtype, engine, strategy, resume,
                     k_steps) -> LbmResult:
    """The body of a checkpointed sharded run on each rank; rank 0 writes the
    checkpoint and returns the result."""
    plan = _resume_plan(p, ck_path, resume, checkpoint_every, k_steps, engine == "sharded-cuda",
                        host_dtype(dtype))
    mesh = _sharded_mesh(engine, p)
    aw = d2q9.AccelWeights.from_params(p)
    kw = dict(omega=p.omega, accel_w1=aw.w1, accel_w2=aw.w2)
    first = plan.start == 0
    if engine == "sharded":
        f, padded_mask, amask, (pad_r, pad_c) = halo.prepare_sharded(
            p, plan.f_host, mask, mesh, strategy, first_accelerate=first)

        def run_chunk(f, n):
            return halo.run_strategy(strategy, f, padded_mask, amask, mesh=mesh, num_steps=n,
                                     pad_rows=pad_r, pad_cols=pad_c, **kw)
    else:
        f, mask_ext, _ = kstep_sharded.prepare(p, plan.f_host, mask, mesh, first_accelerate=first)

        def run_chunk(f, n):
            return kstep_sharded.run(f, mask_ext, mesh=mesh, num_steps=n, k_steps=plan.k_steps,
                                     accel_row=p.ny - 2, ny=p.ny, **kw)

    # the free-cell count in the state's type, as on one device
    num_free = torch.tensor(int((~np.asarray(mask, bool)).sum()), dtype=f.dtype,
                            device=f.to_local().device)
    return _checkpoint_loop(p, plan, run_chunk,
                            lambda f: f.full_tensor()[:, :p.ny, :p.nx], num_free, f,
                            engine, write=launch.is_rank0())


def run_simulation_sharded(
    params: Params,
    obstacles: Obstacles,
    *,
    dtype=torch.float32,
    strategy: str | None = None,
    engine: str = "sharded",
    num_devices: int | None = None,
    num_steps: int | None = None,
    overlap: bool = False,
    device=None,
) -> LbmResult:
    """Multi-device simulation over a mesh of `num_devices` ranks (default:
    every GPU on CUDA, 1 on the CPU), through `parallel.launch`: inside an
    initialised process group on its ranks, else on ranks it starts (NCCL
    on CUDA, gloo on the CPU).

    engine='sharded' runs the distributed plain step with the halo
    `strategy` (default 'ppermute', parallel/halo.py); engine='sharded-cuda'
    the communication-avoiding ghost-band path around kernel B1
    (parallel/kstep_sharded.py) over a row mesh, at K = 4; overlap=True
    (sharded-cuda only) rides the row-ghost exchange under the interior
    kernel. The timed run follows a warm-up run; on CUDA it is timed by
    events on rank 0's device, after a barrier."""
    device = resolve_device(device)
    p = params if num_steps is None else dataclasses.replace(params, max_iters=num_steps)
    if engine not in SHARDED_ENGINES:
        raise ValueError(f"unknown sharded engine {engine!r}; choose from {SHARDED_ENGINES}")
    n = _sharded_world(engine, strategy, overlap, num_devices, device)
    return launch.run(_sharded_rank, n, p, obstacles.mask, dtype, engine,
                      strategy or "ppermute", overlap, device_type=device.type)


def _sharded_rank(p, mask, dtype, engine, strategy, overlap) -> LbmResult | None:
    """The body of run_simulation_sharded on each rank."""
    import torch.distributed as dist

    mesh = _sharded_mesh(engine, p)
    f0 = state.initial_distributions(p, host_dtype(dtype))
    if engine == "sharded-cuda":
        def sim():
            return kstep_sharded.simulate(p, f0, mask, mesh, overlap=overlap)
    else:
        def sim():
            return halo.simulate_sharded(p, f0, mask, mesh, strategy=strategy)

    sim()[1].cpu()  # warm-up (kernel build and load)
    dist.barrier()
    if mesh_lib.device_type() == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        f_final, av = sim()
        end.record()
        end.synchronize()
        compute_seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        f_final, av = sim()
        compute_seconds = time.perf_counter() - t0
    if not launch.is_rank0():
        return None
    av_np = av.double().cpu().numpy()
    f_np = state.host_state(f_final)
    return LbmResult(
        f_final=f_np,
        av_vels=av_np,
        compute_seconds=compute_seconds,
        reynolds=reynolds_number(p, float(av_np[-1])),
        total_density=state.total_density(f_np),
        engine=engine,
    )


def write_outputs(
    result: LbmResult,
    params: Params,
    obstacles: Obstacles,
    out_dir: str | Path = ".",
) -> tuple[Path, Path]:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    av_path = out_dir / "av_vels.dat"
    fs_path = out_dir / "final_state.dat"
    io.write_av_vels(av_path, result.av_vels)
    io.write_final_state(fs_path, params, obstacles.mask, result.f_final)
    return av_path, fs_path


def print_summary(result: LbmResult) -> None:
    print("==done==")
    print(f"Reynolds number:\t\t{result.reynolds:.12E}")
    print(f"Total compute time:\t\t{result.compute_seconds:.6f} (s)")
    print(f"Total density:\t\t\t{result.total_density:.6E}")
    steps = result.av_vels.size if result.steps_run is None else result.steps_run
    if steps:
        mlups = (
            steps
            * result.f_final.shape[-1]
            * result.f_final.shape[-2]
            / result.compute_seconds
            / 1e6
        )
        print(f"MLUPS:\t\t\t\t{mlups:.1f}")
    else:
        print("MLUPS:\t\t\t\t- (nothing to run)")
