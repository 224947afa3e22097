"""End-to-end D2Q9 lattice-Boltzmann simulation driver.

The counterpart of `lbm_tpu.models.lbm` (`run_simulation`,
`run_simulation_with_checkpoints` on one device, `write_outputs`,
`print_summary`): load params and obstacles, initialise, run the timestep
loop on the device, write av_vels.dat / final_state.dat and print the
`==done==` summary block (main/LastChance.cpp:279-284).
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

ENGINES = ("torch", "cuda", "cuda-inplace", "cuda-manual", "auto")


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
    np_dtype = NP_DTYPES.get(dtype)
    if np_dtype is None:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    return np_dtype


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
    the kernel engines run their kernels' plain version."""
    device = resolve_device(device)
    p = params if num_steps is None else dataclasses.replace(params, max_iters=num_steps)
    if engine == "auto":
        engine = choose_engine(p, dtype, device)
    simulate = {"torch": d2q9.simulate, "cuda": d2q9_kstep.simulate,
                "cuda-inplace": d2q9_kstep_inplace.simulate,
                "cuda-manual": d2q9_kstep_manual.simulate}.get(engine)
    if simulate is None:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")

    f0, mask = state.to_torch(state.initial_distributions(p, numpy_dtype(dtype)),
                              obstacles.mask, device=device)

    # warm-up run (kernel build and load) outside the timed one, as
    # lbm_tpu.models.lbm.run_simulation does; its state is dropped at once,
    # so the timed run holds what choose_engine reckoned
    simulate(p, f0, mask)[1].cpu()

    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        f_final, av_vels = simulate(p, f0, mask)
        end.record()
        end.synchronize()
        compute_seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        f_final, av_vels = simulate(p, f0, mask)
        compute_seconds = time.perf_counter() - t0

    av_np = av_vels.cpu().numpy().astype(np.float64)
    f_np = f_final.cpu().numpy()
    return LbmResult(
        f_final=f_np,
        av_vels=av_np,
        compute_seconds=compute_seconds,
        reynolds=reynolds_number(p, float(av_np[-1])),
        total_density=state.total_density(f_np),
        engine=engine,
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
) -> LbmResult:
    """Run in chunks of `checkpoint_every` steps, writing an atomic .npz
    checkpoint after each chunk; `resume=True` continues from an existing
    checkpoint. Chunking is bit-identical to one uninterrupted run of the
    same engine at the same K: every chunk of a kernel engine starts from a
    fresh boundary snapshot and Sum|u| is reduced in a fixed order. For the
    kernel engines the total and checkpoint_every must be multiples of
    k_steps. k_steps=None continues at the K a checkpoint records, else takes
    the largest of d2q9_kstep.PREFERRED_K, 4, 2, 1 dividing both. The
    checkpoint holds the state on the host, so one written on the card
    resumes on the CPU and the other way round (not bit for bit: the kernels
    and their plain version differ in the last digits)."""
    from ..core import checkpoint

    device = resolve_device(device)
    np_dtype = numpy_dtype(dtype)
    p = params if num_steps is None else dataclasses.replace(params, max_iters=num_steps)
    if engine == "auto":
        engine = choose_engine(p, dtype, device)
    run_fn = {"cuda": d2q9_kstep.run, "cuda-inplace": d2q9_kstep_inplace.run,
              "cuda-manual": d2q9_kstep_manual.run}.get(engine)
    if run_fn is None and engine != "torch":
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    total = p.max_iters
    kernel_engine = run_fn is not None

    ck_path = Path(checkpoint_path)
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

    if ck is not None:
        f_host = np.asarray(ck.f, np_dtype)
        start = ck.step
        if start > total:
            raise ValueError(f"checkpoint is at step {start}, beyond the requested {total} "
                             "steps: nothing to resume")
        if kernel_engine and start % k_steps:
            raise ValueError(f"checkpoint step {start} is not a multiple of k_steps "
                             f"({k_steps}); resume with the engine that wrote it")
        av_parts = [np.asarray(ck.av_vels, np.float64)]
    else:
        f_host = state.initial_distributions(p, np_dtype)
        start = 0
        av_parts = []

    aw = d2q9.AccelWeights.from_params(p)
    accel_row = p.ny - 2
    f, mask = state.to_torch(f_host, obstacles.mask, device=device)
    if start == 0:
        f = d2q9.first_accelerate(f, mask, accel_row=accel_row, accel_w1=aw.w1, accel_w2=aw.w2)
    amask = d2q9.accel_row_mask(p.ny, p.nx, accel_row, dtype=f.dtype, device=device)
    num_free = (~mask).sum().to(f.dtype)
    kw = dict(omega=p.omega, accel_w1=aw.w1, accel_w2=aw.w2)

    steps_run = total - start
    t0 = time.perf_counter()
    while start < total:
        n = min(checkpoint_every, total - start)
        if kernel_engine:
            f, tot = run_fn(f, mask, num_steps=n, accel_row=accel_row, k_steps=k_steps, **kw)
        else:
            f, tot = d2q9.run(f, mask, amask, num_steps=n, **kw)
        # divide in f's dtype on the device, as each engine's simulate does
        av_parts.append((tot / num_free).cpu().numpy().astype(np.float64))
        start += n
        checkpoint.save(ck_path, f.cpu().numpy(), np.concatenate(av_parts), start, p,
                        k_steps=k_steps if kernel_engine else None)
    compute_seconds = time.perf_counter() - t0

    av_np = np.concatenate(av_parts) if av_parts else np.zeros(0)
    f_np = f.cpu().numpy()
    return LbmResult(
        f_final=f_np,
        av_vels=av_np,
        compute_seconds=compute_seconds,
        reynolds=reynolds_number(p, float(av_np[-1])),
        total_density=state.total_density(f_np),
        engine=engine,
        steps_run=steps_run,
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
