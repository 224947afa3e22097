"""End-to-end D2Q9 lattice-Boltzmann simulation driver.

The counterpart of `lbm_tpu.models.lbm` (`run_simulation`, `write_outputs`,
`print_summary`): load params and obstacles, initialise, run the timestep
loop on the device, write av_vels.dat / final_state.dat and print the
`==done==` summary block (main/LastChance.cpp:279-284).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from ..core import io, state
from ..core.params import Obstacles, Params, reynolds_number
from ..ops import d2q9, d2q9_kstep, d2q9_kstep_inplace

ENGINES = ("torch", "cuda", "cuda-inplace", "auto")


@dataclasses.dataclass
class LbmResult:
    f_final: np.ndarray
    av_vels: np.ndarray
    compute_seconds: float
    reynolds: float
    total_density: float
    engine: str


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


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
    (kernel B1, in place, ops/d2q9_kstep_inplace.py) or 'auto'
    (d2q9_kstep.choose_engine). On the CPU the kernel engines run their
    kernels' plain version."""
    device = resolve_device(device)
    p = params if num_steps is None else dataclasses.replace(params, max_iters=num_steps)
    if engine == "auto":
        engine = d2q9_kstep.choose_engine(p.ny, p.nx)
    simulate = {"torch": d2q9.simulate, "cuda": d2q9_kstep.simulate,
                "cuda-inplace": d2q9_kstep_inplace.simulate}.get(engine)
    if simulate is None:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")

    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}.get(dtype)
    if np_dtype is None:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    f0, mask = state.to_torch(state.initial_distributions(p, np_dtype), obstacles.mask,
                              device=device)

    # warm-up run (kernel build and load) outside the timed one, as
    # lbm_tpu.models.lbm.run_simulation does
    _, av_vels = simulate(p, f0, mask)
    av_vels.cpu()

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
    steps = result.av_vels.size
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
