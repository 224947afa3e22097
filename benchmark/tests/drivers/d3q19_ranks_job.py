"""A job on every rank of a multi-card run, for the benchmark's tests and
the proof runs of the harness: one whole D3Q19 run from the uniform state
at rest with the channel's walls (planes z = 0 and nz-1) and an obstacle
block whose place the seed draws. Each rank returns its own z-slab of the
final state (planes nz*r/n up to nz*(r+1)/n of n ranks) and the av_vels
series, and replays its own slab with the plain slab reference
(`reference.d3q19.solve_slab`, the ghost planes exchanged between the
ranks) to judge it by.

`engine`: a multi-device engine of the program (`SHARDED_ENGINES`) runs
once over every rank of the harness's group through `ops.d3q19.simulate`;
any other engine runs `ops.d3q19.advance` on each rank alone, the same job
on each card (replicas), from a start state built on the card in place
(`rest_state`). `last_state_only`: the job declares the harness's
last-state-only judging, and a replica returns its slab on the card.
Faults, for the tests (`fault`: {"kind", "rank"}, on that rank): "raise"
(run() raises), "sleep" (run() sleeps `seconds`), "alter" (one value of the
rank's slab doubled; in the job numbered `job` alone, counted from 0, where
that is given), "idle" (a replica engine only: run() hands back an answer
made in set-up and touches no card). `dump`: a directory where each rank
saves its first answer (`rank<r>.npz`).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import d3q19 as ref
from benchmark.reference.lattice import STORAGE


def obstacle_mask(nz: int, ny: int, nx: int, seed: int) -> np.ndarray:
    """The wall planes z = 0 and nz-1, and a block of (nz/4, ny/4, nx/4)
    cells at a place drawn from the seed, off the walls."""
    mask = np.zeros((nz, ny, nx), bool)
    mask[0] = mask[-1] = True
    bz, by, bx = max(1, nz // 4), max(1, ny // 4), max(1, nx // 4)
    rng = np.random.default_rng(seed)
    z = int(rng.integers(1, nz - 1 - bz + 1))
    y, x = int(rng.integers(0, ny - by + 1)), int(rng.integers(0, nx - bx + 1))
    mask[z:z + bz, y:y + by, x:x + bx] = True
    return mask


def rest_state(shape, density: float, dtype, device):
    """The uniform state at rest (19, ...) in `dtype`, filled a speed at a
    time on `device`: speed k holds density * W[k], rounded to float32 and
    then to `dtype`."""
    w = (density * torch.tensor(ref.W, dtype=torch.float64)).float()
    f = torch.empty(shape, dtype=dtype, device=device)
    for k in range(19):
        f[k].fill_(w[k].item())
    return f


class Job:
    def __init__(self, config: dict, config_dir, traffic: dict, seed: int, device):
        import torch.distributed as dist

        from lbm_tpu_torch.ops import d3q19

        self.rank, self.size = ((dist.get_rank(), dist.get_world_size())
                                if dist.is_initialized() else (0, 1))
        self.device = device
        self.dtype = STORAGE[traffic["dtype"]]
        self.control = STORAGE[traffic["control"]]
        self.store_every = int(traffic["store_every"])
        self.engine = config["engine"]
        self.sharded = self.engine in d3q19.SHARDED_ENGINES
        self.shape = nz, ny, nx = config["nz"], config["ny"], config["nx"]
        self.lo, self.hi = nz * self.rank // self.size, nz * (self.rank + 1) // self.size
        self.steps, self.warmup_steps = config["steps"], config["warmup_steps"]
        self.kw = dict(omega=config["omega"], density=config["density"], accel=config["accel"])
        self.mask = obstacle_mask(nz, ny, nx, seed)
        self.last_state_only = bool(config.get("last_state_only", False))
        fault = config.get("fault", {})
        self.fault = fault.get("kind") if fault.get("rank") == self.rank else None
        self.sleep_s = float(fault.get("seconds", 0))
        self.fault_job, self.jobs = fault.get("job"), 0
        if self.fault == "idle" and self.sharded:
            raise ValueError("an idle rank leaves a multi-device engine's collectives: "
                             "the others would wait for it")
        self.dump = Path(config["dump"]) if "dump" in config else None
        self.cached = None
        self.updates = nz * ny * nx * self.steps
        self.flop = ref.FLOP_PER_UPDATE * self.updates
        itemsize = torch.empty(0, dtype=self.dtype).element_size()
        self.bytes = 2 * 19 * nz * ny * nx * itemsize + nz * ny * nx + 4 * self.steps
        self.compute = "float32"

    def _run(self, steps):
        from lbm_tpu_torch.ops import d3q19

        if self.sharded:
            f, av = d3q19.simulate(*self.shape, num_steps=steps, engine=self.engine,
                                   obstacle_mask=self.mask, dtype=self.dtype,
                                   device=self.device, num_devices=self.size, **self.kw)
            return f[:, self.lo:self.hi].cpu(), av.double().cpu().numpy()
        f = rest_state((19, *self.shape), self.kw["density"], self.dtype, self.device)
        mask = torch.as_tensor(self.mask, device=self.device)
        f, av = d3q19.advance(f, mask, num_steps=steps, engine=self.engine, **self.kw)
        f = f[:, self.lo:self.hi]
        return (f if self.last_state_only else f.cpu()), av.double().cpu().numpy()

    def warm_up(self):
        self._run(self.warmup_steps)
        if self.fault == "idle":
            self.cached = self._run(self.steps)

    def run(self):
        if self.fault == "idle":
            return self.cached
        if self.fault == "raise":
            raise RuntimeError(f"a fault planted on rank {self.rank}")
        if self.fault == "sleep":
            time.sleep(self.sleep_s)
        f, av = self._run(self.steps)
        if self.fault == "alter" and self.fault_job in (None, self.jobs):
            f[1, 0, 0, 0] *= 2
        self.jobs += 1
        if self.dump is not None and not (self.dump / f"rank{self.rank}.npz").exists():
            np.savez(self.dump / f"rank{self.rank}.npz", f=f.float().cpu().numpy(), av=av)
        return f, av

    def release(self):
        self.cached = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, storage, store_every=None):
        """This rank's slab replayed by the slab reference on this rank's
        device."""
        nz, ny, nx = self.shape
        f0 = rest_state((19, self.hi - self.lo, ny, nx), self.kw["density"], storage,
                        self.device)
        return ref.solve_slab(f0, self.obstacle(), nz=nz, lo=self.lo, steps=self.steps,
                              storage=storage, store_every=store_every or self.store_every,
                              **self.kw)

    def obstacle(self) -> torch.Tensor:
        return torch.as_tensor(self.mask[self.lo:self.hi], device=self.device)

    speed = staticmethod(ref.speed)
