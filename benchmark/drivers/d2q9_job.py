"""The 2-D job: one whole D2Q9 run through the program's own entry,
`lbm_tpu_torch.models.lbm.run_simulation` (what `cli.lbm` calls), from the
configuration's parameters and obstacle mask to the final state and the
av_vels series on the host.

The seed moves the mask's interior block by a whole-cell offset that keeps
it inside the walls; its shape, its cell count and the walls stay. Every job
of a run gets the same inputs, so one replay by the reference judges them
all.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import d2q9 as ref
from benchmark.reference.lattice import STORAGE

def load_mask(path, ny: int, nx: int) -> np.ndarray:
    """A mask stored as np.packbits of its (ny, nx) cells, row-major."""
    with np.load(path) as z:
        bits = np.unpackbits(z["bits"], count=ny * nx)
    return bits.reshape(ny, nx).astype(bool)


def move_block(mask: np.ndarray, seed: int) -> np.ndarray:
    """The mask with its interior cells (all but the outer ring) moved by a
    seeded whole-cell offset that keeps them off the ring."""
    ring = np.zeros_like(mask)
    ring[0] = ring[-1] = True
    ring[:, 0] = ring[:, -1] = True
    if not (mask & ring).sum() == ring.sum():
        raise ValueError("the mask's outer ring is not all wall")
    inner = mask & ~ring
    ys, xs = np.nonzero(inner)
    if not len(ys):
        return mask.copy()
    rng = np.random.default_rng(seed)
    ny, nx = mask.shape
    dy = int(rng.integers(1 - ys.min(), ny - 2 - ys.max() + 1))
    dx = int(rng.integers(1 - xs.min(), nx - 2 - xs.max() + 1))
    out = ring.copy()
    out[ys + dy, xs + dx] = True
    return out


class Job:
    def __init__(self, config: dict, config_dir, traffic: dict, seed: int, device):
        from lbm_tpu_torch.core.params import Obstacles, Params

        self.device = device
        self.dtype = STORAGE[traffic["dtype"]]
        self.control = STORAGE[traffic["control"]]
        self.store_every = int(traffic["store_every"])
        self.engine = config["engine"]
        ny, nx = config["ny"], config["nx"]
        self.mask = move_block(load_mask(config_dir / config["mask"], ny, nx), seed)
        self.params = Params(nx=nx, ny=ny, max_iters=config["steps"],
                             reynolds_dim=config["reynolds_dim"], density=config["density"],
                             accel=config["accel"], omega=config["omega"])
        self.obstacles = Obstacles(self.mask)
        self.warmup_steps = config["warmup_steps"]
        self.updates = nx * ny * config["steps"]
        self.flop = ref.FLOP_PER_UPDATE * self.updates
        itemsize = torch.empty(0, dtype=self.dtype).element_size()
        # the least a job moves: the start state in and the final state out,
        # the mask in, av_vels out
        self.bytes = 2 * 9 * nx * ny * itemsize + nx * ny + 4 * config["steps"]
        self.compute = "float32"

    def _run(self, steps=None):
        from lbm_tpu_torch.models.lbm import run_simulation

        r = run_simulation(self.params, self.obstacles, dtype=self.dtype, engine=self.engine,
                           num_steps=steps, device=self.device)
        return r.f_final, r.av_vels

    def warm_up(self):
        self._run(self.warmup_steps)

    def run(self):
        return self._run()

    def release(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, storage, store_every=None):
        p = self.params
        return ref.solve(ny=p.ny, nx=p.nx, steps=p.max_iters, density=p.density,
                               accel=p.accel, omega=p.omega, mask=self.mask, storage=storage,
                               store_every=store_every or self.store_every, device=self.device)

    def obstacle(self) -> torch.Tensor:
        return torch.as_tensor(self.mask, device=self.device)

    speed = staticmethod(ref.speed)
