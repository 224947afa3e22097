"""The 3-D job: one whole D3Q19 run through the program's own entry,
`lbm_tpu_torch.ops.d3q19.advance` (what `cli.lbm3d` times): the host's start
state and mask uploaded by `core.state.to_torch3d`, `advance` on the
configuration's engine, the final state and the av_vels series back on the
host.

The start state is the channel at rest at the configuration's density with
a seeded perturbation: speed k holds density * W[k] * (1 + amplitude * r),
r uniform in [-1, 1), drawn on the card from the seed and brought to the
host once in set-up. Every job of a run starts from it, so one replay by the
reference judges them all. Walls are the planes z = 0 and z = nz-1.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import d3q19 as ref
from benchmark.reference.lattice import STORAGE

def start_state(nz: int, ny: int, nx: int, density: float, amplitude: float, seed: int,
                device) -> torch.Tensor:
    """The perturbed rest state, float32, on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    r = torch.rand((19, nz, ny, nx), generator=gen, device=device, dtype=torch.float32)
    w = torch.tensor(ref.W, dtype=torch.float32, device=device)[:, None, None, None]
    return (density * w) * (1.0 + amplitude * (2.0 * r - 1.0))


class Job:
    def __init__(self, config: dict, config_dir, traffic: dict, seed: int, device):
        self.device = device
        self.dtype = STORAGE[traffic["dtype"]]
        self.control = STORAGE[traffic["control"]]
        self.store_every = int(traffic["store_every"])
        self.engine = config["engine"]
        nz, ny, nx = config["nz"], config["ny"], config["nx"]
        self.steps, self.warmup_steps = config["steps"], config["warmup_steps"]
        self.kw = dict(omega=config["omega"], density=config["density"], accel=config["accel"])
        self.mask = np.zeros((nz, ny, nx), bool)
        self.mask[0] = self.mask[-1] = True
        f = start_state(nz, ny, nx, config["density"], config["perturbation"], seed, device)
        # the host state as a user holds it: numpy, or a bfloat16 CPU tensor
        f = f.to(self.dtype).cpu()
        self.f_host = f if self.dtype == torch.bfloat16 else f.numpy()
        self.updates = nz * ny * nx * self.steps
        self.flop = ref.FLOP_PER_UPDATE * self.updates
        itemsize = torch.empty(0, dtype=self.dtype).element_size()
        self.bytes = 2 * 19 * nz * ny * nx * itemsize + nz * ny * nx + 4 * self.steps
        self.compute = "float32"

    def _run(self, steps):
        from lbm_tpu_torch.core import state
        from lbm_tpu_torch.ops import d3q19

        f, mask = state.to_torch3d(self.f_host, self.mask, device=self.device)
        f_final, av = d3q19.advance(f, mask, num_steps=steps, engine=self.engine, **self.kw)
        return state.host_state(f_final), av.double().cpu().numpy()

    def warm_up(self):
        self._run(self.warmup_steps)

    def run(self):
        return self._run(self.steps)

    def release(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, storage, store_every=None):
        f0 = self.f_host if isinstance(self.f_host, torch.Tensor) else torch.from_numpy(self.f_host)
        return ref.solve(f0, self.mask, steps=self.steps, storage=storage,
                               store_every=store_every or self.store_every, device=self.device, **self.kw)

    def obstacle(self) -> torch.Tensor:
        return torch.as_tensor(self.mask, device=self.device)

    speed = staticmethod(ref.speed)
