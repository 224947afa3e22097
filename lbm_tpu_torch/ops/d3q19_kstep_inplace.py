"""K D3Q19 steps per pass, written back in place: the wrapper of CUDA kernel
B4, the production 3-D engine.

The counterpart of `lbm_tpu.ops.d3q19_pallas_inplace` (kernel `_kernel`,
`stepk`, `run`), with the contract of `d3q19_kstep` except that the state is
advanced IN PLACE: `stepk` and `run` overwrite `f` and return it, and no
second lattice is allocated. The choice between this kernel (the 'slab' kind)
and the blocked in-place kernel B5, `pick_engine` and `choose_k` of the
reference's `d3q19_pallas_inplace_blocked`, is in
`d3q19_kstep_inplace_blocked`; `choose_k` here is this kernel's own K.

The TPU kernel is safe in place because its slabs run in order (delayed
write-back, wraparound snapshot). On the card blocks run in no order, so the
kernel alternates two kinds of step that each read and write the same 19
slots per cell, and restores the natural layout with a swap after an odd
number of steps (csrc/d3q19_kstep.cu). On the wave path (`d3q19_kstep.PATHS`,
`choose_path` with kernel "b4") a pass is one launch, the swap its last
stage; on the step path a launch a step and one for the swap. The launch
reports its path in `last_path`. B4's state and Sum|u| are bit-identical to
B6's. A bfloat16 state takes the step path and rounds once a pass, through
a float32 scratch lattice for K > 1 (19 x 4 bytes a cell beside the
lattice's 19 x 2).
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import d3q19_kstep
from .d2q9_kstep import check_rc, obstacle_u8
from .d3q19_kstep import choose_k  # noqa: F401  (the in-place engine's own K)

# Launches of kernel B4 (one per K-step pass); callers may reset it.
launches = 0
# The path of the last launch of B4 ("wave" or "step").
last_path = None


def _launch(f, mask_u8, partials, tot, *, path, scalars, plan=None, scratch=None):
    global launches, last_path
    launches += 1
    last_path = path
    if path == "step":
        bufs = [f.data_ptr(), mask_u8.data_ptr()]
        if f.dtype == torch.bfloat16:  # the float32 lattice a pass of K > 1 steps through
            bufs.append(0 if scratch is None else scratch.data_ptr())
        rc = d3q19_kstep.entry(f, "d3q19_kstep_inplace")(
            *bufs, partials.data_ptr(), tot.data_ptr(), *scalars)
        check_rc(rc, "d3q19_kstep_inplace")
        return
    d3q19_kstep.wave_launch(f, f, mask_u8, partials, tot, plan, mode="full", scalars=scalars,
                            what="d3q19_wave (in place)")


def _setup(f, mask, k_steps, block, path, **kw):
    """(mask as bytes, partials, launch arguments) of a CUDA pass."""
    mask_u8 = obstacle_u8(mask)
    block, nblocks, scalars = d3q19_kstep.kernel_args(f, mask_u8, k_steps=k_steps, block=block,
                                                      **kw)
    path = d3q19_kstep.resolve_path(path, f, k_steps, kernel="b4", block=block)
    plan = (d3q19_kstep.wave_plan(f, k_steps, inplace=True, mode="full", block=block)
            if path == "wave" else None)
    partials = d3q19_kstep.sums(f, k_steps * nblocks)
    return mask_u8, partials, dict(path=path, scalars=scalars, plan=plan,
                                   scratch=d3q19_kstep.rounding_scratch(f, k_steps))


def stepk(
    f: torch.Tensor,
    mask: torch.Tensor,
    *,
    k_steps: int,
    omega: float,
    density: float,
    accel: float,
    accel_plane: int,
    plane_offset: int = 0,
    valid_planes: tuple | None = None,
    valid_rows: tuple | None = None,
    global_nz: int | None = None,
    block: tuple[int, int, int] | None = None,
    path: str | None = None,
):
    """K timesteps in one in-place pass (kernel B4 on CUDA,
    `d3q19_kstep.stepk_plain` on the CPU). Overwrites f with the state after
    K steps; returns (f, tot_u per step (K,)). `path` as in
    `d3q19_kstep.stepk`."""
    kw = dict(omega=omega, density=density, accel=accel, accel_plane=accel_plane,
              plane_offset=plane_offset, valid_planes=valid_planes, valid_rows=valid_rows,
              global_nz=global_nz)
    if f.device.type == "cpu":
        f_new, tot = d3q19_kstep.stepk_plain(f, mask, k_steps=k_steps, **kw)
        f.copy_(f_new)
        return f, tot
    mask_u8, partials, launch = _setup(f, mask, k_steps, block, path, **kw)
    tot = d3q19_kstep.sums(f, k_steps)
    _launch(f, mask_u8, partials, tot, **launch)
    return f, tot


def run(
    f: torch.Tensor,
    mask: torch.Tensor,
    *,
    num_steps: int,
    omega: float,
    density: float,
    accel: float,
    accel_plane: int,
    k_steps: int = 1,
    block: tuple[int, int, int] | None = None,
    path: str | None = None,
):
    """`num_steps` timesteps, `k_steps` per in-place pass. Overwrites f;
    returns (f, tot_u (num_steps,)). `path` as in `d3q19_kstep.stepk`."""
    if num_steps % k_steps:
        raise ValueError(f"num_steps {num_steps} not a multiple of k_steps {k_steps}")
    kw = dict(omega=omega, density=density, accel=accel, accel_plane=accel_plane)
    tots = d3q19_kstep.sums(f, num_steps)
    if f.device.type == "cpu":
        for i in profiling.passes(num_steps // k_steps, "B4", "plain", k_steps):
            f_new, tots[i * k_steps:(i + 1) * k_steps] = d3q19_kstep.stepk_plain(
                f, mask, k_steps=k_steps, **kw)
            f.copy_(f_new)
        return f, tots
    mask_u8, partials, launch = _setup(f, mask, k_steps, block, path, **kw)
    for i in profiling.passes(num_steps // k_steps, "B4", launch["path"], k_steps):
        _launch(f, mask_u8, partials, tots[i * k_steps:(i + 1) * k_steps], **launch)
    return f, tots
