"""K D3Q19 steps per pass: the wrapper of CUDA kernel B6 (two-stream).

The counterpart of the z-slab part of `lbm_tpu.ops.d3q19_pallas` (kernel
`_kernel`, `stepk`, `run`, `choose_config`). One call of the C entry point of
`csrc/d3q19_kstep.cu` advances the whole lattice K steps, in -> out, and
returns the per-step Sum|u| over the valid window. See the note at the top of
the source for the design and its bound on the card.

Contract of `stepk` (shared with `d3q19_kstep_inplace.stepk`):
  * f is (19, nz, ny, nx) float32/float64 and contiguous; mask is the
    (nz, ny, nx) obstacle mask (bool or uint8, nonzero = blocked);
  * plane_offset / valid_planes / valid_rows / global_nz describe a
    ghost-extended block as in `lbm_tpu.ops.d3q19_pallas.stepk`: local plane
    p is global plane p + plane_offset, the accelerated plane is tested as
    (p + plane_offset) mod global_nz == accel_plane, and only cells inside
    planes [valid_planes) x rows [valid_rows) count towards Sum|u|;
  * any grid shape is taken (edge blocks are masked), and k_steps lies in
    1..MAX_K;
  * on a CUDA tensor the kernel is launched, or the call raises; on a CPU
    tensor the plain version `stepk_plain` runs. There is no other route.

`stepk_plain` is the plain PyTorch version: K steps of `d3q19` on the whole
periodic array. It agrees with the CUDA kernels on every cell for every
window, since both take each step on planes [0, nz) only. The TPU kernels
also step their K-plane halo and test those planes at their unwrapped index,
so they agree with both whenever global_nz == nz, or the accelerated plane
lies more than K planes from the array's first and last plane (in the
sharded use those planes are ghosts outside the valid window).
"""

from __future__ import annotations

import torch

from . import d3q19
from .d2q9_kstep import check_rc, obstacle_bool, obstacle_u8
from .d3q19_lattice import W

# Launches of kernel B6 (one per K-step pass); callers may reset it.
launches = 0

MAX_K = 4
# Threads per block along (x, y, z), in order of preference: the first whose
# x extent is not wider than the grid (rounded up to a warp). Measured at
# 64x128x256 float32 on an H100 (experiments/cuda-kstep-tiles/results3d.csv):
# the nine shapes tried lie within 3% of each other for B6 and 10% for B4,
# and the longest x extent is the fastest (256x1x1: B6 0.2406, B4 0.2411 ms
# per 2-step pass; 32x8x1: 0.2472, 0.2658).
BLOCK_CANDIDATES = ((256, 1, 1), (128, 2, 1), (64, 4, 1), (32, 8, 1))
MAX_THREADS_PER_BLOCK = 256
# Steps per pass that `choose_k` prefers. A pass of K steps is K launches of
# the one-step kernel, so K moves no less data: B6 takes 0.1218, 0.2406,
# 0.3589 and 0.4774 ms at K = 1..4 (results3d.csv). The in-place kernel B4
# pays for a swap of the lattice after an odd K (0.3046 ms at K=1 and 0.5422
# at K=3, against 0.2411 at K=2), so the preferred K is the smallest even one.
PREFERRED_K = 2


def choose_block(nx: int) -> tuple[int, int, int]:
    """(bx, by, bz) threads per block for a grid nx cells wide."""
    width = -(-nx // 32) * 32
    for block in BLOCK_CANDIDATES:
        if block[0] <= width:
            return block
    return BLOCK_CANDIDATES[-1]


def choose_k(*step_counts: int) -> int:
    """Steps per pass for a run: PREFERRED_K when it divides every one of
    `step_counts` (the total, and the chunk of a checkpointed run), else the
    largest smaller K that does."""
    return next(k for k in range(PREFERRED_K, 0, -1) if all(n % k == 0 for n in step_counts))


def coefficients(omega: float, density: float, accel: float) -> list[float]:
    """The six scalars of the collision as `d3q19.collide_fields` forms them,
    in double: 1 - omega, (W * omega) of the rest, axis and edge speeds, and
    the force density * accel * W of the axis and edge speeds."""
    return [1.0 - omega, float(W[0]) * omega, float(W[1]) * omega, float(W[7]) * omega,
            density * accel * float(W[1]), density * accel * float(W[7])]


def stepk_plain(
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
):
    """The plain PyTorch version of the K-step kernels: K steps of
    `d3q19.collide_fields` on `d3q19.stream_pull`, with per-step Sum|u| over
    the valid window only. Returns (f_after_K, tot (K,))."""
    _, nz, ny, nx = f.shape
    valid_planes = valid_planes or (0, nz)
    valid_rows = valid_rows or (0, ny)
    planes = torch.arange(nz, device=f.device)
    amask = (torch.remainder(planes + int(plane_offset), global_nz or nz)
             == accel_plane).to(f.dtype)[:, None, None]
    rows = torch.arange(ny, device=f.device)
    window = (((planes >= valid_planes[0]) & (planes < valid_planes[1]))[:, None, None]
              & ((rows >= valid_rows[0]) & (rows < valid_rows[1]))[None, :, None])
    obstacle = obstacle_bool(mask)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    tots = []
    for _ in range(k_steps):
        f, u = d3q19.collide_fields(d3q19.stream_pull(f), obstacle, amask, omega=omega,
                                    density=density, accel=accel)
        tots.append(torch.where(window, u, zero).sum())
    return f, torch.stack(tots)


def check_state(f: torch.Tensor, mask_u8: torch.Tensor, k_steps: int) -> None:
    """Raises on a state, mask or K that the 3-D CUDA kernels do not take."""
    if f.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on {f.device}")
    if f.dim() != 4 or f.shape[0] != 19:
        raise ValueError(f"state must have shape (19, nz, ny, nx), got {tuple(f.shape)}")
    if f.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernel takes float32 or float64, got {f.dtype}")
    if not f.is_contiguous():
        raise ValueError("state must be contiguous")
    _, nz, ny, nx = f.shape
    if mask_u8.shape != (nz, ny, nx) or mask_u8.device != f.device or mask_u8.dtype != torch.uint8:
        raise ValueError(f"mask must be ({nz}, {ny}, {nx}) uint8 on {f.device}")
    if not 1 <= k_steps <= MAX_K:
        raise ValueError(f"k_steps must be in 1..{MAX_K}, got {k_steps}")


def window_scalars(f: torch.Tensor, *, omega: float, density: float, accel: float,
                   accel_plane: int, plane_offset: int = 0, valid_planes: tuple | None = None,
                   valid_rows: tuple | None = None, global_nz: int | None = None) -> list:
    """The trailing arguments of every 3-D C entry point: the window, the
    accelerated plane, the six collision coefficients and the stream."""
    _, nz, ny, _ = f.shape
    valid_planes = valid_planes or (0, nz)
    valid_rows = valid_rows or (0, ny)
    return [int(plane_offset), int(valid_planes[0]), int(valid_planes[1]),
            int(global_nz or nz), int(valid_rows[0]), int(valid_rows[1]), int(accel_plane),
            *coefficients(omega, density, accel),
            torch.cuda.current_stream(f.device).cuda_stream]


def kernel_args(f: torch.Tensor, mask_u8: torch.Tensor, *, k_steps: int,
                block: tuple | None = None, **window):
    """Checks a CUDA call of either one-step kernel and returns (nblocks, the
    trailing scalar arguments of its C entry point)."""
    check_state(f, mask_u8, k_steps)
    _, nz, ny, nx = f.shape
    bx, by, bz = block or choose_block(nx)
    threads = bx * by * bz
    if min(bx, by, bz) < 1 or threads > MAX_THREADS_PER_BLOCK or threads % 32:
        raise ValueError(f"block {(bx, by, bz)} must hold a multiple of 32 threads, at most "
                         f"{MAX_THREADS_PER_BLOCK}")
    nblocks = -(-nx // bx) * -(-ny // by) * -(-nz // bz)
    return nblocks, [nz, ny, nx, bx, by, bz, int(k_steps), *window_scalars(f, **window)]


def entry(f: torch.Tensor, name: str):
    from . import _build

    suffix = "f32" if f.dtype == torch.float32 else "f64"
    return getattr(_build.load("d3q19_kstep"), f"{name}_{suffix}")


def _launch(f, mask_u8, out, scratch, partials, tot, scalars):
    global launches
    launches += 1
    rc = entry(f, "d3q19_kstep")(f.data_ptr(), mask_u8.data_ptr(), out.data_ptr(),
                                 0 if scratch is None else scratch.data_ptr(),
                                 partials.data_ptr(), tot.data_ptr(), *scalars)
    check_rc(rc, "d3q19_kstep")


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
):
    """K timesteps in one pass (kernel B6 on CUDA, `stepk_plain` on the CPU).
    Returns (f_after_K_steps, tot_u per step (K,)); f is unchanged."""
    kw = dict(k_steps=k_steps, omega=omega, density=density, accel=accel,
              accel_plane=accel_plane, plane_offset=plane_offset, valid_planes=valid_planes,
              valid_rows=valid_rows, global_nz=global_nz)
    if f.device.type == "cpu":
        return stepk_plain(f, mask, **kw)
    mask_u8 = obstacle_u8(mask)
    nblocks, scalars = kernel_args(f, mask_u8, block=block, **kw)
    out = torch.empty_like(f)
    scratch = torch.empty_like(f) if k_steps > 1 else None
    partials = torch.empty(k_steps * nblocks, dtype=f.dtype, device=f.device)
    tot = torch.empty(k_steps, dtype=f.dtype, device=f.device)
    _launch(f, mask_u8, out, scratch, partials, tot, scalars)
    return out, tot


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
):
    """`num_steps` timesteps, `k_steps` per pass, between two lattices beside
    the caller's. Returns (f_final, tot_u (num_steps,)); f is unchanged."""
    if num_steps % k_steps:
        raise ValueError(f"num_steps {num_steps} not a multiple of k_steps {k_steps}")
    kw = dict(omega=omega, density=density, accel=accel, accel_plane=accel_plane)
    tots = torch.empty(num_steps, dtype=f.dtype, device=f.device)
    if f.device.type == "cpu":
        for i in range(num_steps // k_steps):
            f, tots[i * k_steps:(i + 1) * k_steps] = stepk_plain(f, mask, k_steps=k_steps, **kw)
        return f, tots
    mask_u8 = obstacle_u8(mask)
    nblocks, scalars = kernel_args(f, mask_u8, k_steps=k_steps, block=block, **kw)
    cur, other = f, None
    partials = torch.empty(k_steps * nblocks, dtype=f.dtype, device=f.device)
    for i in range(num_steps // k_steps):
        # Step j of a pass writes `out` when K - j is even and `scratch`
        # otherwise, and only the first step reads the pass's input. So after
        # the first pass, which must leave the caller's f alone, two lattices
        # do: an even K ends where it began, an odd K in the other one.
        if i == 0:
            out, scratch = torch.empty_like(f), torch.empty_like(f)
        elif k_steps % 2 == 0:
            out, scratch = cur, other
        else:
            out, scratch = other, cur
        _launch(cur, mask_u8, out, scratch if k_steps > 1 else None, partials,
                tots[i * k_steps:(i + 1) * k_steps], scalars)
        cur, other = out, scratch
    return cur, tots
