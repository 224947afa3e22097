"""K D3Q19 steps per pass: the wrapper of CUDA kernel B6 (two-stream).

The counterpart of the z-slab part of `lbm_tpu.ops.d3q19_pallas` (kernel
`_kernel`, `stepk`, `run`, `choose_config`). One call of a C entry point of
`csrc/d3q19_kstep.cu` advances the whole lattice K steps, in -> out, and
returns the per-step Sum|u| over the valid window. See the note at the top of
the source for the design and its bound on the card.

Contract of `stepk` (shared with `d3q19_kstep_inplace.stepk`):
  * f is (19, nz, ny, nx) float32, float64 or bfloat16 and contiguous; mask
    is the (nz, ny, nx) obstacle mask (bool or uint8, nonzero = blocked);
  * a bfloat16 state is storage only, as in the TPU kernels: a pass steps in
    float32 and rounds once, at its end (through a float32 scratch lattice
    for K > 1); Sum|u| is float32. It runs on the step path, full mode;
  * plane_offset / valid_planes / valid_rows / global_nz describe a
    ghost-extended block as in `lbm_tpu.ops.d3q19_pallas.stepk`: local plane
    p is global plane p + plane_offset, the accelerated plane is tested as
    (p + plane_offset) mod global_nz == accel_plane, and only cells inside
    planes [valid_planes) x rows [valid_rows) count towards Sum|u|;
  * any grid shape is taken (edge blocks are masked), and k_steps lies in
    1..MAX_K;
  * on a CUDA tensor the kernel is launched, or the call raises; on a CPU
    tensor the plain version `stepk_plain` runs. There is no other route.

A pass runs on one of two paths (`PATHS`), which `choose_path` picks from
the shape, K and type, and never on a failure: "wave", one launch of
`wave_kernel` a pass, a z-wavefront whose middle steps stay in L2 (the plan
of its work items is `WavePlan`), or "step", one launch a step. The launch
reports the path in `last_path`; `path=` forces one, and a forced path that
cannot take the call raises. B6's
diagnostic modes (`MODES`, those of the TPU kernel) run on the wave path:
`stepk(mode=...)` and `stepk_plain(mode=...)`.

B6 takes the layouts of the TPU kernel (`LAYOUTS`): `stepk(layout=
"zmajor")` takes and returns (nz, 19, ny, nx), the same lattice with other
strides, which the kernel steps in place of the q-major (19, nz, ny, nx);
"fused" is the TPU kernel's rank-3 (19, nz * ny, nx) view of the q-major
array at the HBM boundary, the same bytes, so it takes and returns the
q-major state and launches as "qmajor". `run(layout=)` takes the q-major
state and transposes it once at entry and once at exit. The mask is (nz, ny,
nx) in every layout, and a pass in any layout is bit-equal to a q-major one.
B4 and the blocked kernels take q-major only.

`stepk_plain` is the plain PyTorch version: K steps of `d3q19` on the whole
periodic array (a bfloat16 state upcast for the pass, rounded at its end; a
z-major state transposed to q-major and back).
It agrees with the CUDA kernels on every cell for every
window, since both take each step on planes [0, nz) only. The TPU kernels
also step their K-plane halo and test those planes at their unwrapped index,
so they agree with both whenever global_nz == nz, or the accelerated plane
lies more than K planes from the array's first and last plane (in the
sharded use those planes are ghosts outside the valid window).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import profiling
from . import d3q19
from .d2q9_kstep import (DTYPES, TYPE_SUFFIX, check_rc, compute_dtype, obstacle_bool,
                         obstacle_u8, sums)
from .d3q19_lattice import W

# Launches of kernel B6 (one per K-step pass); callers may reset it.
launches = 0
# The path of the last launch of B6 ("wave" or "step").
last_path = None

MAX_K = 4
# B6's diagnostic modes, those of `lbm_tpu.ops.d3q19_pallas._kernel`, by
# index in the C entry points: "full" (the production step), "stream_only"
# (K periodic pull-streams without bounce-back or collision; Sum|u| the
# window sum of the rest-speed plane, `u = state[0]` in the TPU kernel),
# "copy" (out = in; Sum|u| zeros, where the TPU kernel adds a token) and
# "collide_no_roll" (the pull along z only, no shift in y or x, then the
# collision).
MODES = ("full", "stream_only", "copy", "collide_no_roll")
PATHS = ("step", "wave")
# B6's lattice layouts, those of `lbm_tpu.ops.d3q19_pallas.stepk`
LAYOUTS = ("qmajor", "zmajor", "fused")
# Threads per block along (x, y, z), in order of preference: the first whose
# x extent is not wider than the grid (rounded up to a warp). Measured at
# 64x128x256 float32 on an H100 (experiments/cuda-kstep-tiles/results3d.csv):
# the nine shapes tried lie within 3% of each other for B6 and 10% for B4,
# and the longest x extent is the fastest (256x1x1: B6 0.2406, B4 0.2411 ms
# per 2-step pass; 32x8x1: 0.2472, 0.2658).
BLOCK_CANDIDATES = ((256, 1, 1), (128, 2, 1), (64, 4, 1), (32, 8, 1))
MAX_THREADS_PER_BLOCK = 256
# The wave path's plan (`WavePlan`): step-path blocks an item, and the planes
# a stage trails the one before, `wave_lag`. Measured at 64x128x256 and
# 32x256x256 float32 on an H100 over chunks 1, 2, 4 and lags 3-8
# (experiments/cuda-kstep-tiles/results_wave3d_sweep2.csv): one-block items
# pay for their tickets and waits, four-block ones need a longer lag; the
# best lag at two blocks an item was wave_lag's at every K.
WAVE_CHUNK = 2
# A hook for the probes of experiments/cuda-kstep-tiles/wave3d.py, empty in
# use: "chunk", "lag" and "blocks" of every wave launch's plan in place of
# WAVE_CHUNK, `wave_lag` and the card's resident blocks.
_plan_override: dict = {}
# ms a pass of B6 and B4 on each path by K = 1..4, float32 and float64, at
# 32x256x256 (the grid of d3q19_kstep_blocked.MS_PER_PASS), measured on an
# NVIDIA H100 80GB HBM3 (700 W) by experiments/cuda-kstep-tiles/
# sweep3d_blocked.py --slab (results3d_slab.csv, the median of 5 timings):
# `choose_path` takes the faster where the shape allows both. The wave path
# loses at K = 1 (one stage, no step held in L2; B4 pays its swap as a
# second stage) and B4's at K = 3 (its swap stage).
PATH_MS = {
    torch.float32: {"b6": {"step": (0.1207, 0.2362, 0.3523, 0.4682),
                           "wave": (0.1269, 0.2015, 0.3086, 0.4051)},
                    "b4": {"step": (0.2985, 0.2362, 0.5300, 0.4679),
                           "wave": (0.3081, 0.1997, 0.5512, 0.4031)}},
    torch.float64: {"b6": {"step": (0.2248, 0.4436, 0.6631, 0.8818),
                           "wave": (0.2352, 0.4202, 0.6136, 0.8447)},
                    "b4": {"step": (0.4871, 0.4487, 0.9307, 0.8916),
                           "wave": (0.6360, 0.4216, 1.1150, 0.8499)}},
}


def choose_block(nx: int) -> tuple[int, int, int]:
    """(bx, by, bz) threads per block for a grid nx cells wide."""
    width = -(-nx // 32) * 32
    for block in BLOCK_CANDIDATES:
        if block[0] <= width:
            return block
    return BLOCK_CANDIDATES[-1]


def check_mode(mode: str) -> int:
    """The index of `mode` in MODES, which the C entry points take."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return MODES.index(mode)


def qmajor_view(f: torch.Tensor, layout: str = "qmajor") -> torch.Tensor:
    """f in `layout` as a (19, nz, ny, nx) view of the same storage (not
    contiguous for z-major). Raises on an unknown layout, or a state of
    another rank or shape than the layout's."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    axis = 1 if layout == "zmajor" else 0
    if f.dim() != 4 or f.shape[axis] != 19:
        want = "(nz, 19, ny, nx)" if layout == "zmajor" else "(19, nz, ny, nx)"
        raise ValueError(f"layout {layout!r} takes a state of shape {want}, got "
                         f"{tuple(f.shape)}")
    return f.transpose(0, 1) if layout == "zmajor" else f


def wave_fits(nz: int, block: tuple[int, int, int]) -> bool:
    """Whether the wave path takes the shape (mirrors make_plan in
    csrc/d3q19_kstep.cu): a block one plane deep, so that a step-path block
    lies in one plane, and three planes or more, so that a plane's
    neighbours z - 1 and z + 1 are planes of their own."""
    return block[2] == 1 and nz >= 3


def pass_ms(dtype, kernel: str) -> tuple:
    """ms a pass of `kernel` ("b6" or "b4") at K = 1..4 on the path
    `choose_path` gives a shape both paths take (PATH_MS)."""
    ms = PATH_MS[dtype][kernel]
    return tuple(min(w, s) for w, s in zip(ms["wave"], ms["step"]))


# Steps per pass that `choose_k` prefers: the K at which a pass of B4, the
# production engine, costs the least a step in float32 at the two 3-D bench
# grids, K = 4. At 64x128x256 it is 4.4% cheaper than K = 2 (0.09508
# against 0.09945 ms a step; medians of 10 timings of `ab3d.py`,
# experiments/cuda-kstep-tiles/results_ab3d_fix.csv; 3.8% in
# results_wave3d_sweep3.csv). At 32x256x256 the two tie within 1% either
# way (0.10163 against 0.10240 there, 0.10078 against 0.09985 in PATH_MS).
PREFERRED_K = 4


def choose_k(*step_counts: int, admit=None) -> int:
    """Steps per pass for a run: PREFERRED_K where it divides every one of
    `step_counts` (the total, and the chunk of a checkpointed run); else, of
    the K that do, the one at which a pass of B4 costs the least a step in
    float32 (`pass_ms`). So 6 steps run at K = 2, not at K = 3, where B4
    pays its swap. `admit(k)`, where given, must also hold of the K (the
    sharded runs' plan of planes); 1 when no K is admitted."""
    ks = [k for k in range(1, MAX_K + 1)
          if all(n % k == 0 for n in step_counts) and (admit is None or admit(k))]
    if not ks:
        return 1
    if PREFERRED_K in ks:
        return PREFERRED_K
    ms = pass_ms(torch.float32, "b4")
    return min(ks, key=lambda k: ms[k - 1] / k)


def wave_lag(blocks: int, stages: int, chunks: int) -> int:
    """The lag at which an item's waits are on items taken a whole launch's
    blocks of tickets earlier, which have most likely finished: a round
    holds `stages` x `chunks` items, and an item of stage s waits on stage
    s - 1 up to two positions ahead of its own, so lag - 2 rounds must hold
    the blocks' items in flight."""
    return 2 + -(-blocks // (stages * chunks))


def choose_path(nz: int, ny: int, nx: int, k_steps: int, dtype=torch.float32, *,
                kernel: str = "b6", block: tuple | None = None, mode: str = "full") -> str:
    """"wave" or "step" for a pass of `kernel` ("b6" or "b4"): "step" where
    the wave path does not take the shape (`wave_fits`); else a diagnostic
    mode goes to "wave" (it has them), and "full" to the path that measured
    faster at this K and type (PATH_MS). A bfloat16 pass takes "step": the
    wave path keeps a pass's middle steps in the lattice's own slots."""
    if dtype == torch.bfloat16 or not wave_fits(nz, block or choose_block(nx)):
        return "step"
    if mode != "full":
        return "wave"
    ms = PATH_MS[dtype][kernel]
    return "wave" if ms["wave"][k_steps - 1] <= ms["step"][k_steps - 1] else "step"


def resolve_path(path: str | None, f: torch.Tensor, k_steps: int, *, kernel: str = "b6",
                 block: tuple | None = None, mode: str = "full") -> str:
    """The path of a pass on f: choose_path's, or the one asked for. Asking
    for "wave" where the shape does not fit it, or for "step" in a
    diagnostic mode, raises."""
    _, nz, ny, nx = f.shape
    block = tuple(block or choose_block(nx))
    if path is None:
        return choose_path(nz, ny, nx, k_steps, f.dtype, kernel=kernel, block=block, mode=mode)
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if path == "wave" and not wave_fits(nz, block):
        raise ValueError(f"the wave path does not take block {block} on {nz} planes "
                         "(it needs a block one plane deep and at least 3 planes)")
    if path == "wave" and f.dtype == torch.bfloat16:
        raise ValueError("the wave path takes float32 and float64; bfloat16 runs on 'step'")
    if path == "step" and mode != "full":
        raise ValueError(f"mode={mode!r} runs on the wave path only")
    return path


@dataclasses.dataclass(frozen=True)
class WavePlan:
    """The work items of a wave launch and their order (mirrors make_plan,
    stage_kind, decode and the waits of wave_kernel in csrc/d3q19_kstep.cu).

    An item is (stage s, position i, chunk c), 0-based: stage s steps plane
    `plane(s, i)` = (i + s) mod nz, the chunk-th run of `chunk` step-path
    blocks of that plane. Tickets run in rounds: round r holds stage s at
    position r - s * lag for each stage whose position lies in [0, nz), in
    stage order, each `chunks` items. A pass of K steps has K stages, and B4
    after an odd K one more, the swap (`swap`); B6 after an odd K takes a
    two-stream step first (`two_stream`). The other stages take the AA
    pattern's steps A and B in turn (`kind`)."""

    nz: int
    k: int
    chunk: int
    chunks: int
    lag: int
    blocks: int  # the launch's blocks
    inplace: bool  # B4 (else B6)

    @classmethod
    def of(cls, nz: int, ny: int, nx: int, k_steps: int, *, inplace: bool, blocks: int,
           block: tuple | None = None, chunk: int | None = None, lag: int | None = None):
        """The plan of a pass of B4 (`inplace`) or B6 on `blocks` blocks;
        `chunk` and `lag` default to WAVE_CHUNK and `wave_lag`."""
        bx, by, bz = block or choose_block(nx)
        if not wave_fits(nz, (bx, by, bz)):
            raise ValueError(f"the wave path does not take block {(bx, by, bz)} on {nz} planes")
        chunk = chunk or WAVE_CHUNK
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        stages = k_steps + (k_steps % 2 if inplace else 0)
        chunks = -(-(-(-nx // bx) * -(-ny // by)) // chunk)
        blocks = min(blocks, stages * nz * chunks)
        lag = lag or wave_lag(blocks, stages, chunks)
        if lag < 2:
            raise ValueError(f"lag must be >= 2, got {lag}")
        return cls(nz=nz, k=k_steps, chunk=chunk, chunks=chunks, lag=lag, blocks=blocks,
                   inplace=inplace)

    @property
    def swap(self) -> bool:
        return self.inplace and self.k % 2 == 1

    @property
    def two_stream(self) -> bool:
        return not self.inplace and self.k % 2 == 1

    @property
    def stages(self) -> int:
        return self.k + self.swap

    @property
    def rounds(self) -> int:
        return self.nz + (self.stages - 1) * self.lag

    @property
    def items(self) -> int:
        return self.stages * self.nz * self.chunks

    def tickets_before(self, r: int) -> int:
        return self.chunks * sum(min(max(r - s * self.lag, 0), self.nz)
                                 for s in range(self.stages))

    def item(self, t: int) -> tuple[int, int, int]:
        """(stage, position, chunk) of ticket t."""
        lo, hi = 0, self.rounds
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if self.tickets_before(mid) <= t:
                lo = mid
            else:
                hi = mid
        off = t - self.tickets_before(lo)
        first = (lo - self.nz) // self.lag + 1 if lo >= self.nz else 0
        s = first + off // self.chunks
        return s, lo - s * self.lag, off % self.chunks

    def kind(self, s: int) -> str:
        """"two-stream", "A", "B" or "swap": the step stage s takes."""
        if self.swap and s == self.stages - 1:
            return "swap"
        if self.two_stream and s == 0:
            return "two-stream"
        return "A" if (s - self.two_stream) % 2 == 0 else "B"

    def plane(self, s: int, i: int) -> int:
        return (i + s) % self.nz

    def position(self, s: int, z: int) -> int:
        return (z - s) % self.nz

    def waits(self, s: int, i: int) -> list[tuple[int, int]]:
        """The (stage, plane) counters an item of stage s at position i
        waits on: the previous stage at planes z - 1, z, z + 1."""
        z = self.plane(s, i)
        return [(s - 1, (z + d) % self.nz) for d in (-1, 0, 1)] if s > 0 else []


def coefficients(omega: float, density: float, accel: float) -> list[float]:
    """The six scalars of the collision as `d3q19.collide_fields` forms them,
    in double: 1 - omega, (W * omega) of the rest, axis and edge speeds, and
    the force density * accel * W of the axis and edge speeds."""
    return [1.0 - omega, float(W[0]) * omega, float(W[1]) * omega, float(W[7]) * omega,
            density * accel * float(W[1]), density * accel * float(W[7])]


def pull_z(f: torch.Tensor) -> list[torch.Tensor]:
    """collide_no_roll's pull: speed q at (z, y, x) from (z - dz_q, y, x)."""
    return [torch.roll(f[q], int(d3q19.E[q, 0]), dims=-3) if d3q19.E[q, 0] else f[q]
            for q in range(d3q19.NUM_SPEEDS)]


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
    mode: str = "full",
    layout: str = "qmajor",
):
    """The plain PyTorch version of the K-step kernels: K steps of
    `d3q19.collide_fields` on `d3q19.stream_pull`, with per-step Sum|u| over
    the valid window only, in one of MODES: "stream_only", K pull-streams
    without bounce-back or collision, Sum|u| the window sum of the
    rest-speed plane; "copy", f itself and a Sum|u| of zeros;
    "collide_no_roll", the collision on the pull along z alone. A bfloat16
    state steps in float32 and is rounded once, at the end, with a float32
    Sum|u|, as the kernels do. A z-major state (`layout`) is stepped as its
    q-major transpose and transposed back. Returns (f_after_K, tot (K,))."""
    check_mode(mode)
    q = qmajor_view(f, layout)
    if layout == "zmajor":
        f_new, tot = stepk_plain(q, mask, k_steps=k_steps, omega=omega, density=density,
                                 accel=accel, accel_plane=accel_plane, plane_offset=plane_offset,
                                 valid_planes=valid_planes, valid_rows=valid_rows,
                                 global_nz=global_nz, mode=mode)
        return f_new.transpose(0, 1).contiguous(), tot
    if mode == "copy":
        return f.clone(), torch.zeros(k_steps, dtype=compute_dtype(f.dtype), device=f.device)
    if f.dtype == torch.bfloat16:
        f_new, tot = stepk_plain(
            f.float(), mask, k_steps=k_steps, omega=omega, density=density, accel=accel,
            accel_plane=accel_plane, plane_offset=plane_offset, valid_planes=valid_planes,
            valid_rows=valid_rows, global_nz=global_nz, mode=mode)
        return f_new.to(torch.bfloat16), tot
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
    pull = pull_z if mode == "collide_no_roll" else d3q19.stream_pull
    tots = []
    for _ in range(k_steps):
        if mode == "stream_only":
            f = torch.stack(d3q19.stream_pull(f))
            u = f[0]
        else:
            f, u = d3q19.collide_fields(pull(f), obstacle, amask, omega=omega,
                                        density=density, accel=accel)
        tots.append(torch.where(window, u, zero).sum())
    return f, torch.stack(tots)


def check_state(f: torch.Tensor, mask_u8: torch.Tensor, k_steps: int,
                layout: str = "qmajor") -> None:
    """Raises on a state, mask or K that the 3-D CUDA kernels do not take (B6
    takes every layout of LAYOUTS, the others q-major)."""
    if f.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on {f.device}")
    q = qmajor_view(f, layout)
    if f.dtype not in DTYPES:
        raise ValueError(f"the kernel takes float32, float64 or bfloat16, got {f.dtype}")
    if not f.is_contiguous():
        raise ValueError("state must be contiguous")
    _, nz, ny, nx = q.shape
    if mask_u8.shape != (nz, ny, nx) or mask_u8.device != f.device or mask_u8.dtype != torch.uint8:
        raise ValueError(f"mask must be ({nz}, {ny}, {nx}) uint8 on {f.device}")
    if not 1 <= k_steps <= MAX_K:
        raise ValueError(f"k_steps must be in 1..{MAX_K}, got {k_steps}")


def window_scalars(f: torch.Tensor, *, omega: float, density: float, accel: float,
                   accel_plane: int, plane_offset: int = 0, valid_planes: tuple | None = None,
                   valid_rows: tuple | None = None, global_nz: int | None = None) -> list:
    """The trailing arguments of every 3-D C entry point: the window, the
    accelerated plane, the six collision coefficients, omega (the per-speed
    grouping's) and the stream."""
    _, nz, ny, _ = f.shape
    valid_planes = valid_planes or (0, nz)
    valid_rows = valid_rows or (0, ny)
    return [int(plane_offset), int(valid_planes[0]), int(valid_planes[1]),
            int(global_nz or nz), int(valid_rows[0]), int(valid_rows[1]), int(accel_plane),
            *coefficients(omega, density, accel), float(omega),
            torch.cuda.current_stream(f.device).cuda_stream]


def kernel_args(f: torch.Tensor, mask_u8: torch.Tensor, *, k_steps: int,
                block: tuple | None = None, layout: str = "qmajor", **window):
    """Checks a CUDA call of either kernel and returns (block, nblocks: the
    step path's blocks, the trailing scalar arguments of its C entry
    points). `layout` as in `stepk` (B6)."""
    check_state(f, mask_u8, k_steps, layout)
    f = qmajor_view(f, layout)
    _, nz, ny, nx = f.shape
    bx, by, bz = block or choose_block(nx)
    threads = bx * by * bz
    if min(bx, by, bz) < 1 or threads > MAX_THREADS_PER_BLOCK or threads % 32:
        raise ValueError(f"block {(bx, by, bz)} must hold a multiple of 32 threads, at most "
                         f"{MAX_THREADS_PER_BLOCK}")
    nblocks = -(-nx // bx) * -(-ny // by) * -(-nz // bz)
    return ((bx, by, bz), nblocks,
            [nz, ny, nx, bx, by, bz, int(k_steps), *window_scalars(f, **window)])


def entry(f: torch.Tensor, name: str, source: str = "d3q19_kstep"):
    """The C entry `name` for f's type, from the library of `source` built
    for d3q19.GROUPING (`d3q19.kernel_variant`)."""
    from . import _build

    return getattr(_build.load(source, d3q19.kernel_variant()), f"{name}_{TYPE_SUFFIX[f.dtype]}")


def rounding_scratch(f: torch.Tensor, k_steps: int):
    """The float32 lattice a bfloat16 pass of K > 1 steps through, else None."""
    if f.dtype != torch.bfloat16 or k_steps == 1:
        return None
    return torch.empty(f.shape, dtype=torch.float32, device=f.device)


# ------------------------------------------------------------- the wave path

# the wave path's words by (device, stream, nz): zero between launches
_WAVE_WORDS: dict = {}
# resident blocks an SM of wave_kernel by (device, index in MODES, type, threads)
_BLOCKS_PER_SM: dict = {}


def wave_blocks(f: torch.Tensor, mode: int, threads: int) -> int:
    """Blocks a wave launch in MODES[mode] takes: as many as the card keeps
    resident."""
    from . import _build

    key = (f.device.index, mode, f.dtype, threads)
    if key not in _BLOCKS_PER_SM:
        n = _build.load("d3q19_kstep", d3q19.kernel_variant()).d3q19_wave_blocks(
            mode, int(f.dtype == torch.float64), threads)
        if n < 1:
            raise RuntimeError(f"d3q19_wave_blocks: CUDA error {-n}")
        _BLOCKS_PER_SM[key] = n
    return _BLOCKS_PER_SM[key] * torch.cuda.get_device_properties(f.device).multi_processor_count


def wave_words(f: torch.Tensor, nz: int) -> torch.Tensor:
    """The words a wave launch on f's current stream counts with: a counter
    a (stage, plane), the ticket and the exit word. Each launch starts and
    leaves them at zero (csrc/d3q19_kstep.cu), so launches on one stream,
    which run in turn, share them, and a captured launch may be replayed;
    another stream gets its own."""
    key = (str(f.device), torch.cuda.current_stream(f.device).cuda_stream, nz)
    if key not in _WAVE_WORDS:
        _WAVE_WORDS[key] = torch.zeros(MAX_K * nz + 2, dtype=torch.int32, device=f.device)
    return _WAVE_WORDS[key]


def wave_launch(f: torch.Tensor, out: torch.Tensor, mask_u8, partials, tot, plan: WavePlan, *,
                mode: str, scalars, what: str, zmajor: bool = False) -> None:
    """One pass on the wave path, f -> out: B4 where `plan` is in place (f is
    out), else B6 in `mode` (on z-major lattices with `zmajor`)."""
    words = wave_words(f, plan.nz)
    rc = entry(f, "d3q19_wave")(
        f.data_ptr(), mask_u8.data_ptr(), out.data_ptr(), partials.data_ptr(), tot.data_ptr(),
        words.data_ptr(), check_mode(mode), int(plan.inplace), int(zmajor), plan.blocks,
        plan.chunk, plan.lag, *scalars)
    check_rc(rc, what)


def wave_plan(f: torch.Tensor, k_steps: int, *, inplace: bool, mode: str, block) -> WavePlan:
    """The plan of a pass on f of B4 (`inplace`) or B6 in `mode`, on as many
    blocks as the card keeps resident (or those of `_plan_override`)."""
    _, nz, ny, nx = f.shape
    blocks = (_plan_override.get("blocks")
              or wave_blocks(f, check_mode(mode), block[0] * block[1]))
    return WavePlan.of(nz, ny, nx, k_steps, inplace=inplace, block=block, blocks=blocks,
                       chunk=_plan_override.get("chunk"), lag=_plan_override.get("lag"))


def _launch(f, mask_u8, out, partials, tot, *, path, mode, scalars, layout, plan=None,
            scratch=None):
    """One pass of B6 on `path` in `layout`: the step path's scratch is a
    second lattice (null for K = 1; float32 for a bfloat16 state); the wave
    path needs none."""
    global launches, last_path
    launches += 1
    last_path = path
    zmajor = layout == "zmajor"
    if path == "step":
        rc = entry(f, "d3q19_kstep")(f.data_ptr(), mask_u8.data_ptr(), out.data_ptr(),
                                     0 if scratch is None else scratch.data_ptr(),
                                     partials.data_ptr(), tot.data_ptr(), int(zmajor), *scalars)
        check_rc(rc, "d3q19_kstep")
        return
    wave_launch(f, out, mask_u8, partials, tot, plan, mode=mode, scalars=scalars,
                what="d3q19_wave", zmajor=zmajor)


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
    mode: str = "full",
    path: str | None = None,
    layout: str = "qmajor",
):
    """K timesteps in one pass (kernel B6 on CUDA, `stepk_plain` on the CPU)
    in `mode`. Returns (f_after_K_steps, tot_u per step (K,)); f is
    unchanged. `path` as in `resolve_path`; `layout` one of LAYOUTS (f and
    the result (nz, 19, ny, nx) for "zmajor", else (19, nz, ny, nx))."""
    check_mode(mode)
    kw = dict(k_steps=k_steps, omega=omega, density=density, accel=accel,
              accel_plane=accel_plane, plane_offset=plane_offset, valid_planes=valid_planes,
              valid_rows=valid_rows, global_nz=global_nz)
    if f.device.type == "cpu":
        return stepk_plain(f, mask, mode=mode, layout=layout, **kw)
    mask_u8 = obstacle_u8(mask)
    block, nblocks, scalars = kernel_args(f, mask_u8, block=block, layout=layout, **kw)
    q = qmajor_view(f, layout)
    path = resolve_path(path, q, k_steps, block=block, mode=mode)
    out = torch.empty_like(f)
    partials, tot = sums(f, k_steps * nblocks), sums(f, k_steps)
    if path == "step":
        scratch = (rounding_scratch(f, k_steps) if f.dtype == torch.bfloat16
                   else torch.empty_like(f) if k_steps > 1 else None)
        _launch(f, mask_u8, out, partials, tot, path=path, mode=mode, scalars=scalars,
                layout=layout, scratch=scratch)
    else:
        plan = wave_plan(q, k_steps, inplace=False, mode=mode, block=block)
        _launch(f, mask_u8, out, partials, tot, path=path, mode=mode, scalars=scalars,
                layout=layout, plan=plan)
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
    mode: str = "full",
    path: str | None = None,
    layout: str = "qmajor",
):
    """`num_steps` timesteps, `k_steps` per pass, in `mode`. Returns
    (f_final, tot_u (num_steps,)); f is unchanged. On the wave path an even
    K holds one lattice beside the caller's (a pass after the first writes
    its own input, as B4 does); an odd K, and the step path, two. `path` as
    in `stepk`. f and f_final are q-major in every `layout`; "zmajor"
    transposes f once at entry and the result once at exit, and the passes
    between run on the z-major lattice."""
    check_mode(mode)
    qmajor_view(f)
    layout = pass_layout(layout)
    if num_steps % k_steps:
        raise ValueError(f"num_steps {num_steps} not a multiple of k_steps {k_steps}")
    zmajor = layout == "zmajor"
    f_final, tots = _run(f.transpose(0, 1).contiguous() if zmajor else f, mask,
                         num_steps=num_steps, k_steps=k_steps, block=block, mode=mode, path=path,
                         layout=layout, omega=omega, density=density, accel=accel,
                         accel_plane=accel_plane)
    return (f_final.transpose(0, 1).contiguous() if zmajor else f_final), tots


def pass_layout(layout: str) -> str:
    """The layout a pass runs in: "fused" is the q-major lattice's bytes."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    return "qmajor" if layout == "fused" else layout


def _run(f, mask, *, num_steps, k_steps, block, mode, path, layout, **kw):
    """`run`'s passes on f in `layout` ("qmajor" or "zmajor")."""
    tots = sums(f, num_steps)
    if f.device.type == "cpu":
        for i in profiling.passes(num_steps // k_steps, "B6", "plain", k_steps):
            f, tots[i * k_steps:(i + 1) * k_steps] = stepk_plain(f, mask, k_steps=k_steps,
                                                                mode=mode, layout=layout, **kw)
        return f, tots
    mask_u8 = obstacle_u8(mask)
    block, nblocks, scalars = kernel_args(f, mask_u8, k_steps=k_steps, block=block,
                                          layout=layout, **kw)
    q = qmajor_view(f, layout)
    path = resolve_path(path, q, k_steps, block=block, mode=mode)
    partials = sums(f, k_steps * nblocks)
    common = dict(path=path, mode=mode, scalars=scalars, layout=layout)
    if f.dtype == torch.bfloat16:
        # the step path through one float32 lattice: for K > 1 only a pass's
        # first step reads its input and only its last writes its output, so
        # the passes after the first step in place; K = 1 alternates two
        scratch = rounding_scratch(f, k_steps)
        cur, spare = f, None  # K = 1: the lattice the next pass may write
        for i in profiling.passes(num_steps // k_steps, "B6", path, k_steps):
            if k_steps > 1:
                out = torch.empty_like(f) if i == 0 else cur
            else:
                out = spare if spare is not None else torch.empty_like(f)
                spare = cur if cur is not f else None
            _launch(cur, mask_u8, out, partials, tots[i * k_steps:(i + 1) * k_steps],
                    scratch=scratch, **common)
            cur = out
        return cur, tots
    if path == "wave":
        plan = wave_plan(q, k_steps, inplace=False, mode=mode, block=block)
        out = torch.empty_like(f)
        other = torch.empty_like(f) if k_steps % 2 else None
        cur = f
        for i in profiling.passes(num_steps // k_steps, "B6", path, k_steps):
            # an even K: the first pass leaves the caller's f alone, the
            # later ones write their own input; an odd K, whose first stage
            # reads its input after others have written out, alternates two
            _launch(cur, mask_u8, out, partials, tots[i * k_steps:(i + 1) * k_steps],
                    plan=plan, **common)
            cur = out
            if other is not None:
                out, other = other, out
        return cur, tots
    cur, other = f, None
    for i in profiling.passes(num_steps // k_steps, "B6", path, k_steps):
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
        _launch(cur, mask_u8, out, partials, tots[i * k_steps:(i + 1) * k_steps],
                scratch=scratch if k_steps > 1 else None, **common)
        cur, other = out, scratch
    return cur, tots
