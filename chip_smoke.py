#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (lbm_tpu_torch) runs on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. prints the card's name and power limit; builds the CUDA kernels from
     the eight sources of lbm_tpu_torch/csrc/ with nvcc (one process per
     source, all started together) and prints the build time; prints what
     `nvcc -Xptxas -v` says of the four sources on TMA (B12 and B11, on
     csrc/tile_copy.cuh, d2q9_kstep.cu and d2q9_manual.cu, whose box paths
     move B1's, B2's and B3's regions by TMA) and the blocks an SM of B1, B2
     and B3 on each path at 16x32, K=4 (three of B1 and B2 and two of B3 in
     float32, or it fails);
  2. D2Q9 kernels vs plain version at 1024x1024: for kernels B2 (d2q9_kstep),
     B1 (d2q9_kstep_inplace) and B3 (d2q9_kstep_manual, the pipelined one),
     at K = 1..8 (at B3's tile), in float64 and float32, plus one case with a
     ghost window (row_offset, valid rows and columns strictly inside,
     global_ny != ny): one stepk with the kernel and one with stepk_plain on
     the card, from a numpy-seeded state. B1 and B3 must be bit-equal to B2,
     also over three passes of `run` (where B1 chains its boundary
     snapshot); each case prints the path B1, B2 and B3 took (box, with the
     tiles whose regions the threads patch, or thread: K = 1..3 in float32),
     and B3 must have run on both paths in each type; the same on
     three grids whose width is not a multiple of 32 (narrower tiles) and on
     64x1001 and 72x130, which no tile divides (edge tiles). The diagnostic
     modes: stream_only of B1, B2 and B3 bit-equal to the plain version's
     state, copy and B12 (copy_floor) equal to their input; both paths of
     B12 (TMA, one value a piece) in float32 and float64 bit-equal to
     `run_copy_plain`, with edge tiles, widths TMA cannot take (1001, 33)
     and a state off 16 bytes (experiments/cuda-kstep-tiles/ab_copy.py). Timing of B1, B2, B3 (and its persistent grid), B12 (its
     device ms and its host's enqueue µs a pass) and `copy_`;
  3. the 2-D main path: the flagship run (1024x1024, 20,000 steps, float32)
     through `lbm_tpu_torch.cli.lbm --engine auto`, which must pick the
     engine `d2q9_kstep.choose_engine` names for the card's free memory
     (cuda, B2), launch that kernel alone on the box path and never call the
     plain engine; then the same run with `--engine cuda-inplace` (B1),
     `--engine cuda` (B2) and `--engine cuda-manual` (B3), each on the box
     path. Each
     final_state.dat is held to check/1024x1024.final_state.dat.gz by the
     checker's per-cell rule (verify/check.py: column 5, 1%), and the first
     100 av_vels to a 100-step run of the plain engine on the card (4e-4).
     Then the JAX bench's 4096^2 x 2,000-step case through B3, B2 and B1
     (MLUPS; 96-step gate against the plain engine; the three bit-equal); a
     64x1001 grid through run_simulation with `auto`, `cuda`, `cuda-inplace`
     and `cuda-manual` against the plain engine (float32 4e-4, float64
     1e-10); and the 2-D time-breakdown path at 1024^2 (the modes of B2, B3
     and B1 through experiments/cuda-kstep-tiles/breakdown2d.py, B12 and
     `copy_` through copy_floor2d.py), each kernel launched there;
  4. D3Q19 kernels vs plain version at 64x128x256: B6 (d3q19_kstep) and B4
     (d3q19_kstep_inplace) at K=1, at choose_k's K and at K=3 (B4's swap),
     float64 and float32, plus a ghost window (plane_offset, valid planes
     and rows strictly inside, global_nz != nz). B4 must be bit-equal to B6,
     also over three passes of `run`, must leave its result in the input's
     storage, and a B4 `run` must peak under 1.5 x (lattice + mask) of
     device memory;
  5. the 3-D main path: `lbm_tpu_torch.cli.lbm3d --nz 64 --ny 128 --nx 256
     -n 1200` in float32 with no --engine (must launch B4 and never the
     plain engine) and with `--engine cuda` (B6); av_vels[1:24] against the
     plain engine on the card (4e-4);
  6. golden: 16x64x128 x 6000 steps against
     experiments/d3q19-drift/d3q19_16x64x128_6000.av_vels.dat, float32
     through both engines (max relative error over all steps <= 1.5e-3) and
     float64 through `cuda` (first 200 steps <= 1e-10);
  7. checkpoint/resume on the card, 2-D (1024^2: `--engine cuda-inplace`
     (B1), `cuda-manual` (B3) and `auto`) and 3-D
     (64x128x256, B4): N steps with --checkpoint-every N/2, then 2N with
     --resume; av_vels and the final state must equal an uninterrupted 2N run
     bit for bit;
  7b. the blocked 3-D pair at 32x256x256 (the reference's
     `d3q19_blocked_only` shape), all of it in the phases named *_blocked:
     kernels B7 (d3q19_kstep_blocked) and B5 (d3q19_kstep_inplace_blocked) vs
     `stepk_plain` at K = 1..4, float64 and float32, plus a ghost window and
     a shape no tile divides (13x50x70); B5 bit-equal to B7 (same tile), also
     over three passes of `run`; B7's state against B6's (gated at 0.0); B5's
     result in its input's storage and its `run` under 1.5 x (lattice +
     mask); one launch of the blocked kernel per K steps and none of a
     one-step kernel. Both paths of the two (box: a region by 19 TMA boxes;
     thread: every value loaded by the threads) and B5's
     `stream_only` and `copy` modes, through
     experiments/cuda-kstep-tiles/sweep3d_blocked.py `check_paths`: at
     32x256x256, 12x16x32 (which wraps in every axis) and 13x50x70, K =
     1..4, both types, each kernel on its chosen path bit-equal to the
     thread path, B5 == B7, B7 == B6, the modes' state bit-equal to their
     plain versions (copy's Sum|u| zeros); both paths must run in each type.
     Time per pass of B5 and B7 at K = 1..3 beside B4 and B6, with the path
     each took. The main path `cli.lbm3d --nz 32 --ny 256 --nx 256 -n 1200` with
     `--engine cuda-inplace-blocked` (B5 alone), `--engine cuda-blocked` (B7
     alone) and no --engine (the kind `pick_engine` names), av_vels[1:24]
     against the plain engine (4e-4). Golden 8x256x256 x 6000 against
     experiments/d3q19-drift/d3q19_8x256x256_6000.av_vels.dat (float32 both
     blocked engines <= 1.5e-3; float64 `cuda-blocked`, 200 steps, <= 1e-10).
     Checkpoint/resume through `cuda-inplace-blocked`, bit-equal to an
     uninterrupted run;
  8. blur kernels vs plain version, from numpy-seeded images: B10
     (stencil.blur_step) one pass, B9 (blur_k) at k = 1, 2, 4, 8 and two tile
     heights, B8 (blur_resident) at 8 and 200 passes; float32 (bit-equal) and
     bfloat16 (one unit in the last place); at the bricks shape 4x304x512,
     the leaf shape 4x1032x896 (beyond what B8 holds on an H100: there it
     must raise and name the 'cuda' engine), an image whose ring is not zero,
     and B9/B10 at 4096x4096 (padded 4x4128x4224). The pad ring of every
     output is exactly zero. Eight passes of each engine are held to a
     float64 9-point blur with numpy on the host, at 1e-4 absolute;
  9. the blur main path: a seeded 4096x4096 RGBA image through
     `lbm_tpu_torch.cli.blur -n 100`: `--engine auto` must choose cuda with
     k_passes 4 and launch B9 50 times per run, `--engine cuda` B10 200
     times per run, `--data-type half` through auto B9 again; then a 302x499
     image through `--engine auto`, which must choose resident and launch B8
     once per run; never a plain version. Each float32 output is held to the
     conv engine on the card within one grey level, and the state before
     `to_char_image` to a float64 plain blur on the card (1e-5; bfloat16
     2e-2, and its output within one level of the plain bfloat16 chain). The
     PNG leg runs if PIL imports; if not, the arrays go through
     `models.blur.run_blur` and a line says so;
 10. kernel B11, the overlap probes (ops/overlap_probe.py, through
     experiments/cuda-kstep-tiles/overlap_probe.py): every engine of the
     harness (probe.py's table, and the strided manual engines again in
     (9, 1, 512) tiles) against its plain version bit for bit at 256x256,
     bands 32 and 64, R = 0 and 2 (smem totals too; the manual engines also
     against auto; manual6 must refuse band 64, as probe.py does); every
     `auto` instance on its one-value path (a width of 250, a state off 16
     bytes) too; each strided manual engine on its box path (one TMA box a
     stage, (9, 16, 32) tiles) bit-equal to the bulk path ((9, 1, 512)
     tiles) and its plain version at 256x256, 72x100 (edge tiles) and
     4096^2, R = 0 and 16, with the path of each launch; and at
     4096^2, band 64, R = 16, where each block of a manual engine walks tens
     of tiles through its ring (the smem totals of 64 bands too); then the
     main path, the harness's sweep of every engine at 4096^2, band 64, 200
     calls, R = 0, 16 and 64 (best of 3), and `copy_` at R = 0, each
     instance launched; each case's bound, each engine's arithmetic a round
     (the slope from R = 256 to 512) and overlap fraction, and probe.py's
     own fractions (`analyze`);
 11. kernel B13, the resident-blur variants v0-v7 (ops/blur_resident_opt.py,
     through experiments/cuda-kstep-tiles/blur_resident_opt.py): every
     variant against its plain version bit for bit, in float32 and bfloat16
     I/O, at bricks (4x304x512) and at 3x37x53 (which no tile divides) after
     0, 2, 7, 200 and 202 passes (7 runs 6, as run.py's `_pingpong`), at the
     depth the rule picks (the passes a block runs between two exchanges of
     tile edges) and at depth 1, and at leaf (4x1032x896) after 2 and 200
     where the variant fits, v0 and v1 against B8; two launches in a row on
     the same exchange words with different images (every variant and B8,
     one exchange a launch and 202 passes), each bit-equal to its plain
     version; the variants whose tiles do not fit leaf must refuse it,
     naming the bytes a block would need. Then the main path, the harness's
     sweep of all eight at bricks and leaf in bfloat16 (run.py's per-pass
     cost: median of 5 (t(n_hi) - t(n_lo)) / (n_hi - n_lo), n_lo = 2000),
     every variant launched; v0's launch of 2000 passes beside its plain
     version, 2000 convolutions and its bound; v0's µs a pass at bricks at
     depth 1 (an exchange every pass) beside the rule's depth;
 12. one JSON line `{"kernels": [...]}` with each of the thirteen kernels'
     launches on its path, parity, time per launch, its bound, the plain
     version's time and the library's (the convolution for the blur
     kernels, `copy_` for B12 and B11);
 13. last line: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Exits non-zero, printing no result, when CUDA is absent or the package is not
beside this file. Imports nothing of JAX or of lbm_tpu.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "check" / "1024x1024.final_state.dat.gz"
N = 1024
# the flagship configuration (params/input_1024x1024.params of the original
# study: density 0.1, omega 1.85, accel 0.01 at 1024^2, reynolds_dim 10)
FLAGSHIP = dict(nx=N, ny=N, max_iters=20000, reynolds_dim=10, density=0.1, accel=0.01,
                omega=1.85)
# kernel vs plain version: the kernels round every operation as
# collide_fields does (-fmad=false), but the plain version on CUDA differs by
# about 1e-6 relative in float32 on the state (PyTorch divides by a Python
# scalar as a multiply by its reciprocal); Sum|u| is also reduced in another
# order, ~1e-7 relative in float32 over 1M cells
BARS = {"float64": 1e-12, "float32": 1e-5}
AV_VELS_BAR = 4e-4  # the bench gate on the 100-step prefix (ROADMAP.md)
CHECK_TOLERANCE_PCT = 1.0  # verify/check.py default
# the JAX bench's second 2-D size (bench.py d2q9_4096_only)
SIZE_4096 = 4096
STEPS_4096 = 2000
# H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# floating-point operations of one cell-step of collide_fields (adds, products,
# the two divisions and the square root)
FLOP_PER_CELL_STEP = 94

KERNELS = {
    "d2q9_kstep_inplace": "lbm_tpu/ops/d2q9_pallas_inplace.py:78",
    "d2q9_kstep": "lbm_tpu/ops/d2q9_pallas.py:83",
    "d2q9_kstep_manual": "lbm_tpu/ops/d2q9_pallas_manual.py:52",
}
KERNEL_COPY_FLOOR = "experiments/d2q9-blocked-floor/run.py:72"
KERNELS_3D = {
    "d3q19_kstep_inplace": "lbm_tpu/ops/d3q19_pallas_inplace.py:50",
    "d3q19_kstep": "lbm_tpu/ops/d3q19_pallas.py:81",
}
# the 3-D bench shape and run (bench.py d3q19_mlups_64x128x256) and physics
SHAPE_3D = (64, 128, 256)
STEPS_3D = 1200
PHYSICS_3D = dict(omega=1.85, density=0.1, accel=0.005)
AV_VELS_PREFIX_3D = 24
# the blocked pair: the shape of bench.py's d3q19_blocked_only, a shape no tile
# divides, and the 256x256-plane oracle trace
KERNELS_3D_BLOCKED = {
    "d3q19_kstep_inplace_blocked": "lbm_tpu/ops/d3q19_pallas_inplace_blocked.py:148",
    "d3q19_kstep_blocked": "lbm_tpu/ops/d3q19_pallas.py:495",
}
SHAPE_BLOCKED = (32, 256, 256)
EDGE_SHAPE_BLOCKED = (13, 50, 70)
GOLDEN_BLOCKED = REPO / "experiments" / "d3q19-drift" / "d3q19_8x256x256_6000.av_vels.dat"
GOLDEN_BLOCKED_SHAPE = (8, 256, 256)
CHECKPOINT_STEPS_BLOCKED = 300
# operations of one cell-step of d3q19.collide_fields' paired grouping: 18
# adds for rho, 3 x (9 adds + a division), 5 for u^2, 2 for c_sq, 3 weight
# products, 3 for the rest speed, 9 pairs x 12 plus 9 for their eu, the root
FLOP_PER_CELL_STEP_3D = 179
GOLDEN_3D = REPO / "experiments" / "d3q19-drift" / "d3q19_16x64x128_6000.av_vels.dat"
GOLDEN_3D_SHAPE = (16, 64, 128)
GOLDEN_3D_BAR_F32 = 1.5e-3  # the floor of experiments/d3q19-drift/description.md
GOLDEN_3D_BAR_F64 = 1e-10   # first 200 steps

# the blur kernels and the TPU kernels they replace
KERNELS_BLUR = {
    "blur_resident": "lbm_tpu/ops/stencil.py:247",
    "blur_k": "lbm_tpu/ops/stencil.py:154",
    "blur_step": "lbm_tpu/ops/stencil.py:65",
}
# padded shapes (C, Hp, Wp) and the interior they hold
BRICKS = ((4, 304, 512), (302, 499))
LEAF = ((4, 1032, 896), (1024, 768))
BIG = ((4, 4128, 4224), (4096, 4096))  # a 4096x4096 image after pad_to_tile
BLUR_ITERS = 100  # the CLI's default: 200 passes
HOST_ORACLE_BAR = 1e-4  # eight passes against float64 numpy on the host
# kernel vs plain version: every factor of the blur is a power of two and
# the kernels add in their plain versions' order, so float32 is bit-equal;
# bfloat16 rounds the same float32 values, one unit in the last place allowed
# main path vs a float64 blur on the card. bfloat16 rounds the state 50 times
# in 200 passes (once per k = 4), each time by up to half a unit (2^-9 below 1)
STATE_BAR = {"float32": 1e-5, "bfloat16": 2e-2}
# operations per value and pass: the direct sum of B10 (4 products, 8 sums)
# and the separable pass of B9 and B8 (rows 3, columns 3, scale and mask 2)
FLOP_PER_VALUE_STEP = 12
FLOP_PER_VALUE_SEPARABLE = 8

# the overlap probes (B11): the eight builders of probe.py they replace, and
# probe.csv's case: 4096^2, band 64, 200 iterations
KERNEL_OVERLAP = "experiments/d2q9-overlap/probe.py:51,130,194,261,335,362,428,450"
OVERLAP_FUNCTIONS = ["build_auto", "build_manual", "build_manual_depth", "build_manual_flat",
                     "build_auto_flat", "build_manual_alias", "build_auto_alias",
                     "build_manual_alias_safe"]
OVERLAP_SIZE, OVERLAP_BAND, OVERLAP_ITERS = 4096, 64, 200
OVERLAP_ROUNDS = [0, 16, 64]
# the engines whose times the kernels line carries
OVERLAP_REPORTED = ("auto", "manual", "manual3", "manual4", "manual6", "manual_alias",
                    "manual_alias_safe", "manual@1x512", "manual_flat")

# the resident-blur variants (B13): the one pallas_call site of the study
# they replace
KERNEL_BLUR_RESIDENT_OPT = "experiments/blur-resident-opt/run.py:55"


class Failure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failure(msg)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def random_state(rng, ny, nx, density=0.1):
    """Equilibrium weights at rest, each perturbed by up to 20%."""
    w = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)[:, None, None]
    return density * w * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (9, ny, nx)))


def random_mask(rng, ny, nx):
    mask = rng.uniform(size=(ny, nx)) < 0.05
    mask[0, :] = mask[-1, :] = True
    mask[:, 0] = mask[:, -1] = True
    return mask


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def time_ms(torch, fn, iters: int) -> float:
    """Mean time of fn() over iters calls, by CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_ptxas(torch, d2q9_kstep, d2q9_kstep_manual):
    """What nvcc -Xptxas -v says of the four sources on the tile copy
    (registers, shared memory, spills of each kernel; the box paths of
    d2q9_kstep.cu, kstep_box_kernel, and of d2q9_manual.cu,
    manual_box_kernel, move their regions by TMA), and the blocks an SM of
    B1, B2 and B3 on each path at the flagship's 16x32, K=4: in float32
    three of B1 and B2 and two of B3 (whose three region buffers take twice
    B2's two), on either path."""
    harness = load_harness("ab_copy")
    t0 = time.perf_counter()
    try:
        for source in ("copy_floor", "overlap_probe", "d2q9_kstep", "d2q9_manual"):
            harness.ptxas_report(source)
    except SystemExit as err:
        raise Failure(f"nvcc -Xptxas -v failed: {err}") from err
    print(f"ptxas reports in {time.perf_counter() - t0:.1f} s")
    for itemsize in (4, 8):
        for in_place, name in ((False, "B2"), (True, "B1")):
            blocks = {path: d2q9_kstep.blocks_per_sm(in_place, path, (16, 32), 4, itemsize)
                      for path in d2q9_kstep.PATHS}
            smem = {"thread": d2q9_kstep.smem_bytes(16, 32, 4, itemsize),
                    "box": d2q9_kstep.box_smem_bytes(16, 32, 4, itemsize)}
            print(f"occupancy {name} 16x32 K=4 itemsize {itemsize}: blocks an SM {blocks}, "
                  f"shared memory a block {smem} B")
            if itemsize == 4:
                check(blocks["box"] >= 3 and blocks["thread"] >= 3,
                      f"{name}: fewer than three blocks an SM at 16x32 K=4 f32: {blocks}")
        dtype = torch.float32 if itemsize == 4 else torch.float64
        f = torch.empty((9, N, N), dtype=dtype, device="cuda")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        blocks = {path: d2q9_kstep_manual.grid_blocks(f, (16, 32), 4, path=path) / sms
                  for path in d2q9_kstep_manual.PATHS}
        smem = {"thread": d2q9_kstep_manual.smem_bytes(16, 32, 4, itemsize),
                "box": d2q9_kstep_manual.box_smem_bytes(16, 32, 4, itemsize)}
        print(f"occupancy B3 16x32 K=4 itemsize {itemsize}: blocks an SM {blocks}, "
              f"shared memory a block {smem} B")
        if itemsize == 4:
            check(min(blocks.values()) >= 2,
                  f"B3: fewer than two blocks an SM at 16x32 K=4 f32: {blocks}")
        del f


def path_line(mods, grid=None, k=1) -> str:
    """The path each of B2, B1 and B3 took in its last launch; for a box
    launch on grid = (ny, nx, tile) at K = k, how many tiles the boxes fill
    alone: B2's and B3's tiles whose region does not wrap, none of B1's (its
    side columns come from the snapshot)."""
    parts = []
    for name, mod, in_place in (("B2", mods[0], False), ("B1", mods[1], True),
                                ("B3", mods[2], False)):
        text = f"{name} {mod.last_path}"
        if grid is not None and mod.last_path == "box":
            ny, nx, (th, tw) = grid
            nty, ntx = ny // th, nx // tw
            alone = 0 if in_place else max(0, nty - 2 * -(-k // th)) * max(0, ntx - 2 * -(-k // tw))
            text += f" ({alone} of {nty * ntx} tiles by boxes alone, {nty * ntx - alone} " \
                    "with strips)"
        parts.append(text)
    return "paths " + ", ".join(parts)


def phase_parity(torch, mods, k_main):
    """Phase 2. Returns {kernel: max_abs_err} of the float32 main-K case."""
    from lbm_tpu_torch.core import state
    d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual = mods
    rng = np.random.default_rng(20261016)
    f_np, mask_np = random_state(rng, N, N), random_mask(rng, N, N)
    aw = dict(omega=1.85, accel_w1=0.1 * 0.01 / 9, accel_w2=0.1 * 0.01 / 36)
    window = dict(row_offset=100, valid_rows=(37, 1000), valid_cols=(5, 1000),
                  global_ny=1200, accel_row=700)
    abs_err = {}
    for dname, dtype in (("float64", torch.float64), ("float32", torch.float32)):
        f, mask = state.to_torch(f_np, mask_np, device="cuda", dtype=dtype)
        cases = [(k, "full", dict(accel_row=N - 2)) for k in range(1, 9)]
        cases.append((k_main, "window", window))
        b3_paths = set()
        for k, label, extra in cases:
            # B3's tile (16x16 at K=8 in float64, where its thread path's
            # three buffers of 16x32 do not fit), so that all three compare
            tile = d2q9_kstep_manual.choose_tile(N, N, f.element_size(), k)
            kw = dict(k_steps=k, **aw, **extra)
            ref_f, ref_tot = d2q9_kstep.stepk_plain(f, mask, **kw)
            torch.cuda.synchronize()
            b2_f, b2_tot = d2q9_kstep.stepk(f, mask, tile=tile, **kw)
            torch.cuda.synchronize()
            b1_f, b1_tot = d2q9_kstep_inplace.stepk(f.clone(), mask, tile=tile, **kw)
            torch.cuda.synchronize()
            b3_f, b3_tot = d2q9_kstep_manual.stepk(f, mask, tile=tile, **kw)
            torch.cuda.synchronize()
            b3_paths.add(d2q9_kstep_manual.last_path)
            for name, kf, kt in (("d2q9_kstep", b2_f, b2_tot),
                                 ("d2q9_kstep_inplace", b1_f, b1_tot),
                                 ("d2q9_kstep_manual", b3_f, b3_tot)):
                ef, et = rel_err(kf, ref_f), rel_err(kt, ref_tot)
                ea = float((kf - ref_f).abs().max())
                print(f"parity {name:19s} {dname} K={k} {label:6s}: state max rel err "
                      f"{ef:.3e} (max abs {ea:.3e}), Sum|u| max rel err {et:.3e}")
                check(np.isfinite(ef) and ef <= BARS[dname],
                      f"{name} {dname} K={k} {label}: state rel err {ef} > {BARS[dname]}")
                check(np.isfinite(et) and et <= BARS[dname],
                      f"{name} {dname} K={k} {label}: Sum|u| rel err {et} > {BARS[dname]}")
                if dname == "float32" and k == k_main and label == "full":
                    abs_err[name] = ea
            check(torch.equal(b1_f, b2_f) and torch.equal(b1_tot, b2_tot),
                  f"B1 is not bit-equal to B2 ({dname} K={k} {label})")
            check(torch.equal(b3_f, b2_f) and torch.equal(b3_tot, b2_tot),
                  f"B3 is not bit-equal to B2 ({dname} K={k} {label})")
            print(f"parity B1 == B2 == B3 bit for bit ({dname} K={k} {label}, tile "
                  f"{tile[0]}x{tile[1]}); {path_line(mods, (N, N, tile), k)}")
        check(b3_paths == set(d2q9_kstep_manual.PATHS),
              f"B3 ran on {sorted(b3_paths)} only in {dname}, not on both paths")
        # several passes of run: B1 hands each pass its boundary snapshot
        run_kw = dict(num_steps=3 * k_main, k_steps=k_main, accel_row=N - 2, **aw)
        b2_f, b2_tot = d2q9_kstep.run(f, mask, **run_kw)
        b1_f, b1_tot = d2q9_kstep_inplace.run(f.clone(), mask, **run_kw)
        b3_f, b3_tot = d2q9_kstep_manual.run(f, mask, **run_kw)
        torch.cuda.synchronize()
        check(torch.equal(b1_f, b2_f) and torch.equal(b1_tot, b2_tot)
              and torch.equal(b3_f, b2_f) and torch.equal(b3_tot, b2_tot),
              f"B1 or B3 run is not bit-equal to B2 run ({dname}, 3 passes of K={k_main})")
        print(f"parity B1 run == B2 run == B3 run bit for bit ({dname}, 3 passes of K={k_main}); "
              f"{path_line(mods)}")
    return abs_err


def phase_narrow_tiles(torch, mods, k_main):
    """Grids whose width is not a multiple of 32 run on the narrower tiles of
    TILE_CANDIDATES, and grids that no tile divides (64x1001, 72x130) on
    edge tiles, checked as in phase 2; a tile side shorter than K raises."""
    from lbm_tpu_torch.core import state
    d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual = mods
    rng = np.random.default_rng(11)
    aw = dict(omega=1.85, accel_w1=0.1 * 0.01 / 9, accel_w2=0.1 * 0.01 / 36)
    for ny, nx in ((1024, 1008), (1000, 1008), (1024, 1000), (64, 1001), (72, 130)):
        th, tw, _ = d2q9_kstep.choose_config(ny, nx)
        # every grid with sides of at least K, whatever its height mod 8,
        # goes to the fastest kernel that fits the card's free memory
        check(d2q9_kstep.choose_engine(ny, nx) == d2q9_kstep.AUTO_ENGINES[0],
              f"choose_engine({ny}, {nx}) is not {d2q9_kstep.AUTO_ENGINES[0]}")
        f_np, mask_np = random_state(rng, ny, nx), random_mask(rng, ny, nx)
        for dname, dtype in (("float64", torch.float64), ("float32", torch.float32)):
            f, mask = state.to_torch(f_np, mask_np, device="cuda", dtype=dtype)
            kw = dict(k_steps=k_main, accel_row=ny - 2, **aw)
            ref_f, ref_tot = d2q9_kstep.stepk_plain(f, mask, **kw)
            b2_f, b2_tot = d2q9_kstep.stepk(f, mask, **kw)
            b1_f, b1_tot = d2q9_kstep_inplace.stepk(f.clone(), mask, **kw)
            b3_f, b3_tot = d2q9_kstep_manual.stepk(f, mask, tile=(th, tw), **kw)
            run_kw = dict(num_steps=3 * k_main, k_steps=k_main, accel_row=ny - 2, **aw)
            r2 = d2q9_kstep.run(f, mask, **run_kw)
            r1 = d2q9_kstep_inplace.run(f.clone(), mask, **run_kw)
            r3 = d2q9_kstep_manual.run(f, mask, tile=(th, tw), **run_kw)
            torch.cuda.synchronize()
            ef, et = rel_err(b2_f, ref_f), rel_err(b2_tot, ref_tot)
            print(f"parity {ny}x{nx} tile {th}x{tw} {dname} K={k_main}: state max rel err "
                  f"{ef:.3e}, Sum|u| max rel err {et:.3e}; B1 == B2 == B3 (one pass, three); "
                  f"{path_line(mods)}")
            check(np.isfinite(ef) and ef <= BARS[dname] and np.isfinite(et) and et <= BARS[dname],
                  f"{ny}x{nx} {dname}: kernel B2 disagrees with the plain version")
            for name, got, run in (("B1", (b1_f, b1_tot), r1), ("B3", (b3_f, b3_tot), r3)):
                check(torch.equal(got[0], b2_f) and torch.equal(got[1], b2_tot)
                      and torch.equal(run[0], r2[0]) and torch.equal(run[1], r2[1]),
                      f"{ny}x{nx} {dname}: {name} is not bit-equal to B2")
    f, mask = state.to_torch(random_state(rng, 64, 1000), random_mask(rng, 64, 1000),
                             device="cuda", dtype=torch.float32)
    try:
        d2q9_kstep_inplace.stepk(f, mask, k_steps=8, accel_row=62, tile=(4, 8), **aw)
    except ValueError as err:
        print(f"raises as it must on tile 4x8 at K=8: {err}")
    else:
        raise Failure("no error on tile 4x8 at K=8")


def phase_modes(torch, mods, copy_floor):
    """The diagnostic modes and B12: stream_only of B1, B2 and B3 bit-equal
    to the plain version's state (Sum|u| within BARS), copy and B12 equal to
    their input, at 1024^2 float32 and 72x130 float64. Returns B12's largest
    |out - in| over its passes at 1024^2 float32 in the main path's tile."""
    from lbm_tpu_torch.core import state
    d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual = mods
    rng = np.random.default_rng(12)
    tile = d2q9_kstep.choose_config(N, N, torch.float32)[:2]
    copy_err = None
    aw = dict(omega=1.85, accel_w1=0.1 * 0.01 / 9, accel_w2=0.1 * 0.01 / 36)
    for (ny, nx), dname, dtype in (((N, N), "float32", torch.float32),
                                   ((72, 130), "float64", torch.float64)):
        f, mask = state.to_torch(random_state(rng, ny, nx), random_mask(rng, ny, nx),
                                 device="cuda", dtype=dtype)
        kw = dict(k_steps=4, accel_row=ny - 2, **aw)
        ref_f, ref_tot = d2q9_kstep.stepk_plain(f, mask, mode="stream_only", **kw)
        for name, mod in (("B2", d2q9_kstep), ("B1", d2q9_kstep_inplace),
                          ("B3", d2q9_kstep_manual)):
            got_f, got_tot = mod.stepk(f.clone(), mask, mode="stream_only", **kw)
            copy_f, _ = mod.stepk(f.clone(), mask, mode="copy", **kw)
            torch.cuda.synchronize()
            path = mod.last_path
            et = rel_err(got_tot, ref_tot)
            check(torch.equal(got_f, ref_f), f"{name} stream_only {ny}x{nx} {dname}: state "
                                             "differs from the plain version")
            check(et <= BARS[dname], f"{name} stream_only {ny}x{nx}: Sum|u| rel err {et}")
            check(torch.equal(copy_f, f), f"{name} copy {ny}x{nx} {dname}: state differs "
                                          "from the input")
            print(f"modes {name} {ny}x{nx} {dname} K=4 ({path} path): stream_only state "
                  f"bit-equal to the plain version (Sum|u| rel err {et:.3e}); copy returns its "
                  "input")
        for by, bx in (tile, (16, nx), (5, 7)):
            out = copy_floor.run_copy(f, 3, by, bx)
            torch.cuda.synchronize()
            check(torch.equal(out, f), f"B12 ({by}, {bx}) {ny}x{nx}: differs from its input")
            if (ny, nx, by, bx) == (N, N, *tile):
                copy_err = float((out - f).abs().max())
        print(f"modes B12 {ny}x{nx} {dname}: three passes equal the input bit for bit "
              f"(blocks {tile[0]}x{tile[1]}, full-width bands of 16 rows, 5x7)")
    print(f"modes B12 max |out - in| at {N}^2 float32, blocks {tile[0]}x{tile[1]}: {copy_err}")
    try:
        held = load_harness("ab_copy").b12_parity(torch, copy_floor,
                                                  log=lambda line: print(f"paths {line}"))
    except RuntimeError as err:
        raise Failure(str(err)) from err
    print(f"paths B12: {held} cases bit-equal to run_copy_plain (TMA and scalar paths, float32 "
          "and float64)")
    return copy_err


def phase_timing(torch, mods, k_main, copy_floor):
    """Time per launch of each kernel, and of the plain version, at the main
    path's shapes (1024^2 float32, K of choose_config), inside `run` as the
    main path calls them; B12 at the K-step tile and `copy_`, the library call
    that computes its function, at the same shape."""
    from lbm_tpu_torch.core import state
    d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual = mods
    rng = np.random.default_rng(7)
    f, mask = state.to_torch(random_state(rng, N, N), random_mask(rng, N, N),
                             device="cuda", dtype=torch.float32)
    kw = dict(omega=1.85, accel_w1=0.1 * 0.01 / 9, accel_w2=0.1 * 0.01 / 36,
              accel_row=N - 2)
    passes = 500
    ms = {}
    for name, mod in (("d2q9_kstep", d2q9_kstep), ("d2q9_kstep_inplace", d2q9_kstep_inplace),
                      ("d2q9_kstep_manual", d2q9_kstep_manual)):
        g = f.clone()
        ms[name] = time_ms(torch, lambda: mod.run(g, mask, num_steps=k_main * passes,
                                                  k_steps=k_main, **kw), 1) / passes
    plain_ms = time_ms(torch, lambda: d2q9_kstep.stepk_plain(f, mask, k_steps=k_main, **kw), 20)
    cells = N * N
    itemsize = 4
    bytes_moved = (2 * 9 * itemsize + 1) * cells + k_main * itemsize
    flops = FLOP_PER_CELL_STEP * k_main * cells
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    tile = d2q9_kstep_manual.choose_config(N, N)[:2]
    blocks = d2q9_kstep_manual.grid_blocks(f, tile, k_main)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ntiles = (N // tile[0]) * (N // tile[1])
    for name, t in ms.items():
        print(f"timing {name:19s}: {t:.4f} ms per K={k_main} launch "
              f"({cells * k_main / t / 1e3:.0f} MLUPS), bound {bound[0]:.4f} ms ({bound[1]}), "
              f"plain version {plain_ms:.4f} ms")
    b3_path = d2q9_kstep_manual.choose_path(N, N, tile, k_main, itemsize)
    smem = d2q9_kstep_manual.launch_smem(N, N)(*tile, k_main, itemsize)
    print(f"timing d2q9_kstep_manual: persistent grid of {blocks} blocks on {sms} SMs "
          f"({blocks / sms:g} an SM, {smem} B of shared memory each, {b3_path} path), {ntiles} "
          f"tiles of {tile[0]}x{tile[1]}: {ntiles / blocks:.2f} rounds")
    # B12: a pass of out = in at the K-step tile; bytes 9 values in and out a cell
    passes_copy = 1000
    copy_ms = time_ms(torch, lambda: copy_floor.run_copy(f, passes_copy, *tile), 1) / passes_copy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    copy_floor.run_copy(f, passes_copy, *tile)
    enqueue_us = (time.perf_counter() - t0) / passes_copy * 1e6
    torch.cuda.synchronize()
    path, chunk, stages = copy_floor.plan(f, f, *tile)
    per_sm = copy_floor.blocks_per_sm(4, chunk, stages)
    out = torch.empty_like(f)
    library_ms = time_ms(torch, lambda: out.copy_(f), 200)
    copy_plain_ms = time_ms(torch, lambda: copy_floor.run_copy_plain(f, 1, *tile), 200)
    copy_bound = (2 * 9 * itemsize * cells / HBM_BYTES_PER_S * 1e3, "bytes")
    print(f"timing copy_floor         : {copy_ms:.4f} ms per pass (blocks {tile[0]}x{tile[1]}, "
          f"{2 * 9 * itemsize * cells / copy_ms / 1e6:.0f} GB/s), bound {copy_bound[0]:.4f} ms "
          f"(bytes), plain version (clone) {copy_plain_ms:.4f} ms, library (copy_) "
          f"{library_ms:.4f} ms")
    print(f"timing copy_floor         : {path} path, chunk {chunk}, {stages} stage(s), {per_sm} "
          f"blocks an SM; the host enqueues a pass in {enqueue_us:.2f} us against "
          f"{copy_ms * 1e3:.2f} us of device time ({'device' if enqueue_us < copy_ms * 1e3 else 'HOST'}"
          "-bound)")
    copy = dict(ms=copy_ms, plain_ms=copy_plain_ms, library_ms=library_ms, bound=copy_bound,
                block=list(tile), path=path, chunk=list(chunk), stages=stages,
                blocks_per_sm=per_sm, host_enqueue_us=enqueue_us)
    occupancy = dict(blocks=blocks, blocks_per_sm=blocks / sms, tile=list(tile),
                     rounds=ntiles / blocks, path=b3_path, smem_bytes=smem)
    return ms, plain_ms, bound, copy, occupancy


def run_cli(main_fn, argv):
    """main_fn(argv) with its standard output captured. Returns (rc, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    return rc, buf.getvalue()


class CountCalls:
    """Counts the calls of module.name while active, to show that a path
    never reaches the plain engine."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0
        self.original = getattr(module, name)

    def __enter__(self):
        def counting(*args, **kwargs):
            self.calls += 1
            return self.original(*args, **kwargs)

        self.calls = 0
        setattr(self.module, self.name, counting)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)


def load_golden():
    cols = np.loadtxt(GOLDEN, usecols=(0, 1, 4, 5, 6))
    mask = np.zeros((N, N), bool)
    mask[cols[:, 1].astype(int), cols[:, 0].astype(int)] = cols[:, 4] != 0
    return cols, mask


def diff_pct(ref, sim):
    """verify/check.py's per-value rule: 100 * (ref - sim) / sim."""
    diff = ref - sim
    with np.errstate(divide="ignore", invalid="ignore"):
        return 100.0 * (diff / (ref - diff))


def engine_modules(mods):
    """{2-D kernel engine: its wrapper module}."""
    return {"cuda": mods[0], "cuda-inplace": mods[1], "cuda-manual": mods[2]}


def phase_main_path(torch, mods, golden, mask):
    """Phase 3. Returns {engine: (launches, seconds, mlups, path)} of each
    run, and the engine that `auto` picked."""
    from lbm_tpu_torch.cli import lbm as cli
    from lbm_tpu_torch.core import io as lbm_io
    from lbm_tpu_torch.core.params import Obstacles, Params
    from lbm_tpu_torch.models import lbm as lbm_model
    from lbm_tpu_torch.ops import d2q9
    d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual = mods

    results = {}
    avs = {}
    # the engine the rule names for this card's free memory now; the CLI
    # asks again when it runs
    steps = FLAGSHIP["max_iters"]
    picked = d2q9_kstep.choose_engine(N, N, torch.float32, num_steps=steps)
    needs = {e: d2q9_kstep.simulate_bytes(e, N, N, torch.float32, steps)
             for e in d2q9_kstep.AUTO_ENGINES}
    print(f"main path: choose_engine(1024, 1024, float32) = {picked} (free device memory "
          f"{d2q9_kstep.free_device_bytes()} B; the runs need {needs} B)")
    by_engine = engine_modules(mods)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        params = Params(**FLAGSHIP)
        obstacles = Obstacles(mask)
        params.to_file(tmp / "input_1024x1024.params")
        obstacles.to_file(tmp / "obstacles_1024x1024.dat")
        print(f"main path: flagship mask has {obstacles.num_blocked} blocked cells")
        for engine in ("auto", "cuda-inplace", "cuda", "cuda-manual"):
            mod = by_engine[picked if engine == "auto" else engine]
            kernel = mod.__name__.rsplit(".", 1)[1]
            out = tmp / engine
            argv = ["--params", str(tmp / "input_1024x1024.params"),
                    "--obstacles", str(tmp / "obstacles_1024x1024.dat"),
                    "--engine", engine, "--dtype", "float32", "--out-dir", str(out)]
            for m in mods:
                m.launches = 0
            with CountCalls(d2q9, "collide_fields") as plain:
                rc, text = run_cli(cli.main, argv)
            launches = mod.launches
            other_launches = sum(m.launches for m in mods if m is not mod)
            print(f"main path --engine {engine}:\n{text.rstrip()}")
            check(rc == 0, f"cli returned {rc}")
            check(launches > 0, f"--engine {engine}: {kernel} was never launched")
            check(other_launches == 0, f"--engine {engine}: another 2-D kernel was launched")
            check(plain.calls == 0,
                  f"--engine {engine}: the plain engine ran {plain.calls} collisions")
            if engine == "auto":
                check(re.search(rf"^engine:\s+{picked}$", text, re.M) is not None,
                      f"--engine auto did not choose {picked}")
            seconds = float(re.search(r"Total compute time:\s+([0-9.eE+-]+)", text).group(1))
            mlups = float(re.search(r"MLUPS:\s+([0-9.eE+-]+)", text).group(1))
            # launches count the warm-up run and the timed run, which are equal
            per_launch_ms = seconds / (launches / 2) * 1e3
            path = mod.last_path
            # the flagship shape moves its regions by TMA
            check(path == "box", f"--engine {engine}: {kernel} took the {path} path")
            print(f"main path --engine {engine} ({kernel}): {launches} launches, {seconds:.6f} s "
                  f"timed, {mlups} MLUPS, {per_launch_ms:.4f} ms per launch in the timed run, "
                  f"{path} path")
            results[engine] = (launches, seconds, mlups, path)

            sim = np.loadtxt(out / "final_state.dat", usecols=(0, 1, 4, 5))
            check(sim.shape == (N * N, 4), f"final_state.dat has shape {sim.shape}")
            check(np.array_equal(sim[:, :2], golden[:, :2]),
                  "final state coordinates differ from the golden file")
            pct = diff_pct(golden[:, 3], sim[:, 3])
            worst = int(np.argmax(np.abs(pct)))
            print(f"checker rule (column 5, pressure): max diff {pct[worst]:.3e}% at "
                  f"({int(sim[worst, 0])},{int(sim[worst, 1])}), tolerance {CHECK_TOLERANCE_PCT}%")
            check(np.isfinite(pct[worst]) and abs(pct[worst]) <= CHECK_TOLERANCE_PCT,
                  f"--engine {engine}: final state fails the checker's 1% rule")
            u_err = np.abs(sim[:, 2] - golden[:, 2]).max() / np.abs(golden[:, 2]).max()
            print(f"|u| column: max abs error / max|u| = {u_err:.3e} (not gated: f32 "
                  "state rounding over 20,000 steps)")
            av = lbm_io.read_av_vels(out / "av_vels.dat")
            check(av.shape == (FLAGSHIP["max_iters"],) and np.isfinite(av).all(),
                  f"--engine {engine}: av_vels.dat is malformed")
            avs[engine] = av

    plain = lbm_model.run_simulation(Params(**FLAGSHIP), Obstacles(mask), dtype=torch.float32,
                                     engine="torch", num_steps=100, device="cuda")
    for engine, av in avs.items():
        err = float(np.max(np.abs(av[:100] - plain.av_vels) / np.abs(plain.av_vels)))
        print(f"av_vels[:100] of --engine {engine} vs the plain engine on the card: max rel err "
              f"{err:.3e} (bar {AV_VELS_BAR})")
        check(err <= AV_VELS_BAR, f"{engine}: av_vels prefix rel err {err} > {AV_VELS_BAR}")
    return results, picked


def random_state_3d(rng, nz, ny, nx, density=0.1):
    """Equilibrium weights at rest, each perturbed by up to 20%."""
    w = np.array([1 / 3] + [1 / 18] * 6 + [1 / 36] * 12)[:, None, None, None]
    return density * w * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, (19, nz, ny, nx)))


def random_mask_3d(rng, nz, ny, nx):
    mask = rng.uniform(size=(nz, ny, nx)) < 0.05
    mask[0] = mask[-1] = True
    return mask


def phase_parity_3d(torch, mods3, k_main):
    """Phase 4. Returns {kernel: max_abs_err} of the float32 main-K case."""
    from lbm_tpu_torch.core import state
    d3q19_kstep, d3q19_kstep_inplace = mods3
    nz, ny, nx = SHAPE_3D
    rng = np.random.default_rng(20261017)
    f_np, mask_np = random_state_3d(rng, nz, ny, nx), random_mask_3d(rng, nz, ny, nx)
    # a ghost-extended block: local plane p is global plane p + 10 of an
    # 80-plane grid, so the accelerated plane 40 is local plane 30
    window = dict(plane_offset=10, valid_planes=(3, 60), valid_rows=(5, 120), global_nz=80,
                  accel_plane=40)
    abs_err = {}
    for dname, dtype in (("float64", torch.float64), ("float32", torch.float32)):
        f, mask = state.to_torch3d(f_np, mask_np, device="cuda", dtype=dtype)
        cases = [(k, "full", dict(accel_plane=nz - 2)) for k in sorted({1, k_main, 3})]
        cases.append((k_main, "window", window))
        for k, label, extra in cases:
            kw = dict(k_steps=k, **PHYSICS_3D, **extra)
            ref_f, ref_tot = d3q19_kstep.stepk_plain(f, mask, **kw)
            torch.cuda.synchronize()
            b6_f, b6_tot = d3q19_kstep.stepk(f, mask, **kw)
            torch.cuda.synchronize()
            g = f.clone()
            b4_f, b4_tot = d3q19_kstep_inplace.stepk(g, mask, **kw)
            torch.cuda.synchronize()
            check(b4_f.data_ptr() == g.data_ptr(), "B4 did not write into its input's storage")
            for name, kf, kt in (("d3q19_kstep", b6_f, b6_tot),
                                 ("d3q19_kstep_inplace", b4_f, b4_tot)):
                ef, et = rel_err(kf, ref_f), rel_err(kt, ref_tot)
                ea = float((kf - ref_f).abs().max())
                print(f"parity {name:19s} {dname} K={k} {label:6s}: state max rel err "
                      f"{ef:.3e} (max abs {ea:.3e}), Sum|u| max rel err {et:.3e}")
                check(np.isfinite(ef) and ef <= BARS[dname],
                      f"{name} {dname} K={k} {label}: state rel err {ef} > {BARS[dname]}")
                check(np.isfinite(et) and et <= BARS[dname],
                      f"{name} {dname} K={k} {label}: Sum|u| rel err {et} > {BARS[dname]}")
                if dname == "float32" and k == k_main and label == "full":
                    abs_err[name] = ea
            check(torch.equal(b4_f, b6_f) and torch.equal(b4_tot, b6_tot),
                  f"B4 is not bit-equal to B6 ({dname} K={k} {label})")
            print(f"parity B4 == B6 bit for bit ({dname} K={k} {label})")
            del ref_f, b6_f, b4_f, g
        run_kw = dict(num_steps=3 * k_main, k_steps=k_main, accel_plane=nz - 2, **PHYSICS_3D)
        b6_f, b6_tot = d3q19_kstep.run(f, mask, **run_kw)
        g = f.clone()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        b4_f, b4_tot = d3q19_kstep_inplace.run(g, mask, **run_kw)
        torch.cuda.synchronize()
        extra_bytes = torch.cuda.max_memory_allocated() - before
        check(torch.equal(b4_f, b6_f) and torch.equal(b4_tot, b6_tot),
              f"B4 run is not bit-equal to B6 run ({dname}, 3 passes of K={k_main})")
        print(f"parity B4 run == B6 run bit for bit ({dname}, 3 passes of K={k_main})")
        # B4's run holds the lattice and the mask (already counted in
        # `before`) and may add less than half of them again
        held = g.numel() * g.element_size() + mask.numel()
        print(f"memory B4 run ({dname}): lattice + mask {held} B, allocated on top "
              f"{extra_bytes} B, peak {(held + extra_bytes) / held:.4f} x (bar 1.5 x)")
        check(b4_f.data_ptr() == g.data_ptr(), "B4 run did not stay in its input's storage")
        check(held + extra_bytes < 1.5 * held, f"B4 run allocated {extra_bytes} B on top")
        del b6_f, b4_f, g, f
    return abs_err


def phase_timing_3d(torch, mods3, k_main):
    """Time per launch (one pass of K steps) of each 3-D kernel and of the
    plain version at the main path's shape, 64x128x256 float32, inside `run`
    as the main path calls them."""
    from lbm_tpu_torch.core import state
    d3q19_kstep, d3q19_kstep_inplace = mods3
    nz, ny, nx = SHAPE_3D
    rng = np.random.default_rng(8)
    f, mask = state.to_torch3d(random_state_3d(rng, nz, ny, nx), random_mask_3d(rng, nz, ny, nx),
                               device="cuda", dtype=torch.float32)
    kw = dict(accel_plane=nz - 2, **PHYSICS_3D)
    passes = 200
    ms = {}
    for name, mod in (("d3q19_kstep", d3q19_kstep), ("d3q19_kstep_inplace", d3q19_kstep_inplace)):
        g = f.clone()
        ms[name] = time_ms(torch, lambda: mod.run(g, mask, num_steps=k_main * passes,
                                                  k_steps=k_main, **kw), 1) / passes
    plain_ms = time_ms(torch, lambda: d3q19_kstep.stepk_plain(f, mask, k_steps=k_main, **kw), 5)
    cells = nz * ny * nx
    itemsize = 4
    # a pass reads the lattice and the mask once and writes the lattice and
    # K sums once, whatever K is; its operations grow with K
    bytes_moved = (2 * 19 * itemsize + 1) * cells + k_main * itemsize
    flops = FLOP_PER_CELL_STEP_3D * k_main * cells
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    for name, t in ms.items():
        print(f"timing {name:19s}: {t:.4f} ms per K={k_main} launch "
              f"({cells * k_main / t / 1e3:.0f} MLUPS), bound {bound[0]:.4f} ms ({bound[1]}), "
              f"plain version {plain_ms:.4f} ms")
    return ms, plain_ms, bound


def phase_main_path_3d(torch, mods3):
    """Phase 5. Returns {kernel: (launches, seconds, mlups)} of each path."""
    from lbm_tpu_torch.cli import lbm3d as cli3
    from lbm_tpu_torch.core import io as lbm_io
    from lbm_tpu_torch.ops import d3q19
    d3q19_kstep, d3q19_kstep_inplace = mods3
    nz, ny, nx = SHAPE_3D
    results, avs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for engine_args, kernel, mod, other in (
                ([], "d3q19_kstep_inplace", d3q19_kstep_inplace, d3q19_kstep),
                (["--engine", "cuda"], "d3q19_kstep", d3q19_kstep, d3q19_kstep_inplace)):
            out = Path(tmp) / kernel
            argv = ["--nz", str(nz), "--ny", str(ny), "--nx", str(nx), "-n", str(STEPS_3D),
                    "--dtype", "float32", "--out-dir", str(out), *engine_args]
            d3q19_kstep.launches = d3q19_kstep_inplace.launches = 0
            with CountCalls(d3q19, "collide_fields") as plain:
                rc, text = run_cli(cli3.main, argv)
            launches, other_launches = mod.launches, other.launches
            print(f"3-D main path {' '.join(engine_args) or '(default engine)'}:\n{text.rstrip()}")
            check(rc == 0, f"cli returned {rc}")
            check(launches > 0, f"3-D {engine_args}: {kernel} was never launched")
            check(other_launches == 0, f"3-D {engine_args}: the other kernel was launched")
            check(plain.calls == 0, f"3-D {engine_args}: the plain engine ran "
                                    f"{plain.calls} collisions")
            if not engine_args:
                check(re.search(r"^engine:\s+cuda-inplace$", text, re.M) is not None,
                      "the 3-D CLI's default engine is not cuda-inplace")
            seconds = float(re.search(r"Total compute time:\s+([0-9.eE+-]+)", text).group(1))
            mlups = float(re.search(r"MLUPS:\s+([0-9.eE+-]+)", text).group(1))
            # launches count the warm-up run and the timed run, which are equal
            print(f"3-D main path {kernel}: {launches} launches, {seconds:.6f} s timed, "
                  f"{mlups} MLUPS, {seconds / (launches / 2) * 1e3:.4f} ms per launch in the "
                  "timed run")
            results[kernel] = (launches, seconds, mlups)
            av = lbm_io.read_av_vels(out / "av_vels_3d.dat")
            check(av.shape == (STEPS_3D,) and np.isfinite(av).all(),
                  f"3-D {engine_args}: av_vels_3d.dat is malformed")
            avs[kernel] = av
    _, plain_av = d3q19.simulate(nz, ny, nx, num_steps=AV_VELS_PREFIX_3D, engine="torch",
                                 dtype=torch.float32, device="cuda", **PHYSICS_3D)
    plain_av = plain_av.cpu().numpy().astype(np.float64)
    for kernel, av in avs.items():
        # step 0 is skipped: Sum|u| is 0 on the uniform start state
        err = float(np.max(np.abs(av[1:AV_VELS_PREFIX_3D] - plain_av[1:]) / np.abs(plain_av[1:])))
        print(f"av_vels[1:{AV_VELS_PREFIX_3D}] of {kernel} vs the plain engine on the card: "
              f"max rel err {err:.3e} (bar {AV_VELS_BAR})")
        check(err <= AV_VELS_BAR, f"{kernel}: av_vels prefix rel err {err} > {AV_VELS_BAR}")
    return results


def phase_golden_3d(torch):
    """Phase 6: the 6000-step float64 oracle trace of the serial C++ engine."""
    from lbm_tpu_torch.core import io as lbm_io
    from lbm_tpu_torch.ops import d3q19
    nz, ny, nx = GOLDEN_3D_SHAPE
    golden = lbm_io.read_av_vels(GOLDEN_3D)
    check(golden.shape == (6000,), f"golden trace has shape {golden.shape}")
    for engine in ("cuda-inplace", "cuda"):
        _, av = d3q19.simulate(nz, ny, nx, num_steps=6000, engine=engine, dtype=torch.float32,
                               device="cuda", **PHYSICS_3D)
        av = av.cpu().numpy().astype(np.float64)
        rel = np.abs(av[1:] - golden[1:]) / golden[1:]
        print(f"golden 16x64x128 x 6000 float32 --engine {engine}: max rel err {rel.max():.3e}, "
              f"final {rel[-1]:.3e} (bar {GOLDEN_3D_BAR_F32})")
        check(np.isfinite(rel).all() and rel.max() <= GOLDEN_3D_BAR_F32,
              f"{engine}: golden trace max rel err {rel.max()} > {GOLDEN_3D_BAR_F32}")
    _, av = d3q19.simulate(nz, ny, nx, num_steps=200, engine="cuda", dtype=torch.float64,
                           device="cuda", **PHYSICS_3D)
    av = av.cpu().numpy()
    rel = np.abs(av[1:] - golden[1:200]) / golden[1:200]
    print(f"golden 16x64x128 float64 --engine cuda, first 200 steps: max rel err "
          f"{rel.max():.3e} (bar {GOLDEN_3D_BAR_F64})")
    check(np.isfinite(rel).all() and rel.max() <= GOLDEN_3D_BAR_F64,
          f"float64 golden prefix max rel err {rel.max()} > {GOLDEN_3D_BAR_F64}")


def phase_checkpoint(torch, mods, mods3, mask):
    """Phase 7: chunked + resumed runs equal uninterrupted ones bit for bit.
    Returns {engine: launches of the chunked and resumed runs} (2-D by
    engine name, 3-D by kernel)."""
    from lbm_tpu_torch.cli import lbm as cli
    from lbm_tpu_torch.cli import lbm3d as cli3
    from lbm_tpu_torch.core.params import Obstacles, Params
    from lbm_tpu_torch.models import lbm as lbm_model
    from lbm_tpu_torch.ops import d3q19
    d2q9_kstep = mods[0]
    d3q19_kstep, d3q19_kstep_inplace = mods3
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 2-D: B1 (--engine cuda-inplace) and `auto` 2000 steps in chunks of
        # 1000, then on to 4000; B3 (--engine cuda-manual) 1000 in chunks of 500
        params, obstacles = Params(**FLAGSHIP), Obstacles(mask)
        params.to_file(tmp / "input.params")
        obstacles.to_file(tmp / "obstacles.dat")
        by_engine = engine_modules(mods)
        for engine, n in (("cuda-inplace", 2000), ("cuda-manual", 1000), ("auto", 2000)):
            mod = by_engine[d2q9_kstep.choose_engine(N, N, num_steps=2 * n)
                            if engine == "auto" else engine]
            kernel = mod.__name__.rsplit(".", 1)[1]
            out = tmp / f"ck2d_{engine}"
            base = ["--params", str(tmp / "input.params"), "--obstacles",
                    str(tmp / "obstacles.dat"), "--engine", engine, "--out-dir", str(out),
                    "--checkpoint-every", str(n // 2)]
            for m in mods:
                m.launches = 0
            for argv in (base + ["--num-steps", str(n)],
                         base + ["--num-steps", str(2 * n), "--resume"]):
                rc, text = run_cli(cli.main, argv)
                check(rc == 0, f"2-D checkpointed cli (--engine {engine}) returned {rc}")
            launches[engine] = mod.launches
            check(mod.launches > 0 and all(m.launches == 0 for m in mods if m is not mod),
                  f"the --engine {engine} checkpointed run did not go through {kernel} alone")
            ref = lbm_model.run_simulation(params, obstacles, dtype=torch.float32, engine=engine,
                                           num_steps=2 * n, device="cuda")
            with np.load(out / "checkpoint.npz") as ck:
                check(int(ck["step"]) == 2 * n and int(ck["k_steps"]) > 0,
                      f"the --engine {engine} checkpoint does not record step and k_steps")
                check(np.array_equal(ck["av_vels"], ref.av_vels),
                      f"--engine {engine}: resumed av_vels differ from the uninterrupted run")
                check(np.array_equal(ck["f"], ref.f_final),
                      f"--engine {engine}: resumed final state differs from the uninterrupted run")
            print(f"checkpoint 2-D 1024x1024 (--engine {engine}, {kernel}, {launches[engine]} "
                  f"launches): {n} steps in chunks of {n // 2}, resumed to {2 * n}: av_vels and "
                  "final state equal the uninterrupted run bit for bit")

        # 3-D, kernel B4: 600 steps in chunks of 300, then on to 1200
        nz, ny, nx = SHAPE_3D
        n = STEPS_3D // 2
        base = ["--nz", str(nz), "--ny", str(ny), "--nx", str(nx), "--out-dir", str(tmp / "ck3d"),
                "--checkpoint-every", str(n // 2)]
        d3q19_kstep.launches = d3q19_kstep_inplace.launches = 0
        for argv in (base + ["-n", str(n)], base + ["-n", str(2 * n), "--resume"]):
            rc, text = run_cli(cli3.main, argv)
            check(rc == 0, f"3-D checkpointed cli returned {rc}")
        launches["d3q19_kstep_inplace"] = d3q19_kstep_inplace.launches
        check(d3q19_kstep_inplace.launches > 0 and d3q19_kstep.launches == 0,
              "the 3-D checkpointed run did not go through B4 alone")
        ref_f, ref_av = d3q19.simulate(nz, ny, nx, num_steps=2 * n, engine="cuda-inplace",
                                       dtype=torch.float32, device="cuda", **PHYSICS_3D)
        with np.load(tmp / "ck3d" / "checkpoint_3d.npz") as ck:
            check(int(ck["step"]) == 2 * n, "the 3-D checkpoint does not record its step")
            check(np.array_equal(ck["av_vels"], ref_av.cpu().numpy().astype(np.float64)),
                  "3-D: resumed av_vels differ from the uninterrupted run")
            check(np.array_equal(ck["f"], ref_f.cpu().numpy()),
                  "3-D: resumed final state differs from the uninterrupted run")
        print(f"checkpoint 3-D 64x128x256 (B4, {launches['d3q19_kstep_inplace']} launches): "
              f"{n} steps in chunks of {n // 2}, resumed to {2 * n}: av_vels and final state "
              "equal the uninterrupted run bit for bit")
    return launches


def phase_4096(torch, mods):
    """The JAX bench's d2q9_4096 case (bench.py `d2q9_4096_only`): a uniform
    4096^2 float32 state, no obstacles, omega 1.85, accel 0.005 at density
    0.1, 2,000 steps at choose_config's K through B3, B2 and B1, each by its
    wrapper's `run` as the bench runs its engine. The first 96 steps of each
    are held to the plain engine on the card (Sum|u|, the bench's 4e-4 gate)
    and double as the warm-up; the 2,000-step run is timed with CUDA events;
    the three final states and Sum|u| series must be equal bit for bit.
    Returns {kernel: (launches, seconds, mlups)}."""
    from lbm_tpu_torch.ops import d2q9
    d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual = mods
    n = SIZE_4096
    f = torch.full((9, n, n), 0.1 / 9, dtype=torch.float32, device="cuda")
    mask = torch.zeros((n, n), dtype=torch.bool, device="cuda")
    w1, w2 = 0.1 * 0.005 / 9, 0.1 * 0.005 / 36
    kw = dict(omega=1.85, accel_w1=w1, accel_w2=w2, accel_row=n - 2)
    amask = d2q9.accel_row_mask(n, n, n - 2, dtype=f.dtype, device=f.device)
    _, ref_tot = d2q9.run(f, mask, amask, num_steps=96, omega=1.85, accel_w1=w1, accel_w2=w2)
    results, finals = {}, {}
    for name, mod in (("d2q9_kstep_manual", d2q9_kstep_manual), ("d2q9_kstep", d2q9_kstep),
                      ("d2q9_kstep_inplace", d2q9_kstep_inplace)):
        th, tw, k = (mod.choose_config if mod is d2q9_kstep_manual
                     else d2q9_kstep.choose_config)(n, n)
        for m in mods:
            m.launches = 0
        _, tot96 = mod.run(f.clone(), mask, num_steps=96, k_steps=k, **kw)
        err = float(((tot96[1:] - ref_tot[1:]).abs() / ref_tot[1:].abs()).max())
        check(np.isfinite(err) and err <= AV_VELS_BAR,
              f"4096^2 {name}: 96-step Sum|u| rel err {err} > {AV_VELS_BAR}")
        g = f.clone()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out, tots = mod.run(g, mask, num_steps=STEPS_4096, k_steps=k, **kw)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
        launched = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods if m.launches}
        check(list(launched) == [name], f"4096^2 {name}: launched {launched}")
        check(bool(torch.isfinite(out).all()) and bool(torch.isfinite(tots).all()),
              f"4096^2 {name}: the state or Sum|u| is not finite")
        mlups = n * n * STEPS_4096 / seconds / 1e6
        print(f"4096^2 x {STEPS_4096} float32 {name} (tile {th}x{tw}, K={k}): {seconds:.6f} s, "
              f"{mlups:.1f} MLUPS, {launched[name]} launches (96 + {STEPS_4096} steps), "
              f"first 96 Sum|u| vs plain max rel err {err:.3e} (bar {AV_VELS_BAR})")
        results[name] = (launched[name], seconds, mlups)
        finals[name] = (out, tots)
        del g
    b2 = finals["d2q9_kstep"]
    for name in ("d2q9_kstep_manual", "d2q9_kstep_inplace"):
        check(torch.equal(finals[name][0], b2[0]) and torch.equal(finals[name][1], b2[1]),
              f"4096^2: {name} is not bit-equal to d2q9_kstep after {STEPS_4096} steps")
    print(f"4096^2: B3 and B1 equal B2 bit for bit after {STEPS_4096} steps (state and Sum|u|)")
    return results


def phase_any_width(torch, mods):
    """A 64x1001 grid, whose width no tile divides, through run_simulation
    with --engine auto, cuda, cuda-inplace and cuda-manual, each against the
    plain engine on the card: float32 (200 steps, 4e-4) and float64 (1e-10),
    on av_vels and the final state."""
    from lbm_tpu_torch.core.params import Obstacles, Params
    from lbm_tpu_torch.models import lbm as lbm_model
    d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual = mods
    ny, nx = 64, 1001
    params = Params(nx=nx, ny=ny, max_iters=200, reynolds_dim=10, density=0.1, accel=0.005,
                    omega=1.85)
    obstacles = Obstacles(random_mask(np.random.default_rng(13), ny, nx))
    for dname, dtype, bar in (("float32", torch.float32, AV_VELS_BAR),
                              ("float64", torch.float64, GOLDEN_3D_BAR_F64)):
        plain = lbm_model.run_simulation(params, obstacles, dtype=dtype, engine="torch",
                                         device="cuda")
        by_engine = engine_modules(mods)
        auto = by_engine[d2q9_kstep.choose_engine(ny, nx, dtype, num_steps=params.max_iters)]
        for engine, mod in (("auto", auto), ("cuda", d2q9_kstep),
                            ("cuda-inplace", d2q9_kstep_inplace),
                            ("cuda-manual", d2q9_kstep_manual)):
            for m in mods:
                m.launches = 0
            res = lbm_model.run_simulation(params, obstacles, dtype=dtype, engine=engine,
                                           device="cuda")
            others = sum(m.launches for m in mods if m is not mod)
            check(mod.launches > 0 and others == 0,
                  f"{ny}x{nx} --engine {engine}: not through its kernel alone")
            e_av = float(np.abs(res.av_vels - plain.av_vels).max() / np.abs(plain.av_vels).max())
            e_f = float(np.abs(res.f_final - plain.f_final).max() / np.abs(plain.f_final).max())
            path = mod.last_path
            print(f"{ny}x{nx} {dname} --engine {engine} ({res.engine}, {mod.launches} launches, "
                  f"{path} path): av_vels rel err {e_av:.3e}, final state {e_f:.3e} vs the plain "
                  f"engine (bar {bar})")
            check(np.isfinite(e_av) and e_av <= bar and np.isfinite(e_f) and e_f <= bar,
                  f"{ny}x{nx} {dname} --engine {engine}: outside the bar of the plain engine")


def load_harness(name):
    """experiments/cuda-kstep-tiles/<name>.py as a module."""
    import importlib.util
    path = REPO / "experiments" / "cuda-kstep-tiles" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cuda_kstep_tiles_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_breakdown_path(torch, mods, copy_floor, k_main):
    """The 2-D time-breakdown path at 1024^2: experiments/cuda-kstep-tiles/
    breakdown2d.py (modes full, stream_only and copy of B2, B3 and B1 at
    choose_config's K) and copy_floor2d.py (B12 over the K-step tiles and
    full-width bands, and `copy_`), cut to one grid and 100 passes. Returns
    ({kernel: launches}, {engine: {mode: us per step}}, {pattern: us})."""
    breakdown2d, copy_floor2d = load_harness("breakdown2d"), load_harness("copy_floor2d")
    for m in (*mods, copy_floor):
        m.launches = 0
    rows = breakdown2d.breakdown([N], ks=[k_main], passes=100)
    floor_rows = copy_floor2d.shape_sweep([N], passes=100)
    launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in (*mods, copy_floor)}
    check(all(launches.values()), f"the breakdown path left a kernel out: {launches}")
    for line in breakdown2d.summary(rows):
        print(f"breakdown {line}")
    for r in floor_rows:
        shape = f"blocks {r['by']}x{r['bx']}" if r["by"] else "(library)"
        print(f"copy floor {r['pattern']:5s} {shape}: {r['us_per_pass']} us a pass, "
              f"{r['gbps_effective']} GB/s")
    print(f"breakdown path launches: {launches}")
    per_step = {}
    for r in rows:
        per_step.setdefault(r["engine"], {})[r["mode"]] = r["us_per_step"]
    floor = {f"{r['pattern']} {r['by']}x{r['bx']}" if r["by"] else r["pattern"]: r["us_per_pass"]
             for r in floor_rows}
    return launches, per_step, floor


def hold_blocked(what, dname, got, ref):
    """State and Sum|u| of a blocked kernel against the plain version's."""
    ef, et = rel_err(got[0], ref[0]), rel_err(got[1], ref[1])
    check(np.isfinite(ef) and ef <= BARS[dname], f"{what}: state rel err {ef} > {BARS[dname]}")
    check(np.isfinite(et) and et <= BARS[dname], f"{what}: Sum|u| rel err {et} > {BARS[dname]}")
    return ef, et


def phase_parity_blocked(torch, mods3, modsb):
    """Kernels B7 and B5 vs the plain version. Returns {kernel: max_abs_err}
    of the float32 case at the main path's K."""
    from lbm_tpu_torch.core import state
    d3q19_kstep, d3q19_kstep_inplace = mods3
    b7, b5 = modsb
    counters = (d3q19_kstep, d3q19_kstep_inplace, b7, b5)
    rng = np.random.default_rng(20261021)
    abs_err = {}
    for shape in (SHAPE_BLOCKED, EDGE_SHAPE_BLOCKED):
        nz, ny, nx = shape
        f_np, mask_np = random_state_3d(rng, *shape), random_mask_3d(rng, *shape)
        # a ghost-extended block: local plane p is global plane p + 10 of a
        # grid of nz + 20 planes, the accelerated plane in its middle
        window = dict(plane_offset=10, valid_planes=(3, nz - 4), valid_rows=(5, ny - 8),
                      global_nz=nz + 20, accel_plane=nz // 2 + 10)
        for dname, dtype in (("float64", torch.float64), ("float32", torch.float32)):
            f, mask = state.to_torch3d(f_np, mask_np, device="cuda", dtype=dtype)
            cases = [(k, "full", dict(accel_plane=nz - 2)) for k in (1, 2, 3, 4)]
            cases.append((b7.PREFERRED_K, "window", window))
            for k, label, extra in cases:
                kw = dict(k_steps=k, **PHYSICS_3D, **extra)
                tile = b5.choose_config(nz, ny, nx, k, dtype, f.device)
                ref = d3q19_kstep.stepk_plain(f, mask, **kw)
                b6_f, _ = d3q19_kstep.stepk(f, mask, **kw)
                torch.cuda.synchronize()
                before = [m.launches for m in counters]
                b7_out = b7.stepk(f, mask, tile=tile, **kw)
                own_f, _ = b7.stepk(f, mask, **kw)  # B7 at its own tile
                g = f.clone()
                b5_out = b5.stepk(g, mask, tile=tile, **kw)
                torch.cuda.synchronize()
                counted = [m.launches - n for m, n in zip(counters, before)]
                check(counted == [0, 0, 2, 1],
                      f"one pass of K={k} steps took launches {counted} of (B6, B4, B7, B5), "
                      "not one of the blocked kernel each")
                check(b5_out[0].data_ptr() == g.data_ptr(),
                      "B5 did not write into its input's storage")
                what = f"{nz}x{ny}x{nx} {dname} K={k} {label}"
                hold_blocked(f"d3q19_kstep_inplace_blocked {what}", dname, b5_out, ref)
                ef, et = hold_blocked(f"d3q19_kstep_blocked {what}", dname, b7_out, ref)
                ea = float((b7_out[0] - ref[0]).abs().max())
                if (shape == SHAPE_BLOCKED and dname == "float32" and label == "full"
                        and k == b7.PREFERRED_K):
                    # B5 is held bit-equal to B7 below, so the error is B5's too
                    abs_err = dict.fromkeys(KERNELS_3D_BLOCKED, ea)
                diff6 = float((b7_out[0] - b6_f).abs().max())
                print(f"parity blocked {what:38s} tile {tile}: B7 vs plain state {ef:.3e} "
                      f"(max abs {ea:.3e}), Sum|u| {et:.3e}; B7 - B6 max abs {diff6:.3e}")
                check(diff6 == 0.0, f"{what}: B7's state differs from B6's by {diff6}")
                check(torch.equal(own_f, b7_out[0]),
                      f"{what}: B7's state depends on the tile")
                check(torch.equal(b5_out[0], b7_out[0]) and torch.equal(b5_out[1], b7_out[1]),
                      f"B5 is not bit-equal to B7 ({what})")
                del ref, b6_f, b7_out, own_f, b5_out, g
            print(f"parity B5 == B7 bit for bit, B7 == B6 on the state, one launch per pass "
                  f"({nz}x{ny}x{nx} {dname}, K = 1..4 and a ghost window)")
            # three passes of run; B5 at its own tile, B7 at the same one
            k = b7.PREFERRED_K
            tile = b5.choose_config(nz, ny, nx, k, dtype, f.device)
            run_kw = dict(num_steps=3 * k, k_steps=k, accel_plane=nz - 2, **PHYSICS_3D)
            b7_f, b7_tot = b7.run(f, mask, tile=tile, **run_kw)
            g = f.clone()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            b5_f, b5_tot = b5.run(g, mask, **run_kw)
            torch.cuda.synchronize()
            extra_bytes = torch.cuda.max_memory_allocated() - before
            check(torch.equal(b5_f, b7_f) and torch.equal(b5_tot, b7_tot),
                  f"B5 run is not bit-equal to B7 run ({nz}x{ny}x{nx} {dname}, 3 passes of K={k})")
            check(b5_f.data_ptr() == g.data_ptr(), "B5 run did not stay in its input's storage")
            held = g.numel() * g.element_size() + mask.numel()
            print(f"parity B5 run == B7 run bit for bit ({nz}x{ny}x{nx} {dname}, 3 passes of "
                  f"K={k}, tile {tile}); memory B5 run: lattice + mask {held} B, allocated on "
                  f"top {extra_bytes} B, peak {(held + extra_bytes) / held:.4f} x"
                  + (" (bar 1.5 x)" if shape == SHAPE_BLOCKED else ""))
            if shape == SHAPE_BLOCKED:
                check(held + extra_bytes < 1.5 * held, f"B5 run allocated {extra_bytes} B on top")
            del b7_f, b5_f, g, f
    return abs_err


def phase_paths_blocked(torch):
    """B7 and B5 on both paths and B5's modes (experiments/cuda-kstep-tiles/
    sweep3d_blocked.py `check_paths`): at 32x256x256, at 12x16x32 (which
    wraps in every axis, with edge tiles in z) and at 13x50x70 (rows of 280
    bytes: the thread path in float32), K = 1..4, float32 and float64, at
    B5's tile and at a tile of the box path where B5's takes the thread
    path: each kernel on its chosen path bit-equal to the thread path, B5 to
    B7 and B7's state to B6's, both within the bar of `stepk_plain`; B5's
    stream_only and copy modes on either path bit-equal to their plain
    versions' state (copy's Sum|u| zeros). Both paths must run in each
    type."""
    harness = load_harness("sweep3d_blocked")
    seen = {}
    bad = harness.check_paths(log=lambda line: print(f"paths blocked {line}"), seen=seen)
    check(not bad, f"blocked kernels differ on: {bad}")
    for dname, paths in seen.items():
        check(paths == {"box", "thread"},
              f"the blocked kernels ran on {sorted(paths)} only in {dname}, not on both paths")
    print(f"paths blocked: every case held; paths {dict((d, sorted(p)) for d, p in seen.items())}")


def phase_timing_blocked(torch, mods3, modsb):
    """Time per pass of B7 and B5 at K = 1..3 beside B6 and B4 at the same
    shape and K, 32x256x256 float32, inside `run`; the plain version and the
    bound at the main path's K. Returns ({kernel: ms}, plain_ms, bound)."""
    from lbm_tpu_torch.core import state
    d3q19_kstep, d3q19_kstep_inplace = mods3
    b7, b5 = modsb
    nz, ny, nx = SHAPE_BLOCKED
    rng = np.random.default_rng(10)
    f, mask = state.to_torch3d(random_state_3d(rng, nz, ny, nx), random_mask_3d(rng, nz, ny, nx),
                               device="cuda", dtype=torch.float32)
    kw = dict(accel_plane=nz - 2, **PHYSICS_3D)
    passes = 100
    cells = nz * ny * nx
    # a pass reads the lattice and the mask once and writes the lattice and K
    # sums once, whatever K is
    k_main = b7.PREFERRED_K
    bytes_moved = (2 * 19 * 4 + 1) * cells + k_main * 4
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = FLOP_PER_CELL_STEP_3D * k_main * cells / F32_FLOP_PER_S * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    ms = {}
    for k in (1, 2, 3):
        row = {}
        paths = {}
        for name, mod in (("B7", b7), ("B5", b5), ("B6", d3q19_kstep), ("B4", d3q19_kstep_inplace)):
            g = f.clone()
            row[name] = time_ms(torch, lambda: mod.run(g, mask, num_steps=k * passes, k_steps=k,
                                                       **kw), 1) / passes
            paths[name] = getattr(mod, "last_path", None)
        print(f"timing blocked {nz}x{ny}x{nx} float32 K={k}: B7 {row['B7']:.4f} ms per pass "
              f"(tile {b7.choose_config(nz, ny, nx, k)}, {paths['B7']} path), B5 {row['B5']:.4f} "
              f"(tile {b5.choose_config(nz, ny, nx, k)}, {paths['B5']} path), B6 {row['B6']:.4f}, "
              f"B4 {row['B4']:.4f} "
              f"(K launches of a one-step kernel); bytes of a pass {bytes_moved / 1e6:.0f} MB, "
              f"{t_bytes:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s whatever K")
        if k == k_main:
            ms = {"d3q19_kstep_blocked": row["B7"], "d3q19_kstep_inplace_blocked": row["B5"]}
            ms_paths = {"d3q19_kstep_blocked": paths["B7"],
                        "d3q19_kstep_inplace_blocked": paths["B5"]}
    plain_ms = time_ms(torch, lambda: d3q19_kstep.stepk_plain(f, mask, k_steps=k_main, **kw), 5)
    for name, t in ms.items():
        print(f"timing {name:27s}: {t:.4f} ms per K={k_main} launch "
              f"({cells * k_main / t / 1e3:.0f} MLUPS, {ms_paths[name]} path), bound "
              f"{bound[0]:.4f} ms ({bound[1]}), plain version {plain_ms:.4f} ms")
    return ms, plain_ms, bound, ms_paths


def phase_main_path_blocked(torch, mods3, modsb):
    """The slice's main path. Returns {kernel: (launches, seconds, mlups)}."""
    from lbm_tpu_torch.cli import lbm3d as cli3
    from lbm_tpu_torch.core import io as lbm_io
    from lbm_tpu_torch.ops import d3q19
    d3q19_kstep, d3q19_kstep_inplace = mods3
    b7, b5 = modsb
    names = {d3q19_kstep: "d3q19_kstep", d3q19_kstep_inplace: "d3q19_kstep_inplace",
             b7: "d3q19_kstep_blocked", b5: "d3q19_kstep_inplace_blocked"}
    nz, ny, nx = SHAPE_BLOCKED
    results, avs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for engine_args, mod in ((["--engine", "cuda-inplace-blocked"], b5),
                                 (["--engine", "cuda-blocked"], b7), ([], None)):
            label = " ".join(engine_args) or "(default engine)"
            out = Path(tmp) / (engine_args[-1] if engine_args else "default")
            argv = ["--nz", str(nz), "--ny", str(ny), "--nx", str(nx), "-n", str(STEPS_3D),
                    "--dtype", "float32", "--out-dir", str(out), *engine_args]
            for m in names:
                m.launches = 0
            with CountCalls(d3q19, "collide_fields") as plain:
                rc, text = run_cli(cli3.main, argv)
            launched = {name: m.launches for m, name in names.items() if m.launches}
            print(f"blocked main path {label}:\n{text.rstrip()}")
            check(rc == 0, f"cli returned {rc}")
            check(plain.calls == 0, f"{label}: the plain engine ran {plain.calls} collisions")
            kind = re.search(r"^kernel:\s+(slab|blocked), (\d+) steps? per pass$", text, re.M)
            check(kind is not None, f"{label}: the CLI does not print the kind of kernel")
            if mod is None:
                # the kind pick_engine names for the in-place family
                picked = b5.pick_engine(nz, ny, nx, int(kind.group(2)), torch.float32, "cuda")[0]
                check(kind.group(1) == picked, f"{label}: ran {kind.group(1)}, not {picked}")
                mod = b5 if picked == "blocked" else d3q19_kstep_inplace
                print(f"blocked main path {label}: pick_engine chose the {picked} kind, kernel "
                      f"{names[mod]}")
            else:
                check(kind.group(1) == "blocked", f"{label}: the kind is {kind.group(1)}")
            kernel = names[mod]
            check(list(launched) == [kernel],
                  f"{label}: launched {launched}, not {kernel} alone")
            # warm-up run and timed run, one launch per K steps each
            check(launched[kernel] == 2 * STEPS_3D // int(kind.group(2)),
                  f"{label}: {launched[kernel]} launches for 2 x {STEPS_3D} steps at "
                  f"K={kind.group(2)}")
            seconds = float(re.search(r"Total compute time:\s+([0-9.eE+-]+)", text).group(1))
            mlups = float(re.search(r"MLUPS:\s+([0-9.eE+-]+)", text).group(1))
            print(f"blocked main path {kernel}: {launched[kernel]} launches, {seconds:.6f} s "
                  f"timed, {seconds / (launched[kernel] / 2) * 1e3:.4f} ms per launch in the "
                  f"timed run, {getattr(mod, 'last_path', None) or 'one-step'} path")
            print(f"blocked main path {label}: {mlups} MLUPS")
            if engine_args:
                results[kernel] = (launched[kernel], seconds, mlups)
            av = lbm_io.read_av_vels(out / "av_vels_3d.dat")
            check(av.shape == (STEPS_3D,) and np.isfinite(av).all(),
                  f"{label}: av_vels_3d.dat is malformed")
            avs[label] = av
    _, plain_av = d3q19.simulate(nz, ny, nx, num_steps=AV_VELS_PREFIX_3D, engine="torch",
                                 dtype=torch.float32, device="cuda", **PHYSICS_3D)
    plain_av = plain_av.cpu().numpy().astype(np.float64)
    for label, av in avs.items():
        err = float(np.max(np.abs(av[1:AV_VELS_PREFIX_3D] - plain_av[1:]) / np.abs(plain_av[1:])))
        print(f"av_vels[1:{AV_VELS_PREFIX_3D}] of {label} vs the plain engine on the card: "
              f"max rel err {err:.3e} (bar {AV_VELS_BAR})")
        check(err <= AV_VELS_BAR, f"{label}: av_vels prefix rel err {err} > {AV_VELS_BAR}")
    return results


def phase_golden_blocked(torch):
    """The 6000-step float64 oracle trace at 256x256 planes."""
    from lbm_tpu_torch.core import io as lbm_io
    from lbm_tpu_torch.ops import d3q19
    nz, ny, nx = GOLDEN_BLOCKED_SHAPE
    golden = lbm_io.read_av_vels(GOLDEN_BLOCKED)
    check(golden.shape == (6000,), f"golden trace has shape {golden.shape}")
    for engine in ("cuda-inplace-blocked", "cuda-blocked"):
        _, av = d3q19.simulate(nz, ny, nx, num_steps=6000, engine=engine, dtype=torch.float32,
                               device="cuda", **PHYSICS_3D)
        av = av.cpu().numpy().astype(np.float64)
        rel = np.abs(av[1:] - golden[1:]) / golden[1:]
        print(f"golden 8x256x256 x 6000 float32 --engine {engine}: max rel err {rel.max():.3e}, "
              f"final {rel[-1]:.3e} (bar {GOLDEN_3D_BAR_F32})")
        check(np.isfinite(rel).all() and rel.max() <= GOLDEN_3D_BAR_F32,
              f"{engine}: golden trace max rel err {rel.max()} > {GOLDEN_3D_BAR_F32}")
    _, av = d3q19.simulate(nz, ny, nx, num_steps=200, engine="cuda-blocked", dtype=torch.float64,
                           device="cuda", **PHYSICS_3D)
    av = av.cpu().numpy()
    rel = np.abs(av[1:] - golden[1:200]) / golden[1:200]
    print(f"golden 8x256x256 float64 --engine cuda-blocked, first 200 steps: max rel err "
          f"{rel.max():.3e} (bar {GOLDEN_3D_BAR_F64})")
    check(np.isfinite(rel).all() and rel.max() <= GOLDEN_3D_BAR_F64,
          f"float64 golden prefix max rel err {rel.max()} > {GOLDEN_3D_BAR_F64}")


def phase_checkpoint_blocked(torch, mods3, modsb):
    """A chunked and resumed run through B5 equals an uninterrupted one bit
    for bit. Returns B5's launches in the chunked and resumed runs."""
    from lbm_tpu_torch.cli import lbm3d as cli3
    from lbm_tpu_torch.ops import d3q19
    b7, b5 = modsb
    nz, ny, nx = SHAPE_BLOCKED
    n = CHECKPOINT_STEPS_BLOCKED
    with tempfile.TemporaryDirectory() as tmp:
        base = ["--nz", str(nz), "--ny", str(ny), "--nx", str(nx), "--out-dir", str(tmp),
                "--engine", "cuda-inplace-blocked", "--checkpoint-every", str(n // 2)]
        for m in (*mods3, *modsb):
            m.launches = 0
        for argv in (base + ["-n", str(n)], base + ["-n", str(2 * n), "--resume"]):
            rc, text = run_cli(cli3.main, argv)
            check(rc == 0, f"blocked checkpointed cli returned {rc}")
        launches = b5.launches
        check(launches > 0 and not any(m.launches for m in (*mods3, b7)),
              "the blocked checkpointed run did not go through B5 alone")
        ref_f, ref_av = d3q19.simulate(nz, ny, nx, num_steps=2 * n, engine="cuda-inplace-blocked",
                                       dtype=torch.float32, device="cuda", **PHYSICS_3D)
        with np.load(Path(tmp) / "checkpoint_3d.npz") as ck:
            check(int(ck["step"]) == 2 * n, "the blocked checkpoint does not record its step")
            check(np.array_equal(ck["av_vels"], ref_av.cpu().numpy().astype(np.float64)),
                  "blocked: resumed av_vels differ from the uninterrupted run")
            check(np.array_equal(ck["f"], ref_f.cpu().numpy()),
                  "blocked: resumed final state differs from the uninterrupted run")
    print(f"checkpoint 3-D 32x256x256 (B5, {launches} launches): {n} steps in chunks of "
          f"{n // 2}, resumed to {2 * n}: av_vels and final state equal the uninterrupted run "
          "bit for bit")
    return launches


def blur_case(rng, shape, inner, ring=False):
    """A padded image as bench.py makes it: uniform noise inside the
    interior box, zero outside. With `ring`, noise everywhere and a mask with
    holes, so that only a periodic kernel gives the periodic answer."""
    (c, h, w), (h0, w0) = shape, inner
    img = rng.random((c, h, w)).astype(np.float32)
    if ring:
        return img, (rng.random((h, w)) < 0.9).astype(np.float32)
    interior = np.zeros((h, w), np.float32)
    interior[1:1 + h0, 1:1 + w0] = 1
    return img * interior, interior


def host_blur8(img, interior):
    """Eight passes of the 9-point blur in float64 with numpy, zero outside
    (the oracle of the reference's blur benchmark)."""
    weights = np.array([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]) / 16.0
    x, inter = img.astype(np.float64), interior.astype(np.float64)
    for _ in range(8):
        ext = np.pad(x, ((0, 0), (1, 1), (1, 1)))
        x = sum(weights[i, j] * ext[:, i:i + x.shape[1], j:j + x.shape[2]]
                for i in range(3) for j in range(3)) * inter
    return x


def ulps_bf16(torch, a, b) -> int:
    """Largest distance of two bfloat16 tensors in units in the last place."""
    bits = [t.view(torch.int16).to(torch.int32) for t in (a, b)]
    return int((bits[0] - bits[1]).abs().max())


def hold_to_plain(torch, what, out, ref):
    """Kernel result against its plain version's: float32 bit-equal,
    bfloat16 within one unit in the last place. Returns the max abs error."""
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    if out.dtype == torch.float32:
        check(torch.equal(out, ref), f"{what}: not bit-equal to the plain version "
                                     f"(max abs err {err:.3e})")
    else:
        ulps = ulps_bf16(torch, out, ref)
        check(ulps <= 1, f"{what}: {ulps} bfloat16 units from the plain version")
    return err


def phase_blur_parity(torch, stencil):
    """Phase 8. Returns {kernel: max_abs_err} over the float32 cases."""
    rng = np.random.default_rng(20261018)
    cases = {"bricks": blur_case(rng, *BRICKS), "leaf": blur_case(rng, *LEAF),
             "ringed": blur_case(rng, (4, 320, 512), (0, 0), ring=True),
             "4096": blur_case(rng, *BIG)}
    abs_err = dict.fromkeys(KERNELS_BLUR, 0.0)
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for label, (img_np, int_np) in cases.items():
            x = torch.from_numpy(img_np).to("cuda", dtype)
            m = torch.from_numpy(int_np).to("cuda", dtype)
            outs = {"blur_step": [("", stencil.blur_step(x, m), stencil.blur_step_plain(x, m))],
                    "blur_k": [], "blur_resident": []}
            for k in (1, 2, 4, 8):
                ref = stencil.blur_k_plain(x, m, k_passes=k)
                for band in (16, 32):
                    outs["blur_k"].append((f" k={k} band={band}",
                                           stencil.blur_k(x, m, k_passes=k, band=band), ref))
            if stencil.resident_fits(x):
                for n in (8, 200):
                    outs["blur_resident"].append(
                        (f" passes={n}", stencil.blur_resident(x, m, num_passes=n),
                         stencil.blur_resident_plain(x, m, num_passes=n)))
            else:
                check(label in ("leaf", "4096"), f"resident_fits refuses the {label} shape")
                try:
                    stencil.blur_resident(x, m, num_passes=8)
                except ValueError as err:
                    check("engine='cuda'" in str(err), f"B8's refusal names no engine: {err}")
                    print(f"blur parity {label} {dname}: B8 raises as it must: {err}")
                else:
                    raise Failure(f"B8 took the {label} shape that resident_fits refuses")
            for name, results in outs.items():
                worst = 0.0
                for tag, out, ref in results:
                    worst = max(worst, hold_to_plain(torch, f"{name}{tag} {label} {dname}",
                                                     out, ref))
                    if label != "ringed":
                        check(bool((out * (1 - m) == 0).all()),
                              f"{name}{tag} {label} {dname}: the pad ring is not zero")
                if results:
                    print(f"blur parity {name:13s} {label:6s} {dname}: {len(results)} cases, "
                          f"max abs err vs plain {worst:.3e}"
                          + (" (bit-equal)" if dtype == torch.float32 else " (<= 1 ulp)"))
                if dtype == torch.float32:
                    abs_err[name] = max(abs_err[name], worst)
            del outs, x, m
    # eight passes of every engine against float64 on the host
    for label in ("bricks", "leaf"):
        img_np, int_np = cases[label]
        oracle = host_blur8(img_np, int_np)
        x, m = torch.from_numpy(img_np).cuda(), torch.from_numpy(int_np).cuda()
        engines = {"conv": dict(engine="conv"), "cuda (B10)": dict(engine="cuda"),
                   "cuda k=4 (B9)": dict(engine="cuda", k_passes=4),
                   "cuda k=8 (B9)": dict(engine="cuda", k_passes=8)}
        if stencil.resident_fits(x):
            engines["resident (B8)"] = dict(engine="resident")
        for name, kw in engines.items():
            out = stencil.blur_many(x, m, num_iters=4, **kw).cpu().numpy().astype(np.float64)
            err = float(np.abs(out - oracle).max())
            print(f"blur host oracle {label:6s} 8 passes, engine {name:13s}: max abs err "
                  f"{err:.3e} (bar {HOST_ORACLE_BAR})")
            check(np.isfinite(err) and err <= HOST_ORACLE_BAR,
                  f"engine {name} at the {label} shape: {err} > {HOST_ORACLE_BAR}")
    return abs_err


def seeded_rgba(seed, h, w):
    """An RGBA image of low frequencies plus noise, so that 200 passes leave
    structure in every channel."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    rgba = np.empty((h, w, 4), np.uint8)
    for c in range(4):
        fx, fy, gx, gy = rng.uniform(1.0, 4.0, 4).astype(np.float32)
        p, q = rng.uniform(0.0, 2 * np.pi, 2).astype(np.float32)
        v = (np.sin(2 * np.pi * (fx * x + fy * y) + p) + np.sin(2 * np.pi * (gx * x - gy * y) + q)
             + 0.5 * rng.standard_normal((h, w), dtype=np.float32))
        rgba[..., c] = np.round(255 * (v - v.min()) / (v.max() - v.min()))
    return rgba


class Capture:
    """Keeps what module.name returns while active."""

    def __init__(self, module, name):
        self.module, self.name, self.results = module, name, []
        self.original = getattr(module, name)

    def __enter__(self):
        def keeping(*args, **kwargs):
            self.results.append(self.original(*args, **kwargs))
            return self.results[-1]

        setattr(self.module, self.name, keeping)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)


def plain_float64_state(torch, img_lib, rgba, passes):
    """The padded state after `passes` separable blur passes in float64 on
    the card, and the shape of the interior."""
    fimg = img_lib.to_float_image(rgba)
    padded, interior, _ = img_lib.pad_to_tile(fimg.intensities, row_mult=32)
    x = torch.from_numpy(padded).to("cuda", torch.float64)
    mask = torch.from_numpy(interior).to("cuda", torch.float64)[None]
    for _ in range(passes):
        rows = torch.roll(x, 1, 1) + 2.0 * x + torch.roll(x, -1, 1)
        x = (torch.roll(rows, -1, 2) + 2.0 * rows + torch.roll(rows, 1, 2)) * (1.0 / 16.0) * mask
    return x.cpu().numpy()


def phase_blur_main_path(torch, stencil):
    """Phase 9. Returns {kernel: (launches of warm-up and timed run, timed
    seconds)} of the float32 run that goes through it."""
    from lbm_tpu_torch.cli import blur as cli
    from lbm_tpu_torch.models import blur as blur_model
    from lbm_tpu_torch.utils import image as img_lib

    try:
        import PIL  # noqa: F401
        png = True
    except ImportError:
        png = False
        print("blur main path: PIL does not import here, so the PNG leg of the CLI did NOT "
              "run; the arrays go through models.blur.run_blur instead")
    passes = 2 * BLUR_ITERS
    big, small = seeded_rgba(20261019, *BIG[1]), seeded_rgba(20261020, *BRICKS[1])
    # (image, flags, kernel, launches per run, engine line)
    runs = [
        ("big", ["--engine", "auto"], "blur_k", passes // 4, "cuda (k_passes 4)"),
        ("big", ["--engine", "cuda"], "blur_step", passes, "cuda"),
        ("big", ["--engine", "auto", "--data-type", "half"], "blur_k", passes // 4,
         "cuda (k_passes 4)"),
        ("small", ["--engine", "auto"], "blur_resident", 1, "resident"),
    ]
    images = {"big": big, "small": small}
    plains = ("blur_step_plain", "blur_k_plain", "blur_resident_plain", "blur_step_conv")
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if png:
            t0 = time.perf_counter()
            for name, rgba in images.items():
                img_lib.save_png(tmp / f"{name}.png", rgba)
            print(f"blur main path: wrote the {big.shape[1]}x{big.shape[0]} and "
                  f"{small.shape[1]}x{small.shape[0]} PNGs in {time.perf_counter() - t0:.1f} s")
        refs = {}
        for name, rgba in images.items():
            conv = blur_model.run_blur(rgba, num_iters=BLUR_ITERS, engine="conv", device="cuda")
            refs[name] = (conv.rgba, plain_float64_state(torch, img_lib, rgba, passes))
            print(f"blur main path: conv engine on the card, {name} image: "
                  f"{conv.compute_seconds:.6f} s for {passes} passes")
        for name, flags, kernel, per_run, engine_line in runs:
            half = "half" in flags
            label = f"{name} {' '.join(flags)}"
            for key in stencil.launches:
                stencil.launches[key] = 0
            counters = [CountCalls(stencil, plain) for plain in plains]
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                for counter in counters:
                    stack.enter_context(counter)
                captured = stack.enter_context(Capture(blur_model, "run_blur"))
                if png:
                    rc, text = run_cli(cli.main, ["-i", str(tmp / f"{name}.png"), "-o",
                                                  str(tmp / "out.png"), "-n", str(BLUR_ITERS),
                                                  *flags])
                    wall = time.perf_counter() - t0
                    check(rc == 0, f"blur cli returned {rc}")
                    out_rgba = img_lib.load_png(tmp / "out.png")
                    run = captured.results[0]
                    check(np.array_equal(out_rgba, run.rgba), f"{label}: the PNG differs from "
                                                              "the blurred array")
                else:
                    run = blur_model.run_blur(
                        images[name], num_iters=BLUR_ITERS, engine=flags[1],
                        dtype=torch.bfloat16 if half else torch.float32)
                    wall = time.perf_counter() - t0
                    out_rgba = run.rgba
                    fused = f" (k_passes {run.k_passes})" if run.k_passes else ""
                    text = (f"engine:\t{run.engine}{fused}\n{BLUR_ITERS}(x2) iterations took "
                            f"{run.compute_seconds:.6f}s")
            launched = dict(stencil.launches)
            print(f"blur main path {label}:\n{text.rstrip()}")
            check(re.search(rf"^engine:\t{re.escape(engine_line)}$", text, re.M) is not None,
                  f"{label}: the engine is not {engine_line}")
            check(f"{BLUR_ITERS}(x2) iterations took" in text, f"{label}: no timing line")
            # warm-up run and timed run, which are equal
            check(launched[kernel] == 2 * per_run,
                  f"{label}: {kernel} was launched {launched[kernel]} times, not 2 x {per_run}")
            check(sum(launched.values()) == launched[kernel],
                  f"{label}: another kernel was launched: {launched}")
            for counter in counters:
                check(counter.calls == 0, f"{label}: {counter.name} ran {counter.calls} times")
            seconds = run.compute_seconds
            print(f"blur main path {label}: {kernel} {launched[kernel]} launches, "
                  f"{seconds:.6f} s timed for {passes} passes, "
                  f"{seconds / passes * 1e3:.4f} ms per pass, "
                  f"{seconds / per_run * 1e3:.4f} ms per launch; the whole call took "
                  f"{wall:.2f} s on the host's clock (PNG in and out, normalisation, "
                  "warm-up run, copy back)")

            conv_rgba, state64 = refs[name]
            check(out_rgba.shape == images[name].shape and out_rgba.dtype == np.uint8,
                  f"{label}: output has shape {out_rgba.shape}")
            check(np.array_equal(out_rgba[..., 3], images[name][..., 3]),
                  f"{label}: the alpha channel was not restored")
            state_err = float(np.abs(run.state.astype(np.float64) - state64).max())
            check(np.isfinite(run.state).all(), f"{label}: the state is not finite")
            bar = STATE_BAR["bfloat16" if half else "float32"]
            levels = int(np.abs(out_rgba.astype(int) - conv_rgba.astype(int)).max())
            print(f"blur main path {label}: state vs float64 plain on the card max abs err "
                  f"{state_err:.3e} (bar {bar}); output vs the float32 conv engine: "
                  f"{levels} grey levels" + ("" if half else " (bar 1)"))
            check(state_err <= bar, f"{label}: state err {state_err} > {bar}")
            if half:
                # the same rounding points as B9's: bfloat16 once per 4 passes
                fimg = img_lib.to_float_image(images[name])
                padded, interior, (h, w) = img_lib.pad_to_tile(fimg.intensities, row_mult=32)
                x = torch.from_numpy(padded).to("cuda", torch.bfloat16)
                m = torch.from_numpy(interior).to("cuda", torch.bfloat16)
                for _ in range(passes // 4):
                    x = stencil.blur_k_plain(x, m, k_passes=4)
                chain = x.float().cpu().numpy()
                chain_err = float(np.abs(run.state - chain).max())
                print(f"blur main path {label}: state vs the plain bfloat16 chain max abs err "
                      f"{chain_err:.3e} (bar: one bfloat16 unit, 2^-8 below 1)")
                check(chain_err <= 2.0 ** -8, f"{label}: {chain_err} from the plain chain")
            else:
                check(levels <= 1, f"{label}: {levels} grey levels from the conv engine")
                results[kernel] = (launched[kernel], seconds)
    return results


def blur_bound(shape, itemsize, flop_per_value):
    """(ms, what binds) of a blur call on a (C, Hp, Wp) image: the bytes of
    one trip (image in, image out, mask: (2C + 1) Hp Wp values) at the memory
    rate against its operations at the float32 rate."""
    c, h, w = shape
    t_bytes = (2 * c + 1) * h * w * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = flop_per_value * c * h * w / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_blur_timing(torch, stencil):
    """Time per launch of each blur kernel at the main path's shapes, float32:
    B10 and B9 (k=4) at the padded 4096x4096 image, B8 at the padded bricks
    image for the main path's 200 passes, and per pass from two run lengths.
    Beside each: its plain version, and the library's convolution for the same
    passes (`blur_step_conv`: once for B10, k times for B9, 200 times for
    B8). Returns {kernel: dict of the numbers}."""
    rng = np.random.default_rng(9)
    passes = 2 * BLUR_ITERS
    out = {}
    img_np, int_np = blur_case(rng, *BIG)
    x, m = torch.from_numpy(img_np).cuda(), torch.from_numpy(int_np).cuda()
    conv_ms = time_ms(torch, lambda: stencil.blur_step_conv(x, m), 20)
    copy_ms = time_ms(torch, lambda: x.clone(), 20)
    print(f"timing at {BIG[0]}: one blur_step_conv {conv_ms:.4f} ms; a copy of the image "
          f"{copy_ms:.4f} ms ({2 * x.numel() * 4 / copy_ms / 1e6:.0f} GB/s)")
    bound = blur_bound(BIG[0], 4, FLOP_PER_VALUE_STEP)
    out["blur_step"] = dict(
        ms=time_ms(torch, lambda: stencil.blur_step(x, m), 50),
        plain_ms=time_ms(torch, lambda: stencil.blur_step_plain(x, m), 5),
        library_ms=conv_ms, bound=bound, shape=list(BIG[0]))
    k = 4
    bound = blur_bound(BIG[0], 4, k * FLOP_PER_VALUE_SEPARABLE)
    out["blur_k"] = dict(
        ms=time_ms(torch, lambda: stencil.blur_k(x, m, k_passes=k), 50),
        plain_ms=time_ms(torch, lambda: stencil.blur_k_plain(x, m, k_passes=k), 5),
        library_ms=k * conv_ms, bound=bound, shape=list(BIG[0]), k_passes=k,
        tile=list(stencil.DEFAULT_TILE))
    del x, m

    # B8 at what pad_to_tile(row_mult=32) makes of the 302x499 image
    shape = (4, 320, 512)
    img_np, int_np = blur_case(rng, shape, BRICKS[1])
    x, m = torch.from_numpy(img_np).cuda(), torch.from_numpy(int_np).cuda()
    long_run = passes + 2000
    t_short = time_ms(torch, lambda: stencil.blur_resident(x, m, num_passes=passes), 20)
    t_long = time_ms(torch, lambda: stencil.blur_resident(x, m, num_passes=long_run), 5)

    def conv_run():
        y = x
        for _ in range(passes):
            y = stencil.blur_step_conv(y, m)

    bound = blur_bound(shape, 4, passes * FLOP_PER_VALUE_SEPARABLE)
    out["blur_resident"] = dict(
        ms=t_short,
        plain_ms=time_ms(torch, lambda: stencil.blur_resident_plain(x, m, num_passes=passes), 3),
        library_ms=time_ms(torch, conv_run, 3), bound=bound, shape=list(shape), passes=passes,
        us_per_pass=(t_long - t_short) / (long_run - passes) * 1e3,
        tile=list(stencil.resident_tiling(*shape, *stencil.device_limits(x.device))))
    for name, t in out.items():
        extra = (f", {t['us_per_pass']:.3f} us per pass from runs of {passes} and {long_run}"
                 if name == "blur_resident" else "")
        print(f"timing {name:13s} at {tuple(t['shape'])}: {t['ms']:.4f} ms per launch{extra}, "
              f"bound {t['bound'][0]:.5f} ms ({t['bound'][1]}), plain version "
              f"{t['plain_ms']:.4f} ms, library (blur_step_conv for the same passes) "
              f"{t['library_ms']:.4f} ms")
    return out



def phase_overlap(torch, overlap_probe, card):
    """Kernel B11, the overlap probes (experiments/cuda-kstep-tiles/
    overlap_probe.py): every engine of the harness against its plain version
    bit for bit at 256x256 (bands 32 and 64, R = 0 and 2; the manual engines
    also against auto) and at 4096^2, band 64, R = 16 (smem totals too);
    then the main path, the harness's sweep of every engine at 4096^2, band
    64, 200 iterations, R in {0, 16, 64} and `copy_` at R = 0, with its
    bounds and overlap fractions. Returns the numbers of the kernels line."""
    harness = load_harness("overlap_probe")
    n, band, iters, rounds_list = OVERLAP_SIZE, OVERLAP_BAND, OVERLAP_ITERS, OVERLAP_ROUNDS
    try:
        held, refused = harness.canary(harness.ENGINES)
        print(f"overlap canary: {held} cases at {harness.CANARY}x{harness.CANARY} bit-equal to "
              "the plain versions (smem totals too; manual == auto); refused to build, too few "
              f"bands (as probe.py): {refused or 'none'}")
        held = load_harness("ab_copy").auto_values_parity(
            torch, overlap_probe, log=lambda line: print(f"overlap {line}"))
        print(f"overlap: {held} cases of the auto instances' one-value path bit-equal")
        # the strided manual engines: one TMA box a stage against bulk copies
        held = harness.check_box_paths(cases=harness.PATH_CASES + ((n, n, band),),
                                       rounds_list=(0, 16),
                                       log=lambda line: print(f"overlap paths {line}"))
        print(f"overlap: {held} cases of the strided manual engines, box path == bulk path == "
              "plain bit for bit")
        max_err = harness.check_full(harness.ENGINES, n, band, 16,
                                     log=lambda line: print(f"overlap {line}"))
    except RuntimeError as err:
        raise Failure(f"B11: {err}") from err
    print(f"overlap: every kernel engine at {n}^2, band {band}, R=16 bit-equal to its plain "
          "version")
    f = torch.from_numpy(np.random.default_rng(11).random((9, n, n), dtype=np.float32)).cuda()
    plain = {r: overlap_probe.build_auto(n, n, band, r) for r in (0, 16)}
    plain_ms = {r: time_ms(torch, lambda: p.plain(f), 3) for r, p in plain.items()}
    del f

    launches, rows = {}, []
    overlap_probe.launches = 0
    for name in harness.ENGINES:
        before = overlap_probe.launches
        rows += harness.sweep([name], n, band, iters, rounds_list, card, library=False,
                              log=lambda line: print(f"overlap {line}"))
        launches[name] = overlap_probe.launches - before
    rows += harness.sweep([], n, band, iters, [0], card, log=lambda line: print(f"overlap {line}"))
    total_launches = overlap_probe.launches
    missing = [k for k, v in launches.items() if k != "torch" and v == 0]
    check(not missing and launches["torch"] == 0,
          f"B11: the sweep did not launch every instance: {launches}")
    per_round = harness.us_per_round(harness.ENGINES, n, band)
    harness.add_overlap(rows, per_round)
    print(f"overlap arithmetic a round (slope R = {harness.SLOPE_ROUNDS}): "
          + ", ".join(f"{e} {c:.3f} us" for e, c in per_round.items()))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "overlap.csv"
        harness.write_csv(rows, path)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            overlap_probe.analyze(path)
    for line in buf.getvalue().splitlines():
        print(f"overlap analyze {line}")
    for r in rows:
        if r["overlap"] != "":
            print(f"overlap {r['engine']:23s} R={r['rounds']:<3d} wall {r['us_per_iter']} us, "
                  f"bound {r['bound_us']} us ({r['bound_by']}), arithmetic ~{r['compute_us']} us, "
                  f"overlap {r['overlap']:+.3f}")
    print(f"overlap sweep launches: {launches} (total {total_launches})")
    wall = {(r["engine"], r["rounds"]): r["us_per_iter"] / 1e3 for r in rows}
    blocks = {r["engine"]: r["blocks_per_sm"] for r in rows if r["blocks_per_sm"] != ""}
    paths = {r["engine"]: r["path"] for r in rows if r["path"]}
    bound = {r: harness.bound_us("auto", n, n, r) for r in (0, 16)}
    return dict(
        launches=total_launches, launches_by_engine=launches, max_abs_err=max_err,
        ms=wall[("auto", 0)], plain_ms=plain_ms[0], library_ms=wall[("copy_", 0)],
        bound_ms=bound[0][0] / 1e3, bound_by=bound[0][1],
        ms_by_engine={e: {str(r): wall[(e, r)] for r in (0, 16)} for e in OVERLAP_REPORTED},
        plain_ms_r16=plain_ms[16], bound_ms_r16=bound[16][0] / 1e3, bound_by_r16=bound[16][1],
        blocks_per_sm=blocks, paths=paths,
        us_per_round={e: per_round[e] for e in OVERLAP_REPORTED},
        overlap={f"{r['engine']} R={r['rounds']}": r["overlap"] for r in rows
                 if r["overlap"] != "" and r["engine"] in OVERLAP_REPORTED})


def phase_blur_resident_opt(torch, bro, stencil, card):
    """Kernel B13, the resident-blur variants (experiments/cuda-kstep-tiles/
    blur_resident_opt.py): every variant against its plain version bit for
    bit at bricks and a small odd shape (passes 0, 2, 7, 200; float32 and
    bfloat16 I/O) and at leaf where it fits (2, 200), v0 and v1 against B8;
    the variants that do not fit leaf must refuse it, naming the bytes a
    block would need; then the main path, the harness's sweep of all eight
    at bricks and leaf (bfloat16, as run.py's main), each variant launched.
    Returns the numbers of the kernels line."""
    harness = load_harness("blur_resident_opt")
    print(f"B13 on {card}")
    try:
        max_err = harness.check_parity(log=lambda line: print(f"B13 {line}"))
        harness.check_reuse(log=lambda line: print(f"B13 {line}"))
    except RuntimeError as err:
        raise Failure(f"B13: {err}") from err
    shape, hw0 = harness.IMAGES["leaf"]
    img_np, _ = harness.study_case(shape, hw0)
    x = torch.from_numpy(img_np).to("cuda", torch.bfloat16)
    fit_leaf = []
    for variant in bro.VARIANTS:
        if harness.fits(variant, shape):
            fit_leaf.append(variant)
            continue
        try:
            bro.build(variant, x, hw0)
        except ValueError as err:
            check(" B of shared memory a block" in str(err), f"B13's refusal names no bytes: {err}")
            print(f"B13 {variant} refuses leaf as it must: {err}")
        else:
            raise Failure(f"B13 {variant} took leaf, whose tiles do not fit")
    print(f"B13 variants that fit leaf on this card: {fit_leaf}")
    del x

    for variant in bro.launches:
        bro.launches[variant] = 0
    rows = harness.sweep(list(harness.IMAGES), bro.VARIANTS, harness.REPEATS, card,
                         log=lambda line: print(f"B13 {line}"))
    launches = dict(bro.launches)
    check(all(launches.values()), f"B13: the sweep did not launch every variant: {launches}")
    print(f"B13 sweep launches: {launches}")

    # one launch of n_lo passes of v0 at bricks beside its plain version, the
    # library's passes and its bound
    shape, hw0 = harness.IMAGES["bricks"]
    img_np, int_np = harness.study_case(shape, hw0)
    call, x, m = harness.prepare("v0-roll", img_np, int_np, hw0, torch.bfloat16)
    n = harness.N_LO

    def conv_run():
        y = x
        for _ in range(n):
            y = stencil.blur_step_conv(y, m)

    plain_ms = time_ms(torch, lambda: call.plain(n, x, m), 1)
    library_ms = time_ms(torch, conv_run, 1)
    bound_ms, bound_by = harness.run_bound_ms("v0-roll", shape, n, 2)
    # an exchange every pass against one every `depth` passes
    by_depth = {}
    for depth in (1, call.depth):
        one, x1, m1 = harness.prepare("v0-roll", img_np, int_np, hw0, torch.bfloat16, depth=depth)
        by_depth[depth] = harness.time_variant(one, x1, m1, n, harness.n_hi(x1.numel()), 3)[0]
        print(f"B13 v0-roll bricks at depth {depth}: {by_depth[depth]:.4f} us a pass")
    by_key = {(r["image"], r["variant"]): r for r in rows}
    v0 = by_key[("bricks", "v0-roll")]
    # the device time of every launch of the sweep, beside the sum of their
    # bounds: the launches run 2,000 to 30,910 passes, so `ms` (one launch of
    # 2,000) times `launches` undercounts the path
    ran = [r for r in rows if r["fits"]]
    main_path_ms = sum(r["sweep_ms"] for r in ran)
    main_path_bound_ms = sum(r["sweep_bound_ms"] for r in ran)
    print(f"B13 sweep: {main_path_ms:.3f} ms of device time in {sum(launches.values())} "
          f"launches, their bounds {main_path_bound_ms:.3f} ms")
    return dict(
        launches=sum(launches.values()), launches_by_variant=launches, max_abs_err=max_err,
        main_path_ms=main_path_ms, main_path_bound_ms=main_path_bound_ms,
        ms=v0["lo_ms"], plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
        bound_by=bound_by, passes_a_launch=n,
        us_per_pass={v: {img: (by_key[(img, v)]["us_per_pass"] if by_key[(img, v)]["fits"]
                               else "does not fit") for img in harness.IMAGES}
                     for v in bro.VARIANTS},
        bound_us_per_pass={v: {img: by_key[(img, v)]["bound_us"] for img in harness.IMAGES}
                           for v in bro.VARIANTS},
        plain_us_per_pass={v: {img: by_key[(img, v)]["plain_us"] for img in harness.IMAGES}
                           for v in bro.VARIANTS},
        library_us_per_pass={img: by_key[(img, "v0-roll")]["library_us"]
                             for img in harness.IMAGES},
        fits_leaf=fit_leaf, v0_bricks_us_per_pass_by_depth=by_depth,
        depth={v: {img: by_key[(img, v)]["depth"] for img in harness.IMAGES}
               for v in bro.VARIANTS},
        block_bytes={v: {img: by_key[(img, v)]["block_bytes"] for img in harness.IMAGES}
                     for v in bro.VARIANTS})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (REPO / "lbm_tpu_torch").is_dir() or not all(
            p.exists() for p in (GOLDEN, GOLDEN_3D, GOLDEN_BLOCKED)):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from lbm_tpu_torch.ops import (_build, copy_floor, d2q9_kstep, d2q9_kstep_inplace,
                                   d2q9_kstep_manual, d3q19_kstep, d3q19_kstep_blocked,
                                   d3q19_kstep_inplace, d3q19_kstep_inplace_blocked,
                                   overlap_probe, stencil)
    from lbm_tpu_torch.ops import blur_resident_opt
    mods = (d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual)
    mods3 = (d3q19_kstep, d3q19_kstep_inplace)
    modsb = (d3q19_kstep_blocked, d3q19_kstep_inplace_blocked)

    try:
        card = card_line()
        print(card)
        t0 = time.perf_counter()
        for name, lib_path in _build.build_all().items():
            _build.load(name)
            print(f"built {lib_path.relative_to(REPO)}")
        print(f"built and loaded the kernels in {time.perf_counter() - t0:.1f} s")
        phase_ptxas(torch, d2q9_kstep, d2q9_kstep_manual)

        th, tw, k_main = d2q9_kstep.choose_config(N, N, torch.float32)
        print(f"choose_config(1024, 1024, float32) = tile {th}x{tw}, K={k_main}")
        abs_err = phase_parity(torch, mods, k_main)
        phase_narrow_tiles(torch, mods, k_main)
        copy_err = phase_modes(torch, mods, copy_floor)
        ms, plain_ms, bound, copy, occupancy = phase_timing(torch, mods, k_main, copy_floor)
        t0 = time.perf_counter()
        golden, mask = load_golden()
        print(f"loaded {GOLDEN.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s")
        flagship, picked = phase_main_path(torch, mods, golden, mask)
        paths_4096 = phase_4096(torch, mods)
        phase_any_width(torch, mods)
        bd_launches, bd_steps, bd_floor = phase_breakdown_path(torch, mods, copy_floor, k_main)

        k3 = d3q19_kstep_inplace.choose_k(STEPS_3D)
        block3 = d3q19_kstep.choose_block(SHAPE_3D[2])
        print(f"3-D: choose_k({STEPS_3D}) = {k3}, choose_block({SHAPE_3D[2]}) = {block3}")
        abs_err3 = phase_parity_3d(torch, mods3, k3)
        ms3, plain_ms3, bound3 = phase_timing_3d(torch, mods3, k3)
        paths3 = phase_main_path_3d(torch, mods3)
        phase_golden_3d(torch)
        ck_launches = phase_checkpoint(torch, mods, mods3, mask)

        abs_err_b = phase_parity_blocked(torch, mods3, modsb)
        phase_paths_blocked(torch)
        ms_b, plain_ms_b, bound_b, paths_ms_b = phase_timing_blocked(torch, mods3, modsb)
        paths_b = phase_main_path_blocked(torch, mods3, modsb)
        phase_golden_blocked(torch)
        ck_launches["d3q19_kstep_inplace_blocked"] = phase_checkpoint_blocked(torch, mods3, modsb)

        abs_err_blur = phase_blur_parity(torch, stencil)
        times_blur = phase_blur_timing(torch, stencil)
        paths_blur = phase_blur_main_path(torch, stencil)

        overlap = phase_overlap(torch, overlap_probe, card)
        resident_opt = phase_blur_resident_opt(torch, blur_resident_opt, stencil, card)
    except Failure as err:
        print(f"chip_smoke FAILED: {err}", file=sys.stderr)
        return 1

    # each 2-D kernel's main-path run: `auto` for the kernel it picked, else
    # its engine by name (the other flagship runs are listed beside it)
    engine_of = {mod.__name__.rsplit(".", 1)[1]: engine
                 for engine, mod in engine_modules(mods).items()}
    main_engine = {name: "auto" if engine == picked else engine
                   for name, engine in engine_of.items()}
    kernels = [{
        "name": name, "route": "cuda",
        "source": ("lbm_tpu_torch/csrc/d2q9_manual.cu" if name == "d2q9_kstep_manual"
                   else "lbm_tpu_torch/csrc/d2q9_kstep.cu"),
        "replaces": replaces, "launches": flagship[main_engine[name]][0], "parity": "ok",
        "max_abs_err": abs_err[name], "ms": ms[name], "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
        "k_steps": k_main, "tile": [th, tw], "main_path": f"--engine {main_engine[name]}",
        "flagship_seconds": flagship[main_engine[name]][1],
        "flagship_mlups": flagship[main_engine[name]][2],
        "flagship_mlups_by_engine": {
            e: flagship[e][2] for e in {main_engine[name], engine_of[name]}},
        "checkpoint_launches": ck_launches.get(engine_of[name], 0)
                               + (ck_launches.get("auto", 0) if engine_of[name] == picked else 0),
        "mlups_4096": paths_4096[name][2], "breakdown_launches": bd_launches[name],
        "breakdown_us_per_step": bd_steps[{"d2q9_kstep": "B2", "d2q9_kstep_inplace": "B1",
                                           "d2q9_kstep_manual": "B3"}[name]],
        "path": flagship[main_engine[name]][3],
        **({"grid": occupancy} if name == "d2q9_kstep_manual" else {}),
    } for name, replaces in KERNELS.items()]
    kernels.append({
        "name": "copy_floor", "route": "cuda", "source": "lbm_tpu_torch/csrc/copy_floor.cu",
        "replaces": KERNEL_COPY_FLOOR, "launches": bd_launches["copy_floor"],
        "main_path": "the 2-D time-breakdown path (breakdown2d.py, copy_floor2d.py) at 1024^2",
        "parity": "ok", "max_abs_err": copy_err, "ms": copy["ms"], "plain_ms": copy["plain_ms"],
        "bound_ms": copy["bound"][0], "bound_by": copy["bound"][1],
        "library_ms": copy["library_ms"], "block": copy["block"], "path": copy["path"],
        "chunk": copy["chunk"], "stages": copy["stages"], "blocks_per_sm": copy["blocks_per_sm"],
        "host_enqueue_us": copy["host_enqueue_us"], "floor_us_per_pass": bd_floor})
    kernels += [{
        "name": name, "route": "cuda", "source": "lbm_tpu_torch/csrc/d3q19_kstep.cu",
        "replaces": replaces, "launches": paths3[name][0], "parity": "ok",
        "max_abs_err": abs_err3[name], "ms": ms3[name], "plain_ms": plain_ms3,
        "bound_ms": bound3[0], "bound_by": bound3[1], "library_ms": None,
        "k_steps": k3, "block": list(block3), "main_path_seconds": paths3[name][1],
        "main_path_mlups": paths3[name][2],
        "checkpoint_launches": ck_launches.get(name, 0),
    } for name, replaces in KERNELS_3D.items()]
    kernels += [{
        "name": name, "route": "cuda", "source": "lbm_tpu_torch/csrc/d3q19_blocked.cu",
        "replaces": replaces, "launches": paths_b[name][0], "parity": "ok",
        "max_abs_err": abs_err_b[name], "ms": ms_b[name], "plain_ms": plain_ms_b,
        "bound_ms": bound_b[0], "bound_by": bound_b[1], "library_ms": None,
        "k_steps": d3q19_kstep_blocked.PREFERRED_K,
        "tile": list(sys.modules[f"lbm_tpu_torch.ops.{name}"].choose_config(
            *SHAPE_BLOCKED, d3q19_kstep_blocked.PREFERRED_K)),
        "main_path_seconds": paths_b[name][1], "main_path_mlups": paths_b[name][2],
        "checkpoint_launches": ck_launches.get(name, 0), "path": paths_ms_b[name],
    } for name, replaces in KERNELS_3D_BLOCKED.items()]
    for name, replaces in KERNELS_BLUR.items():
        t = dict(times_blur[name])
        bound_ms, bound_by = t.pop("bound")
        kernels.append({
            "name": name, "route": "cuda", "source": "lbm_tpu_torch/csrc/stencil.cu",
            "replaces": replaces, "launches": paths_blur[name][0], "parity": "ok",
            "max_abs_err": abs_err_blur[name], "bound_ms": bound_ms, "bound_by": bound_by,
            "main_path_seconds": paths_blur[name][1], **t})
    kernels.append({
        "name": "overlap_probe", "route": "cuda", "source": "lbm_tpu_torch/csrc/overlap_probe.cu",
        "replaces": KERNEL_OVERLAP, "replaces_functions": OVERLAP_FUNCTIONS,
        "main_path": (f"experiments/cuda-kstep-tiles/overlap_probe.py: every engine at "
                      f"{OVERLAP_SIZE}^2, band {OVERLAP_BAND}, {OVERLAP_ITERS} iterations, "
                      f"R in {OVERLAP_ROUNDS}; ms, plain_ms, bound_ms and library_ms (copy_) "
                      "are auto's at R = 0"),
        "parity": "ok", **overlap})
    kernels.append({
        "name": "blur_resident_opt", "route": "cuda",
        "source": "lbm_tpu_torch/csrc/blur_resident_opt.cu", "replaces": KERNEL_BLUR_RESIDENT_OPT,
        "replaces_functions": [f"v{i}_kernel" for i in range(8)],
        "main_path": ("experiments/cuda-kstep-tiles/blur_resident_opt.py: the eight variants at "
                      "bricks and leaf, bfloat16; ms, plain_ms, library_ms and bound_ms are one "
                      f"launch of {resident_opt['passes_a_launch']} passes of v0-roll at bricks"),
        "parity": "ok", **resident_opt})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
