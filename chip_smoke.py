#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (lbm_tpu_torch) runs on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. prints the card's name and power limit; builds the CUDA kernels from
     the eight sources of lbm_tpu_torch/csrc/ with nvcc, and the per_speed
     variant of the two 3-D sources (one process per library, all started
     together) and prints the build time; prints what
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
     (d3q19_kstep_inplace) at K = 1..4, float64 and float32, on the full
     window and a ghost window (plane_offset, valid planes and rows strictly
     inside, global_nz != nz), each on both paths (wave: one launch a pass,
     a z-wavefront through L2; step: a launch a step): the wave path's state
     and Sum|u| bit-equal to the step path's, B4 bit-equal to B6 on each
     path, the path `choose_path` gives within the bar of the plain
     version; also over three passes of `run`. B4 must leave its result in
     the input's storage, a B4 `run` must peak under 1.5 x (lattice + mask)
     of device memory, and B6's `run` prints what it allocates on top of
     the lattice;
     Then the wave path on small grids, at other plans and in B6's modes
     (experiments/cuda-kstep-tiles/wave3d.py `check_paths`);
  5. the 3-D main path: `lbm_tpu_torch.cli.lbm3d --nz 64 --ny 128 --nx 256
     -n 1200` in float32 with no --engine (must launch B4 and never the
     plain engine) and with `--engine cuda` (B6), each on the path
     `choose_path` gives its K; av_vels[1:24] against the plain engine on
     the card (4e-4);
  6. golden: 16x64x128 x 6000 steps against
     experiments/d3q19-drift/d3q19_16x64x128_6000.av_vels.dat, float32
     through both engines (max relative error over all steps <= 1.5e-3) and
     float64 through `cuda` (first 200 steps <= 1e-10);
  7. checkpoint/resume on the card, 2-D (1024^2: `--engine cuda-inplace`
     (B1), `cuda-manual` (B3) and `auto`) and 3-D
     (64x128x256, B4): N steps with --checkpoint-every N/2, then 2N with
     --resume; av_vels and the final state must equal an uninterrupted 2N run
     bit for bit;
  7c. the multi-device paths (lbm_tpu_torch/parallel/) at world size 1, in
     a NCCL process group this script sets up on cuda:0 (file:// rendezvous)
     and destroys after: the flagship through `cli.lbm --engine sharded-cuda
     --num-devices 1` (kernel B1 on the (9, 1040, 1024) ghost-extended
     block, on the box path), then with `--overlap`, each through the golden
     gate, the final state bit-equal to an `--engine cuda-inplace` run and
     av_vels within 1e-6 of it, never the plain engine; the same run with B2
     as the local engine (`kstep_sharded.simulate(local_engine='two-stream')`),
     bit-equal; a chunk split into its exchange, B1's snapshot refresh and
     pass, the host's time a chunk and the all-reduce; `--engine sharded`
     with each halo strategy for 1,000 steps (through
     `models.lbm.run_simulation_sharded`), the state bit-equal to the torch
     engine's; `cli.blur --engine conv-sharded --num-devices 1` on the seeded
     4096x4096 PNG x 200 passes, bit-equal to the conv engine. MLUPS of
     sharded-cuda beside cuda-inplace's, and the path of the extended block;
  7d. the 3-D multi-device paths in the same NCCL group: `cli.lbm3d --engine
     sharded-cuda --num-devices 1` at 64x128x256 and 32x256x256 x 1200
     steps (kernel B4 on the ghost-extended slab, shard 0's plane_offset
     -K), and at 64x128x256 `--overlap` and `--engine sharded-cuda-zy
     --mesh-shape 1 1`, each beside `--engine cuda-inplace` in the same call:
     the final state bit-equal to it, av_vels within 1e-5, B4 alone
     launched, never the plain engine; B6 as the local kernel
     (`run_simulation_sharded(local_engine='two-stream')`), bit-equal; a
     chunk split into B4's pass, the exchange and the rest, device and host,
     beside B4's pass on the lattice; a checkpointed sharded-cuda run
     resumed, bit-equal to an uninterrupted one; the plain `sharded` engine
     at 16x64x128 bit-equal to the torch engine. Each run's MLUPS and path;
  7e. the host-side and tooling modules: the flagship, 200 steps, through
     `cli.lbm --engine auto --trace-dir` (a torch.profiler trace with CUDA
     activity: B2's kernel named with 50 launches in the timed run, their
     summed device time beside the run's CUDA-event time, the device's idle
     share in the run's window; no device event fails the phase, naming
     CUPTI); `--debug-nans` on `auto` (B2) and `cuda-inplace` (B1), the
     state bit-equal to the run without it and its cost a launch, and a
     seeded NaN raising FloatingPointError on B2's first pass;
     `--compile-only --export` on the card and `cli.lbm_runner` on the
     exported step (outputs bit-equal to `--engine torch`, av_vels within
     4e-4 of auto's, MLUPS); `--engine native` in float64 at 256x256 x 1,000
     steps against `--engine cuda` (1e-12, MLUPS on the host); the native
     writer's final_state.dat byte-identical to the Python writer's; then,
     in the NCCL group of one, `cli.halo_bench` at 1024^2 x 200 steps, every
     strategy;
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
     Time per pass of B5 and B7 at K = 1..3 beside B4 and B6 on each of
     their paths at K = 1..4, with the path each took. The main path
     `cli.lbm3d --nz 32 --ny 256 --nx 256 -n 1200` with
     `--engine cuda-inplace-blocked` (B5 alone), `--engine cuda-blocked` (B7
     alone), no --engine and `--engine cuda` (the slab kind: B4 and B6 on
     the path `choose_path` gives), av_vels[1:24]
     against the plain engine (4e-4). Golden 8x256x256 x 6000 against
     experiments/d3q19-drift/d3q19_8x256x256_6000.av_vels.dat (float32 both
     blocked engines <= 1.5e-3; float64 `cuda-blocked`, 200 steps, <= 1e-10).
     Checkpoint/resume through `cuda-inplace-blocked`, bit-equal to an
     uninterrupted run;
  7f. bfloat16 storage (A3) and the A9 switches: B1, B2 and B3 on a
     bfloat16 state at 1024^2 (K = 1, 2, 4, 8) and 64x1001 (K = 4) against
     `stepk_plain` on the card, every value within one unit (the share that
     differs printed), Sum|u| (float32) within 1e-5, B1 == B2 == B3, each on
     the thread path; B2 with shared_reciprocal in float32 (box and thread
     path, 1e-5) and bfloat16; each one's ms a bfloat16 pass beside
     float32's in the same call and the bound (37 B a cell). The flagship
     through `cli.lbm --engine auto --dtype bfloat16` (its kernel alone,
     never the plain engine; MLUPS beside float32's; av_vels[:100] against
     `run_plain` on the card within 1e-4); checkpointed bfloat16 runs
     through auto, cuda-inplace and cuda-manual resumed, the lattice (|V2),
     av_vels and final_state.dat equal to the whole run's. B4, B5, B6 and
     B7 at 64x128x256 and 32x256x256 (K = 1..4; B5, B7 to 2) against
     `stepk_plain` (one unit; the line says whether bit-equal), B4 == B6
     and B5 == B7; B4's memory on top of a bfloat16 lattice;
     `ops.d3q19.simulate(dtype=torch.bfloat16)` through each 3-D engine
     (its kernel alone); a checkpointed bfloat16 run through B4 resumed, bit
     for bit; each one's ms a pass beside float32's and the bound (77 B a
     cell), and B4's on both its paths at 64x128x256 K = 4 (one wave launch
     a pass, four step launches), three passes' state and Sum|u| bit-equal.
     Last, in a child process with LBM_D3Q19_GROUPING=reference (the
     per_speed libraries, built with the others), B4-B7 in float32 against
     the plain per-speed step (1e-5) and unequal to the paired grouping;
  7g. B6's layouts (A9): `d3q19_kstep.stepk` with layout='zmajor' and
     'fused' at 64x128x256 K = 1..4 and 32x256x256 K = 2 in float32 on the
     wave and step paths, at 8x32x64 K = 1..4 in float64 and at
     64x128x256 K = 4 in bfloat16 (step path): each pass bit-equal to the
     q-major pass once transposed (state and Sum|u|) and held to its plain
     version (`stepk_plain(layout=)`: 1e-5, 1e-12, one bf16 unit); the
     modes on z-major bit-equal to q-major's and held to the plain modes;
     `run` in each layout bit-equal to q-major's; ms a pass in each layout
     beside q-major in the same call (turns q, z, fused, fused, z, q);
  7h. bfloat16 on the multi-device engines (A3), world size 1, NCCL: the
     flagship through `run_simulation_sharded(engine='sharded-cuda',
     dtype=torch.bfloat16)` x 10,000, `overlap=True` and B2 local x 2,000,
     the plain `sharded` engine (ppermute) at 256x256 x 200, a checkpointed
     `sharded-cuda` run resumed; 3-D `sharded-cuda` at 64x128x256 x 1,200,
     overlap, `sharded-cuda-zy` on a (1, 1) mesh and a checkpointed z-mesh
     run resumed. Each state bit-equal to the single-device bfloat16 run of
     the same local kernel (`cuda-inplace`, B1 and B4; the torch engine for
     the plain engine), av_vels within 1e-5 (the plain engine two bf16
     units), the run's kernel alone launched and never the plain engine;
     resumes bit for bit; MLUPS beside the single-device engine's and a
     chunk's device and host ms;
  8. blur kernels vs plain version, from numpy-seeded images: B10
     (stencil.blur_step) one pass, B9 (blur_k) at k = 1..8 and bands of 64
     and 100 rows (100 divides none of the heights) on its vector path, and
     on its thread path at 4x40x250 float32 and 4x40x252 bfloat16, whose rows
     are not whole 16-byte pieces (the path of each launch printed), B8
     (blur_resident) at 8 and 200 passes; float32 (bit-equal) and
     bfloat16 (one unit in the last place); at the bricks shape 4x304x512,
     the leaf shape 4x1032x896 (beyond what B8 holds on an H100: there it
     must raise and name the 'cuda' engine), an image whose ring is not zero,
     and B9/B10 at 4096x4096 (padded 4x4128x4224). The pad ring of every
     output is exactly zero. Eight passes of each engine are held to a
     float64 9-point blur with numpy on the host, at 1e-4 absolute;
  9. the blur main path: a seeded 4096x4096 RGBA image through
     `lbm_tpu_torch.cli.blur -n 100`: `--engine auto` must choose cuda with
     k_passes 4 and launch B9 50 times per run on its vector path, `--engine cuda` B10 200
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
     kernels, `copy_` for B12 and B11); B1's, B2's, B4's and B6's entries
     carry their launches, path and MLUPS in the sharded phases, B1's and
     B2's their launches in phase 7e, and B2's the measurements of 7e;
     B1-B7 their bfloat16 ms, bound, path and launches (`bf16`), B2 its
     shared_reciprocal cases, B4-B7 the per-speed grouping's numbers; B1,
     B2 and B4 their launches and runs in phase 7h (`bf16_sharded`), B6 its
     launches and ms a pass by layout in phase 7g (`layouts`);
 13. last line: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Exits non-zero, printing no result, when CUDA is absent or the package is not
beside this file. Imports nothing of JAX or of lbm_tpu.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
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
# B9's bands in the parity phase (100 divides none of the heights), and the
# shapes of its thread path: rows that are not whole 16-byte pieces
B9_BANDS = (64, 100)
B9_THREAD_CASES = {"float32": (4, 40, 250), "bfloat16": (4, 40, 252)}

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


def golden_gate(out, golden, label):
    """The flagship's gate on a run's out-dir: final_state.dat against the
    golden file by the checker's per-cell rule (column 5, 1%), av_vels.dat
    well formed. Returns av_vels."""
    from lbm_tpu_torch.core import io as lbm_io

    sim = np.loadtxt(out / "final_state.dat", usecols=(0, 1, 4, 5))
    check(sim.shape == (N * N, 4), f"final_state.dat has shape {sim.shape}")
    check(np.array_equal(sim[:, :2], golden[:, :2]),
          "final state coordinates differ from the golden file")
    pct = diff_pct(golden[:, 3], sim[:, 3])
    worst = int(np.argmax(np.abs(pct)))
    print(f"checker rule (column 5, pressure): max diff {pct[worst]:.3e}% at "
          f"({int(sim[worst, 0])},{int(sim[worst, 1])}), tolerance {CHECK_TOLERANCE_PCT}%")
    check(np.isfinite(pct[worst]) and abs(pct[worst]) <= CHECK_TOLERANCE_PCT,
          f"{label}: final state fails the checker's 1% rule")
    u_err = np.abs(sim[:, 2] - golden[:, 2]).max() / np.abs(golden[:, 2]).max()
    print(f"|u| column: max abs error / max|u| = {u_err:.3e} (not gated: f32 "
          "state rounding over 20,000 steps)")
    av = lbm_io.read_av_vels(out / "av_vels.dat")
    check(av.shape == (FLAGSHIP["max_iters"],) and np.isfinite(av).all(),
          f"{label}: av_vels.dat is malformed")
    return av


def engine_modules(mods):
    """{2-D kernel engine: its wrapper module}."""
    return {"cuda": mods[0], "cuda-inplace": mods[1], "cuda-manual": mods[2]}


def phase_main_path(torch, mods, golden, mask):
    """Phase 3. Returns {engine: (launches, seconds, mlups, path)} of each
    run, and the engine that `auto` picked."""
    from lbm_tpu_torch.cli import lbm as cli
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
            # launches count the warm-up run, one pass, and the timed run
            per_launch_ms = seconds / (launches - 1) * 1e3
            path = mod.last_path
            # the flagship shape moves its regions by TMA
            check(path == "box", f"--engine {engine}: {kernel} took the {path} path")
            print(f"main path --engine {engine} ({kernel}): {launches} launches, {seconds:.6f} s "
                  f"timed, {mlups} MLUPS, {per_launch_ms:.4f} ms per launch in the timed run, "
                  f"{path} path")
            results[engine] = (launches, seconds, mlups, path)

            avs[engine] = golden_gate(out, golden, f"--engine {engine}")

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
    """Phase 4. Returns {kernel: max_abs_err} of the float32 main-K case (on
    the path `choose_path` gives it)."""
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
        cases = [(k, label, extra) for k in (1, 2, 3, 4)
                 for label, extra in (("full", dict(accel_plane=nz - 2)), ("window", window))]
        for k, label, extra in cases:
            kw = dict(k_steps=k, **PHYSICS_3D, **extra)
            ref_f, ref_tot = d3q19_kstep.stepk_plain(f, mask, **kw)
            torch.cuda.synchronize()
            got = {}
            for path in d3q19_kstep.PATHS:
                b6_f, b6_tot = d3q19_kstep.stepk(f, mask, path=path, **kw)
                g = f.clone()
                b4_f, b4_tot = d3q19_kstep_inplace.stepk(g, mask, path=path, **kw)
                torch.cuda.synchronize()
                check(d3q19_kstep.last_path == path and d3q19_kstep_inplace.last_path == path,
                      f"a pass forced onto the {path} path ran on another")
                check(b4_f.data_ptr() == g.data_ptr(), "B4 did not write into its input's storage")
                got[path] = {"d3q19_kstep": (b6_f, b6_tot), "d3q19_kstep_inplace": (b4_f, b4_tot)}
            chosen = {name: d3q19_kstep.choose_path(nz, ny, nx, k, dtype, kernel=kernel)
                      for name, kernel in (("d3q19_kstep", "b6"), ("d3q19_kstep_inplace", "b4"))}
            for name, path in chosen.items():
                kf, kt = got[path][name]
                ef, et = rel_err(kf, ref_f), rel_err(kt, ref_tot)
                ea = float((kf - ref_f).abs().max())
                print(f"parity {name:19s} {dname} K={k} {label:6s} ({path} path): state max rel "
                      f"err {ef:.3e} (max abs {ea:.3e}), Sum|u| max rel err {et:.3e}")
                check(np.isfinite(ef) and ef <= BARS[dname],
                      f"{name} {dname} K={k} {label}: state rel err {ef} > {BARS[dname]}")
                check(np.isfinite(et) and et <= BARS[dname],
                      f"{name} {dname} K={k} {label}: Sum|u| rel err {et} > {BARS[dname]}")
                if dname == "float32" and k == k_main and label == "full":
                    abs_err[name] = ea
            what = f"{dname} K={k} {label}"
            step, wave = got["step"], got["wave"]
            for name in chosen:
                check(torch.equal(wave[name][0], step[name][0])
                      and torch.equal(wave[name][1], step[name][1]),
                      f"{name}: the wave path's state or Sum|u| differs from the step path's "
                      f"({what})")
            for path, res in got.items():
                check(torch.equal(res["d3q19_kstep_inplace"][0], res["d3q19_kstep"][0])
                      and torch.equal(res["d3q19_kstep_inplace"][1], res["d3q19_kstep"][1]),
                      f"B4 is not bit-equal to B6 on the {path} path ({what})")
            print(f"parity wave == step (state and Sum|u|), B4 == B6 on each path, bit for bit "
                  f"({what}); paths B6 {chosen['d3q19_kstep']}, B4 "
                  f"{chosen['d3q19_kstep_inplace']}")
            del ref_f, got, g
        run_kw = dict(num_steps=3 * k_main, k_steps=k_main, accel_plane=nz - 2, **PHYSICS_3D)
        step_f, step_tot = d3q19_kstep.run(f, mask, path="step", **run_kw)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        b6_f, b6_tot = d3q19_kstep.run(f, mask, **run_kw)
        torch.cuda.synchronize()
        b6_bytes = torch.cuda.max_memory_allocated() - before
        b6_path = d3q19_kstep.last_path
        g = f.clone()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        b4_f, b4_tot = d3q19_kstep_inplace.run(g, mask, **run_kw)
        torch.cuda.synchronize()
        extra_bytes = torch.cuda.max_memory_allocated() - before
        check(torch.equal(b6_f, step_f) and torch.equal(b6_tot, step_tot),
              f"B6 run on the {b6_path} path is not bit-equal to the step path ({dname})")
        check(torch.equal(b4_f, b6_f) and torch.equal(b4_tot, b6_tot),
              f"B4 run is not bit-equal to B6 run ({dname}, 3 passes of K={k_main})")
        print(f"parity B4 run ({d3q19_kstep_inplace.last_path} path) == B6 run ({b6_path} path) "
              f"== B6 run on the step path, bit for bit ({dname}, 3 passes of K={k_main})")
        # B4's run holds the lattice and the mask (already counted in
        # `before`) and may add less than half of them again
        held = g.numel() * g.element_size() + mask.numel()
        lattice = g.numel() * g.element_size()
        print(f"memory B4 run ({dname}): lattice + mask {held} B, allocated on top "
              f"{extra_bytes} B, peak {(held + extra_bytes) / held:.4f} x (bar 1.5 x)")
        print(f"memory B6 run ({dname}, {b6_path} path): allocated on top of the lattice and "
              f"mask {b6_bytes} B, {b6_bytes / lattice:.4f} lattices (the step path holds two)")
        check(b4_f.data_ptr() == g.data_ptr(), "B4 run did not stay in its input's storage")
        check(held + extra_bytes < 1.5 * held, f"B4 run allocated {extra_bytes} B on top")
        del b6_f, b4_f, g, f, step_f
    return abs_err


def phase_paths_3d(torch):
    """The wave path of B4 and B6 on small grids and in B6's modes
    (experiments/cuda-kstep-tiles/wave3d.py `check_paths`): at K = 1..4 in
    both types, on the two bench grids and on grids of 3, 4 and 7 planes
    whose rows and columns no block divides, each bit-equal to the step path
    and B4 to B6, at other plans (chunk, lag) and with 7 blocks in all; B6's
    stream_only and copy bit-equal to their plain versions' state,
    collide_no_roll within the bar."""
    harness = load_harness("wave3d")
    bad = harness.check_paths(log=lambda line: print(f"paths 3-D {line}"))
    check(not bad, f"the wave path differs on: {bad}")
    print("paths 3-D: every case held")


def phase_timing_3d(torch, mods3, k_main):
    """Time per launch (one pass of K steps) of each 3-D kernel on each path
    and of the plain version at the main path's shape, 64x128x256 float32,
    inside `run` as the main path calls them. Returns ({kernel: ms on the
    path `run` takes}, plain ms, bound, {kernel: {path: ms}}, {kernel: path})."""
    from lbm_tpu_torch.core import state
    d3q19_kstep, d3q19_kstep_inplace = mods3
    nz, ny, nx = SHAPE_3D
    rng = np.random.default_rng(8)
    f, mask = state.to_torch3d(random_state_3d(rng, nz, ny, nx), random_mask_3d(rng, nz, ny, nx),
                               device="cuda", dtype=torch.float32)
    kw = dict(accel_plane=nz - 2, **PHYSICS_3D)
    passes = 200
    ms, by_path, paths = {}, {}, {}
    for name, mod in (("d3q19_kstep", d3q19_kstep), ("d3q19_kstep_inplace", d3q19_kstep_inplace)):
        by_path[name] = {}
        for path in (None, *d3q19_kstep.PATHS):
            g = f.clone()
            t = time_ms(torch, lambda: mod.run(g, mask, num_steps=k_main * passes,
                                               k_steps=k_main, path=path, **kw), 1) / passes
            if path is None:
                ms[name], paths[name] = t, mod.last_path
            else:
                by_path[name][path] = t
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
        print(f"timing {name:19s}: {t:.4f} ms per K={k_main} launch on the {paths[name]} path "
              f"({cells * k_main / t / 1e3:.0f} MLUPS; wave path {by_path[name]['wave']:.4f}, "
              f"step path {by_path[name]['step']:.4f}), bound {bound[0]:.4f} ms ({bound[1]}), "
              f"plain version {plain_ms:.4f} ms")
    return ms, plain_ms, bound, by_path, paths


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
            k = int(re.search(r"^kernel:\s+slab, (\d+) steps? per pass$", text, re.M).group(1))
            want = d3q19_kstep.choose_path(nz, ny, nx, k, torch.float32,
                                           kernel="b4" if mod is d3q19_kstep_inplace else "b6")
            check(mod.last_path == want,
                  f"3-D {engine_args}: {kernel} ran on the {mod.last_path} path, not {want}")
            seconds = float(re.search(r"Total compute time:\s+([0-9.eE+-]+)", text).group(1))
            mlups = float(re.search(r"MLUPS:\s+([0-9.eE+-]+)", text).group(1))
            # launches count the warm-up run and the timed run, which are equal
            print(f"3-D main path {kernel}: {launches} launches, {seconds:.6f} s timed, "
                  f"{mlups} MLUPS, {seconds / (launches / 2) * 1e3:.4f} ms per launch in the "
                  f"timed run, {mod.last_path} path")
            results[kernel] = (launches, seconds, mlups, mod.last_path)
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
    """Time per pass of B7 and B5 at K = 1..3 beside B6 and B4 on each of
    their paths at K = 1..4, 32x256x256 float32, inside `run`; the plain
    version and the bound at the main path's K. Returns ({kernel: ms},
    plain_ms, bound, {kernel: path})."""
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
    slab = (("B6", d3q19_kstep), ("B4", d3q19_kstep_inplace))
    for k in (1, 2, 3, 4):
        row = {}
        paths = {}
        cases = [(name, mod, None) for name, mod in (("B7", b7), ("B5", b5)) if k < 4]
        cases += [(f"{name} {path}", mod, path) for name, mod in slab for path in d3q19_kstep.PATHS]
        for name, mod, path in cases:
            g = f.clone()
            extra = {} if path is None else dict(path=path)
            row[name] = time_ms(torch, lambda: mod.run(g, mask, num_steps=k * passes, k_steps=k,
                                                       **extra, **kw), 1) / passes
            paths[name] = getattr(mod, "last_path", None)
        blocked = (f"B7 {row['B7']:.4f} ms per pass (tile {b7.choose_config(nz, ny, nx, k)}, "
                   f"{paths['B7']} path), B5 {row['B5']:.4f} (tile "
                   f"{b5.choose_config(nz, ny, nx, k)}, {paths['B5']} path), " if k < 4 else "")
        print(f"timing blocked {nz}x{ny}x{nx} float32 K={k}: {blocked}B6 {row['B6 wave']:.4f} "
              f"(one launch a pass, wave path) / {row['B6 step']:.4f} (K launches, step path), "
              f"B4 {row['B4 wave']:.4f} / {row['B4 step']:.4f}; bytes of a pass "
              f"{bytes_moved / 1e6:.0f} MB, {t_bytes:.4f} ms at {HBM_BYTES_PER_S / 1e12} TB/s "
              "whatever K")
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
                                 (["--engine", "cuda-blocked"], b7), ([], None),
                                 (["--engine", "cuda"], None)):
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
                # the one-step kernel of the engine: B6 for cuda, B4 by default
                mod = d3q19_kstep if engine_args else d3q19_kstep_inplace
                check(kind.group(1) == "slab", f"{label}: ran {kind.group(1)}, not slab")
                want = d3q19_kstep.choose_path(
                    nz, ny, nx, int(kind.group(2)), torch.float32,
                    kernel="b4" if mod is d3q19_kstep_inplace else "b6")
                check(mod.last_path == want,
                      f"{label}: {names[mod]} ran on the {mod.last_path} path, not {want}")
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
            if mod in (b5, b7):
                results[kernel] = (launched[kernel], seconds, mlups)
            else:  # the one-step kernels' run at this grid, beside their own phase
                results[f"{kernel} {nz}x{ny}x{nx}"] = (launched[kernel], seconds, mlups,
                                                       mod.last_path)
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
            paths = []
            for k in range(1, stencil.MAX_PASSES_PER_SWEEP + 1):
                ref = stencil.blur_k_plain(x, m, k_passes=k)
                for band in B9_BANDS:
                    out = stencil.blur_k(x, m, k_passes=k, band=band)
                    paths.append(f"k={k} band {band} {stencil.last_path}")
                    outs["blur_k"].append((f" k={k} band={band} ({stencil.last_path} path)",
                                           out, ref))
                    check(stencil.last_path == "vector",
                          f"B9 took its {stencil.last_path} path at {label} {dname}")
            print(f"blur parity B9 paths {label} {dname}: " + ", ".join(paths))
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
    # B9's thread path: rows that are not whole 16-byte pieces, a ring that
    # is not zero
    for dname, shape in B9_THREAD_CASES.items():
        img_np, int_np = blur_case(rng, shape, (0, 0), ring=True)
        dtype = getattr(torch, dname)
        x = torch.from_numpy(img_np).to("cuda", dtype)
        m = torch.from_numpy(int_np).to("cuda", dtype)
        worst, paths = 0.0, []
        for k in range(1, stencil.MAX_PASSES_PER_SWEEP + 1):
            ref = stencil.blur_k_plain(x, m, k_passes=k)
            for band in (16, B9_BANDS[1]):
                out = stencil.blur_k(x, m, k_passes=k, band=band)
                paths.append(f"k={k} band {band} {stencil.last_path}")
                check(stencil.last_path == "thread",
                      f"B9 took its {stencil.last_path} path at {shape} {dname}")
                worst = max(worst, hold_to_plain(torch, f"blur_k k={k} band={band} {shape} "
                                                        f"{dname}", out, ref))
        label = "x".join(map(str, shape))
        print(f"blur parity B9 paths {label} {dname}: " + ", ".join(paths))
        print(f"blur parity blur_k        {label} {dname}: {len(paths)} cases on the thread "
              f"path, max abs err vs plain {worst:.3e}"
              + (" (bit-equal)" if dtype == torch.float32 else " (<= 1 ulp)"))
        if dtype == torch.float32:
            abs_err["blur_k"] = max(abs_err["blur_k"], worst)
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
            if kernel == "blur_k":
                print(f"blur main path {label}: B9's path {stencil.last_path}")
                check(stencil.last_path == "vector",
                      f"{label}: B9 ran on its {stencil.last_path} path")
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
    B10 and B9 (k=4; B9 in bfloat16 too) at the padded 4096x4096 image, B8 at the padded bricks
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
        path=stencil.last_path,
        plain_ms=time_ms(torch, lambda: stencil.blur_k_plain(x, m, k_passes=k), 5),
        library_ms=k * conv_ms, bound=bound, shape=list(BIG[0]), k_passes=k,
        band=stencil.DEFAULT_BAND, windows=stencil.K_WINDOWS)
    # and in bfloat16, the main path's `--data-type half`
    xb, mb = x.to(torch.bfloat16), m.to(torch.bfloat16)
    out["blur_k"].update(
        ms_bf16=time_ms(torch, lambda: stencil.blur_k(xb, mb, k_passes=k), 50),
        path_bf16=stencil.last_path,
        plain_ms_bf16=time_ms(torch, lambda: stencil.blur_k_plain(xb, mb, k_passes=k), 5),
        library_ms_bf16=k * time_ms(torch, lambda: stencil.blur_step_conv(xb, mb), 20),
        bound_ms_bf16=blur_bound(BIG[0], 2, k * FLOP_PER_VALUE_SEPARABLE)[0])
    del x, m, xb, mb

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
    b9 = out["blur_k"]
    print(f"timing blur_k        at {tuple(b9['shape'])} bfloat16: {b9['ms_bf16']:.4f} ms per "
          f"launch ({b9['path_bf16']} path), bound {b9['bound_ms_bf16']:.5f} ms (bytes), plain "
          f"version {b9['plain_ms_bf16']:.4f} ms, library {b9['library_ms_bf16']:.4f} ms")
    for name, t in out.items():
        extra = (f", {t['us_per_pass']:.3f} us per pass from runs of {passes} and {long_run}"
                 if name == "blur_resident" else
                 f" ({t['path']} path, band {t['band']}, {t['windows']} window(s) a channel "
                 "in a block)" if name == "blur_k" else "")
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


SHARDED_STEPS = 1000  # the halo strategies' runs against the plain engine
SHARDED_AV_BAR = 1e-6  # av_vels of the ghost-band run against B1's: Sum|u| in another order
SHARDED_TIMING_CHUNKS = 200


@contextlib.contextmanager
def nccl_world_of_one(torch):
    """A NCCL process group of this process alone (file:// rendezvous,
    cuda:0), destroyed on leaving: the multi-device entry points then run
    in-process, so the kernels' launch counts stay visible."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{Path(tmp) / 'rendezvous'}",
                                world_size=1, rank=0, device_id=torch.device("cuda", 0))
        try:
            yield
        finally:
            dist.destroy_process_group()


def phase_sharded(torch, mods, golden, mask, stencil):
    """Phase 7c: the 2-D multi-device paths at world size 1, in the NCCL
    process group of `nccl_world_of_one`. Returns {"d2q9_kstep_inplace":
    launches, "d2q9_kstep": launches, ...} of the ghost-band runs and their
    measurements."""
    from lbm_tpu_torch.cli import blur as blur_cli
    from lbm_tpu_torch.cli import lbm as cli
    from lbm_tpu_torch.core import state
    from lbm_tpu_torch.core.params import Obstacles, Params
    from lbm_tpu_torch.models import blur as blur_model
    from lbm_tpu_torch.models import lbm as lbm_model
    from lbm_tpu_torch.ops import d2q9
    from lbm_tpu_torch.parallel import kstep_sharded, mesh as mesh_lib
    from lbm_tpu_torch.utils import image as img_lib
    d2q9_kstep, d2q9_kstep_inplace, _ = mods

    out = {}
    params, obstacles = Params(**FLAGSHIP), Obstacles(mask)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        params.to_file(tmp / "p.params")
        obstacles.to_file(tmp / "o.dat")
        files = ["--params", str(tmp / "p.params"), "--obstacles", str(tmp / "o.dat")]
        ref = lbm_model.run_simulation(params, obstacles, dtype=torch.float32,
                                       engine="cuda-inplace", device="cuda")
        ref_mlups = N * N * FLAGSHIP["max_iters"] / ref.compute_seconds / 1e6
        print(f"sharded: --engine cuda-inplace (B1) reference run: {ref.compute_seconds:.6f} s,"
              f" {ref_mlups:.1f} MLUPS")

        # the ghost-band engine through the CLI, B1 on the extended block
        for flags in ([], ["--overlap"]):
            label = f"--engine sharded-cuda --num-devices 1 {' '.join(flags)}".strip()
            for m in mods:
                m.launches = 0
            with CountCalls(d2q9, "collide_fields") as plain, \
                    Capture(lbm_model, "run_simulation_sharded") as captured:
                rc, text = run_cli(cli.main, files + [
                    "--engine", "sharded-cuda", "--num-devices", "1", "--dtype", "float32",
                    "--out-dir", str(tmp / "out"), *flags])
            launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}
            print(f"sharded: {label}:\n{text.rstrip()}")
            check(rc == 0, f"{label}: cli returned {rc}")
            check(launches["d2q9_kstep_inplace"] > 0, f"{label}: B1 was never launched")
            check(launches["d2q9_kstep"] == 0 and launches["d2q9_kstep_manual"] == 0,
                  f"{label}: another 2-D kernel was launched: {launches}")
            check(plain.calls == 0, f"{label}: the plain engine ran {plain.calls} collisions")
            res = captured.results[0]
            golden_gate(tmp / "out", golden, label)
            check(np.array_equal(res.f_final, ref.f_final),
                  f"{label}: the final state differs from --engine cuda-inplace's")
            av_err = float(np.max(np.abs(res.av_vels - ref.av_vels) / np.abs(ref.av_vels)))
            check(av_err <= SHARDED_AV_BAR,
                  f"{label}: av_vels {av_err} from cuda-inplace's > {SHARDED_AV_BAR}")
            mlups = float(re.search(r"MLUPS:\s+([0-9.eE+-]+)", text).group(1))
            path = d2q9_kstep_inplace.last_path
            print(f"sharded: {label}: B1 {launches['d2q9_kstep_inplace']} launches on the "
                  f"{path} path (extended block 9x{N + 2 * kstep_sharded.GHOST}x{N}), "
                  f"{res.compute_seconds:.6f} s timed, {mlups} MLUPS against cuda-inplace's "
                  f"{ref_mlups:.1f}; final state bit-equal to cuda-inplace's, av_vels max "
                  f"rel err {av_err:.3e} (bar {SHARDED_AV_BAR})")
            check(path == "box", f"{label}: B1 took the {path} path on the extended block")
            key = "overlap" if flags else "fused"
            out[key] = dict(launches=launches["d2q9_kstep_inplace"], path=path, mlups=mlups,
                            seconds=res.compute_seconds, av_err=av_err)
        out["cuda_inplace_mlups"] = ref_mlups

        # the same run with B2 as the local engine
        f0 = state.initial_distributions(params, np.float32)
        mesh = kstep_sharded.make_row_mesh()
        for m in mods:
            m.launches = 0
        f_b2, av_b2 = kstep_sharded.simulate(params, f0, mask, mesh,
                                             local_engine="two-stream")
        b2 = d2q9_kstep.launches
        check(b2 > 0 and d2q9_kstep_inplace.launches == 0,
              "the two-stream ghost-band run did not go through B2 alone")
        check(np.array_equal(f_b2.cpu().numpy(), ref.f_final),
              "the ghost-band run on B2 differs from cuda-inplace's state")
        print(f"sharded: ghost-band run on B2 (two-stream): {b2} launches on the "
              f"{d2q9_kstep.last_path} path, final state bit-equal to cuda-inplace's")
        out["two_stream"] = dict(launches=b2, path=d2q9_kstep.last_path)

        # a chunk's parts: the exchange (at world size 1 local copies),
        # the snapshot refresh, B1's pass, and the one all-reduce of a run
        aw = d2q9.AccelWeights.from_params(params)
        f_sh, mask_ext, _ = kstep_sharded.prepare(params, f0, mask, mesh)
        chunk = kstep_sharded.make_chunk_fn(mesh, k_steps=4, omega=params.omega,
                                            accel_w1=aw.w1, accel_w2=aw.w2, accel_row=N - 2,
                                            ny=N)
        chunk.start(f_sh.to_local(), mask_ext.to_local())
        n = SHARDED_TIMING_CHUNKS
        tots = torch.empty(4, device="cuda")
        chunk_ms = time_ms(torch, lambda: chunk(tots), n)
        chain_ms = time_ms(torch, lambda: chunk.passes(tots), n)
        pass_ms = time_ms(torch, lambda: d2q9_kstep_inplace.run(
            chunk.buf, chunk.mask, num_steps=4 * n, k_steps=4, omega=params.omega,
            accel_w1=aw.w1, accel_w2=aw.w2, accel_row=N - 2), 1) / n
        sums = torch.zeros(FLAGSHIP["max_iters"], device="cuda")
        reduce_ms = time_ms(torch, lambda: mesh_lib.sum_by_rank(sums, mesh), 50)
        t0 = time.perf_counter()
        for _ in range(n):
            chunk(tots)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / n * 1e3
        chunks = FLAGSHIP["max_iters"] // 4
        print(f"sharded: a chunk (K=4) {chunk_ms:.4f} ms on the device's clock, {host_ms:.4f} "
              f"ms on the host's; B1's chained pass with its snapshot refresh {chain_ms:.4f} "
              f"ms; a B1 pass of `run` on the extended block {pass_ms:.4f} ms. Exchange "
              f"(local copies at world size 1) {chunk_ms - chain_ms:.4f} ms "
              f"({(chunk_ms - chain_ms) / chunk_ms:.1%} of a chunk), refresh "
              f"{chain_ms - pass_ms:.4f} ms ({(chain_ms - pass_ms) / chunk_ms:.1%}); the "
              f"run's one all-reduce of {FLAGSHIP['max_iters']} sums {reduce_ms:.4f} ms "
              f"({reduce_ms / (chunk_ms * chunks):.3%} of the run's chunks)")
        out["chunk"] = dict(chunk_ms=chunk_ms, chain_ms=chain_ms, pass_ms=pass_ms,
                            host_ms=host_ms, allreduce_ms=reduce_ms)

        # the halo strategies, 1000 steps, against the plain engine
        short = Params(**{**FLAGSHIP, "max_iters": SHARDED_STEPS})
        plain_ref = lbm_model.run_simulation(short, obstacles, dtype=torch.float32,
                                             engine="torch", device="cuda")
        strategies = {}
        for strategy in lbm_model.STRATEGIES:
            # through the model: the CLI's path is the ghost-band runs'
            # above, and writing a final state takes seconds
            label = f"engine sharded, strategy {strategy}"
            res = lbm_model.run_simulation_sharded(short, obstacles, dtype=torch.float32,
                                                   engine="sharded", strategy=strategy,
                                                   num_devices=1, device="cuda")
            check(np.array_equal(res.f_final, plain_ref.f_final),
                  f"{label}: the state differs from the torch engine's")
            av_err = float(np.max(np.abs(res.av_vels - plain_ref.av_vels)
                                  / np.abs(plain_ref.av_vels)))
            check(av_err <= SHARDED_AV_BAR, f"{label}: av_vels rel err {av_err}")
            mlups = N * N * SHARDED_STEPS / res.compute_seconds / 1e6
            print(f"sharded: {label}: {SHARDED_STEPS} steps, {mlups:.1f} MLUPS, state bit-equal "
                  f"to the torch engine's, av_vels max rel err {av_err:.3e}")
            strategies[strategy] = mlups
        plain_mlups = N * N * SHARDED_STEPS / plain_ref.compute_seconds / 1e6
        print(f"sharded: --engine torch on the card, {SHARDED_STEPS} steps: {plain_mlups:.1f} "
              "MLUPS")
        out["strategies_mlups"] = strategies
        out["torch_mlups"] = plain_mlups

        # the blur on a mesh of one rank, against the conv engine
        rgba = seeded_rgba(20261019, *BIG[1])
        img_lib.save_png(tmp / "big.png", rgba)
        conv = blur_model.run_blur(rgba, num_iters=BLUR_ITERS, engine="conv", device="cuda")
        for key in stencil.launches:
            stencil.launches[key] = 0
        with Capture(blur_model, "run_blur") as captured:
            rc, text = run_cli(blur_cli.main, ["-i", str(tmp / "big.png"), "-o",
                                               str(tmp / "out.png"), "-n", str(BLUR_ITERS),
                                               "--engine", "conv-sharded",
                                               "--num-devices", "1"])
        check(rc == 0, f"blur --engine conv-sharded returned {rc}")
        run = captured.results[0]
        check(sum(stencil.launches.values()) == 0, "conv-sharded launched a blur kernel")
        check(np.array_equal(run.state, conv.state) and np.array_equal(run.rgba, conv.rgba),
              "conv-sharded differs from the conv engine")
        check(np.array_equal(img_lib.load_png(tmp / "out.png"), conv.rgba),
              "the conv-sharded PNG differs from the conv engine's image")
        print(f"sharded: blur --engine conv-sharded --num-devices 1, {BIG[1][0]}x{BIG[1][1]} x "
              f"{2 * BLUR_ITERS} passes: {run.compute_seconds:.6f} s (conv "
              f"{conv.compute_seconds:.6f} s), state and image bit-equal to conv's")
        out["conv_sharded_seconds"] = run.compute_seconds
        out["conv_seconds"] = conv.compute_seconds
    return out


# the 3-D multi-device phase: the bench shape and the blocked pair's shape,
# each through sharded-cuda beside cuda-inplace; the plain engine's size
SHARDED_3D_SHAPES = (SHAPE_3D, SHAPE_BLOCKED)
SHARDED_3D_AV_BAR = 1e-5  # av_vels against cuda-inplace's: Sum|u| in another order
SHARDED_PLAIN_3D = (16, 64, 128)
SHARDED_PLAIN_3D_STEPS = 100
SHARDED_3D_FUSED = "--engine sharded-cuda at {}x{}x{}".format(*SHAPE_3D)
SHARDED_3D_CHECKPOINT_STEPS = 600  # then resumed to 2x, chunks of half


def split_chunk(torch, chunk, tots, n: int) -> dict:
    """n calls of a ghost-plane chunk (`kstep_sharded_3d.make_chunk_fn`) with
    CUDA events recorded around its two parts inside each call: the device
    ms a chunk of the chunk as a whole, of its exchange, of its kernel pass,
    and of the rest (what lies between: the copy of Sum|u| and the gaps
    between launches), so the three parts add up to the chunk."""
    pairs = [[torch.cuda.Event(enable_timing=True) for _ in range(2)] for _ in range(2 * n + 2)]
    used = []

    def timed(fn):
        def call(*args, **kw):
            begin, end = pairs[len(used)]
            begin.record()
            out = fn(*args, **kw)
            end.record()
            used.append((fn, begin, end))
            return out
        return call

    exchange, stepk = chunk.exchange_planes, chunk.stepk
    chunk.exchange_planes, chunk.stepk = timed(exchange), timed(stepk)
    try:
        chunk(tots)  # warm-up
        torch.cuda.synchronize()
        used.clear()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            chunk(tots)
        stop.record()
        stop.synchronize()
    finally:
        del chunk.exchange_planes
        chunk.stepk = stepk
    check(len(used) == 2 * n, f"the timed chunks ran {len(used)} parts, not {2 * n}")
    total = start.elapsed_time(stop) / n
    parts = {name: sum(b.elapsed_time(e) for fn, b, e in used if fn is part) / n
             for name, part in (("exchange_ms", exchange), ("pass_ms", stepk))}
    return dict(chunk_ms=total, **parts,
                rest_ms=total - parts["exchange_ms"] - parts["pass_ms"])


def phase_sharded_3d(torch, mods3, modsb):
    """Phase 7d: the 3-D multi-device paths at world size 1, in the NCCL
    process group of `nccl_world_of_one`. Returns the launches, paths and
    MLUPS of each run and the split of a chunk."""
    from lbm_tpu_torch.cli import lbm3d as cli3
    from lbm_tpu_torch.core import io as lbm_io
    from lbm_tpu_torch.models import lbm3d as lbm3d_model
    from lbm_tpu_torch.ops import d3q19
    from lbm_tpu_torch.parallel import kstep_sharded_3d as ks3, mesh as mesh_lib
    d3q19_kstep, d3q19_kstep_inplace = mods3
    all3 = (*mods3, *modsb)

    def reset():
        for m in all3:
            m.launches = 0

    def launches():
        return {m.__name__.rsplit(".", 1)[1]: m.launches for m in all3}

    out = {"runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for nz, ny, nx in SHARDED_3D_SHAPES:
            grid = f"{nz}x{ny}x{nx}"
            base = ["--nz", str(nz), "--ny", str(ny), "--nx", str(nx), "-n", str(STEPS_3D),
                    "--dtype", "float32"]
            with Capture(d3q19, "advance") as cap:
                rc, text = run_cli(cli3.main, base + ["--engine", "cuda-inplace", "--out-dir",
                                                      str(tmp / "ref")])
            check(rc == 0, f"3-D cuda-inplace at {grid}: cli returned {rc}")
            ref_f, ref_av = (t.cpu().numpy() for t in cap.results[-1])
            ref_mlups = float(re.search(r"MLUPS:\s+([0-9.eE+-]+)", text).group(1))
            print(f"sharded 3-D: --engine cuda-inplace at {grid} x {STEPS_3D}: {ref_mlups} MLUPS "
                  f"(reference run, B4 on the {d3q19_kstep_inplace.last_path} path)")
            out[f"cuda_inplace_mlups {grid}"] = ref_mlups
            runs = [("sharded-cuda", [])]
            if (nz, ny, nx) == SHAPE_3D:
                runs += [("sharded-cuda", ["--overlap"]),
                         ("sharded-cuda-zy", ["--mesh-shape", "1", "1"])]
            for engine, flags in runs:
                label = f"--engine {engine} {' '.join(flags)} at {grid}".replace("  ", " ")
                reset()
                with CountCalls(d3q19, "collide_fields") as plain, \
                        Capture(lbm3d_model, "run_simulation_sharded") as captured:
                    rc, text = run_cli(cli3.main, base + [
                        "--engine", engine, "--num-devices", "1", *flags, "--out-dir",
                        str(tmp / "sharded")])
                counts = launches()
                print(f"sharded 3-D: {label}:\n{text.rstrip()}")
                check(rc == 0, f"{label}: cli returned {rc}")
                check(counts["d3q19_kstep_inplace"] > 0, f"{label}: B4 was never launched")
                check(sum(counts.values()) == counts["d3q19_kstep_inplace"],
                      f"{label}: another 3-D kernel was launched: {counts}")
                check(plain.calls == 0, f"{label}: the plain engine ran {plain.calls} collisions")
                res = captured.results[0]
                check(np.array_equal(res.f_final, ref_f),
                      f"{label}: the final state differs from --engine cuda-inplace's")
                av = lbm_io.read_av_vels(tmp / "sharded" / "av_vels_3d.dat")
                check(av.shape == (STEPS_3D,) and np.isfinite(av).all(),
                      f"{label}: av_vels_3d.dat is malformed")
                av_err = float(np.max(np.abs(res.av_vels[1:] - ref_av[1:]) / np.abs(ref_av[1:])))
                check(av_err <= SHARDED_3D_AV_BAR,
                      f"{label}: av_vels {av_err} from cuda-inplace's > {SHARDED_3D_AV_BAR}")
                mlups = float(re.search(r"MLUPS:\s+([0-9.eE+-]+)", text).group(1))
                path = d3q19_kstep_inplace.last_path
                print(f"sharded 3-D: {label}: B4 {counts['d3q19_kstep_inplace']} launches on the "
                      f"{path} path (blocks {'x'.join(map(str, res.block))}, K={res.k_steps}), "
                      f"{res.compute_seconds:.6f} s timed, {mlups} MLUPS against cuda-inplace's "
                      f"{ref_mlups}; final state bit-equal to cuda-inplace's, av_vels[1:] max rel "
                      f"err {av_err:.3e} (bar {SHARDED_3D_AV_BAR})")
                out["runs"][label] = dict(launches=counts["d3q19_kstep_inplace"], path=path,
                                          mlups=mlups, seconds=res.compute_seconds,
                                          av_err=av_err, k_steps=res.k_steps,
                                          block=list(res.block))
                if (nz, ny, nx) == SHAPE_3D and engine == "sharded-cuda" and not flags:
                    fused_k, fused_f, fused_av = res.k_steps, res.f_final, res.av_vels
            if (nz, ny, nx) != SHAPE_3D:
                continue

            # B6 as the local kernel (the two-stream oracle), timed as the CLI's runs
            reset()
            res = lbm3d_model.run_simulation_sharded(
                nz, ny, nx, num_steps=STEPS_3D, num_devices=1, local_engine="two-stream",
                device="cuda", **PHYSICS_3D)
            counts = launches()
            check(counts["d3q19_kstep"] > 0 and sum(counts.values()) == counts["d3q19_kstep"],
                  f"the two-stream ghost-plane run did not go through B6 alone: {counts}")
            check(res.kernel == "d3q19_kstep" and res.k_steps == fused_k,
                  f"the two-stream run took {res.kernel} at K={res.k_steps}")
            check(np.array_equal(res.f_final, ref_f),
                  "the ghost-plane run on B6 differs from cuda-inplace's state")
            check(np.array_equal(res.av_vels, fused_av),
                  "the ghost-plane run's av_vels on B6 differ from B4's")
            mlups = nz * ny * nx * STEPS_3D / res.compute_seconds / 1e6
            print(f"sharded 3-D: ghost-plane run on B6 (two-stream) at {grid}: "
                  f"{counts['d3q19_kstep']} launches on the {d3q19_kstep.last_path} path, "
                  f"{res.compute_seconds:.6f} s timed, {mlups:.1f} MLUPS; state bit-equal to "
                  "cuda-inplace's, av_vels bit-equal to B4's")
            out["two_stream"] = dict(launches=counts["d3q19_kstep"], path=d3q19_kstep.last_path,
                                     mlups=mlups, seconds=res.compute_seconds)

            # a chunk's parts, device and host; B4 on the extended block and
            # on the lattice
            k = fused_k
            mesh = ks3.make_z_mesh(1)
            mask = d3q19.default_obstacle_mask(nz, ny, nx)
            f0 = d3q19.initial_distributions(nz, ny, nx, PHYSICS_3D["density"], np.float32)
            f_sh, mask_ext = ks3.prepare(f0, mask, mesh, k_steps=k,
                                         density=PHYSICS_3D["density"])
            chunk = ks3.make_chunk_fn(mesh, k_steps=k, accel_plane=nz - 2, nz=nz, **PHYSICS_3D)
            chunk.start(f_sh.to_local(), mask_ext.to_local())
            n = SHARDED_TIMING_CHUNKS
            device = chunk.buf.device
            tots = torch.empty(k, device=device)
            chunk_ms = time_ms(torch, lambda: chunk(tots), n)
            split = split_chunk(torch, chunk, tots, n)
            pass_ms = time_ms(torch, lambda: chunk.stepk(chunk.buf, chunk.mask, **chunk.kwargs), n)
            lattice = torch.from_numpy(ref_f).to(device)
            mask_t = torch.from_numpy(mask).to(device)
            lattice_ms = time_ms(torch, lambda: d3q19_kstep_inplace.stepk(
                lattice, mask_t, k_steps=k, accel_plane=nz - 2, **PHYSICS_3D), n)
            sums = torch.zeros(STEPS_3D, device=device)
            reduce_ms = time_ms(torch, lambda: mesh_lib.sum_by_rank(sums, mesh), 50)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                chunk(tots)
            enqueue_ms = (time.perf_counter() - t0) / n * 1e3
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) / n * 1e3
            ext = chunk.buf.shape[1]
            total = split["chunk_ms"]
            print(f"sharded 3-D: a chunk (K={k}) at {grid}, world size 1: {chunk_ms:.4f} ms on "
                  f"the device's clock; {host_ms:.4f} ms a chunk on the host's with the device "
                  f"waited for, {enqueue_ms:.4f} ms to enqueue one. Inside the same chunks, "
                  f"timed by events around their parts ({total:.4f} ms a chunk so timed): the "
                  f"exchange (local copies at world size 1) {split['exchange_ms']:.4f} ms "
                  f"({split['exchange_ms'] / total:.1%}), B4's pass on the extended block "
                  f"(19x{ext}x{ny}x{nx}, {chunk.kwargs['valid_planes']} valid) "
                  f"{split['pass_ms']:.4f} ms ({split['pass_ms'] / total:.1%}), the rest (the "
                  f"Sum|u| copy, the gaps between launches) {split['rest_ms']:.4f} ms "
                  f"({split['rest_ms'] / total:.1%}). B4's pass alone on the extended block "
                  f"{pass_ms:.4f} ms, on the {nz}-plane lattice {lattice_ms:.4f} ms "
                  f"(x{ext / nz:.4f} planes: {pass_ms / lattice_ms:.4f}x the time); the run's "
                  f"one all-reduce of {STEPS_3D} sums {reduce_ms:.4f} ms")
            out["chunk"] = dict(k_steps=k, chunk_ms=chunk_ms, split=split, host_ms=host_ms,
                                enqueue_ms=enqueue_ms, pass_alone_ms=pass_ms,
                                lattice_pass_ms=lattice_ms, extended_planes=ext,
                                allreduce_ms=reduce_ms)
            del chunk, lattice

            # a checkpointed run, resumed, against an uninterrupted one
            steps = SHARDED_3D_CHECKPOINT_STEPS
            reset()
            ck = ["--nz", str(nz), "--ny", str(ny), "--nx", str(nx), "--dtype", "float32",
                  "--engine", "sharded-cuda", "--num-devices", "1",
                  "--checkpoint-every", str(steps // 2)]
            with Capture(lbm3d_model, "run_simulation_with_checkpoints") as captured:
                for argv in (["-n", str(steps), "--out-dir", str(tmp / "ck")],
                             ["-n", str(2 * steps), "--resume", "--out-dir", str(tmp / "ck")],
                             ["-n", str(2 * steps), "--out-dir", str(tmp / "whole")]):
                    rc, text = run_cli(cli3.main, ck + argv)
                    check(rc == 0, f"checkpointed sharded-cuda {argv}: cli returned {rc}")
            (f_a, av_a, _, _), (f_r, av_r, _, run_r), (f_w, av_w, _, _) = captured.results
            check(run_r == steps and av_r.shape == (2 * steps,),
                  f"the resumed sharded-cuda run ran {run_r} steps")
            check(np.array_equal(f_r, f_w) and np.array_equal(av_r, av_w)
                  and np.array_equal(av_r[:steps], av_a),
                  "the resumed sharded-cuda run differs from an uninterrupted one")
            ck_launches = launches()["d3q19_kstep_inplace"]
            print(f"sharded 3-D: --engine sharded-cuda --checkpoint-every {steps // 2} at {grid}: "
                  f"{steps} steps, resumed to {2 * steps}: state and av_vels bit-equal to an "
                  f"uninterrupted run; B4 {ck_launches} launches")
            out["checkpoint_launches"] = ck_launches

        # the plain engine on DTensors at a small size, against the torch engine
        nz, ny, nx = SHARDED_PLAIN_3D
        grid = f"{nz}x{ny}x{nx}"
        reset()
        res = lbm3d_model.run_simulation_sharded(nz, ny, nx, num_steps=SHARDED_PLAIN_3D_STEPS,
                                                 engine="sharded", num_devices=1, device="cuda",
                                                 **PHYSICS_3D)
        check(sum(launches().values()) == 0, "the plain 'sharded' engine launched a kernel")
        f_t, av_t = d3q19.simulate(nz, ny, nx, num_steps=SHARDED_PLAIN_3D_STEPS, engine="torch",
                                   device="cuda", **PHYSICS_3D)
        check(np.array_equal(res.f_final, f_t.cpu().numpy()),
              "the 'sharded' engine's state differs from the torch engine's")
        av_t = av_t.cpu().numpy()
        av_err = float(np.max(np.abs(res.av_vels[1:] - av_t[1:]) / np.abs(av_t[1:])))
        check(av_err <= SHARDED_3D_AV_BAR, f"the 'sharded' engine's av_vels: {av_err}")
        mlups = nz * ny * nx * SHARDED_PLAIN_3D_STEPS / res.compute_seconds / 1e6
        t0 = time.perf_counter()
        d3q19.simulate(nz, ny, nx, num_steps=SHARDED_PLAIN_3D_STEPS, engine="torch",
                       device="cuda", **PHYSICS_3D)[1].cpu()
        plain_mlups = nz * ny * nx * SHARDED_PLAIN_3D_STEPS / (time.perf_counter() - t0) / 1e6
        print(f"sharded 3-D: --engine sharded (the plain step on DTensors) at {grid} x "
              f"{SHARDED_PLAIN_3D_STEPS}: {mlups:.1f} MLUPS (mesh "
              f"{'x'.join(map(str, res.mesh_shape))}), state bit-equal to the torch engine's "
              f"({plain_mlups:.1f} MLUPS on the host's clock), av_vels[1:] max rel err "
              f"{av_err:.3e}")
        out["plain_sharded_mlups"] = mlups
        out["torch_mlups"] = plain_mlups
    return out


# the host-side and tooling phase: a traced flagship run of 200 steps (B2 at
# K = 4: 50 launches in the timed run), the export pair at 1024^2, the native
# engine against the cuda engine at 256^2, and the halo strategies' bench
TOOLING_STEPS = 200
TOOLING_K = 4
B2_KERNEL = "kstep_box_kernel"  # kstep_box_kernel<T, false, mode>: B2's box path
RUNNER_AV_BAR = 4e-4  # the exported step's av_vels against auto's (the bench gate)
NATIVE_SHAPE = (256, 256)
NATIVE_STEPS = 1000
NATIVE_AV_BAR = 1e-12  # f64: the serial engine against B2, Sum|u| in another order


def phase_tooling(torch, mods, mask):
    """Phase 7e: the host-side and tooling modules on the card. Returns the
    launches of B2 and B1 on their runs here and the measurements."""
    from lbm_tpu_torch.cli import lbm as cli
    from lbm_tpu_torch.cli import lbm_runner
    from lbm_tpu_torch.core import io as lbm_io
    from lbm_tpu_torch.core import state
    from lbm_tpu_torch.core.params import Obstacles, Params
    from lbm_tpu_torch.models import lbm as lbm_model
    from lbm_tpu_torch.ops import d2q9
    from lbm_tpu_torch.utils import native_io, profiling
    d2q9_kstep, d2q9_kstep_inplace, _ = mods

    out = {"launches": {m.__name__.rsplit(".", 1)[1]: 0 for m in mods}}
    params = Params(**{**FLAGSHIP, "max_iters": TOOLING_STEPS})
    passes = TOOLING_STEPS // TOOLING_K
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        params.to_file(tmp / "p.params")
        Obstacles(mask).to_file(tmp / "o.dat")
        files = ["--params", str(tmp / "p.params"), "--obstacles", str(tmp / "o.dat"),
                 "--dtype", "float32"]

        def cli_run(label, argv, kernel=None):
            """cli.lbm with the launch counts set to 0 just before; returns the
            run's LbmResult, its text and the launches of each 2-D kernel."""
            for m in mods:
                m.launches = 0
            with CountCalls(d2q9, "collide_fields") as plain, \
                    Capture(lbm_model, "run_simulation") as captured:
                rc, text = run_cli(cli.main, files + argv)
            launches = {m.__name__.rsplit(".", 1)[1]: m.launches for m in mods}
            for name, n in launches.items():
                out["launches"][name] += n
            check(rc == 0, f"{label}: cli returned {rc}")
            if kernel is not None:
                check(plain.calls == 0, f"{label}: the plain engine ran {plain.calls} collisions")
                check(launches[kernel] > 0 and sum(launches.values()) == launches[kernel],
                      f"{label}: launches {launches}, not {kernel} alone")
            return captured.results[0], text, launches

        # 1. the flagship through auto, traced
        label = f"tooling: --engine auto --trace-dir, {TOOLING_STEPS} steps"
        traced, text, launches = cli_run(label, ["--engine", "auto", "--out-dir",
                                                 str(tmp / "auto"), "--trace-dir",
                                                 str(tmp / "trace")], "d2q9_kstep")
        print(f"{label}:\n{text.rstrip()}")
        check(traced.engine == "cuda", f"{label}: auto chose {traced.engine}, not cuda (B2)")
        check(launches["d2q9_kstep"] == passes + 1,
              f"{label}: B2 launched {launches['d2q9_kstep']} times, not {passes + 1} "
              "(a one-pass warm-up run and the timed run)")
        summary = profiling.kernel_summary(tmp / "trace" / profiling.TRACE_FILE)
        check(summary["device_events"] > 0,
              f"{label}: the trace holds no device event in the timed run: torch.profiler "
              "recorded no CUDA activity (CUPTI)")
        names = [name for name in summary["kernels"] if B2_KERNEL in name]
        check(len(names) == 1, f"{label}: B2's kernel is not named once in the trace: "
                               f"{sorted(summary['kernels'])}")
        b2 = summary["kernels"][names[0]]
        check(b2["launches"] == passes,
              f"{label}: the trace has {b2['launches']} launches of B2, not {passes}")
        events_ms = traced.compute_seconds * 1e3
        for name, k in sorted(summary["kernels"].items(), key=lambda kv: -kv[1]["device_us"]):
            print(f"trace: {k['launches']} x {name}: {k['device_us'] / 1e3:.4f} ms on the device")
        print(f"trace: B2 ({names[0]}) {b2['launches']} launches, {b2['device_us'] / 1e3:.4f} ms "
              f"summed device time, {b2['device_us'] / b2['launches']:.3f} us a launch; the run's "
              f"CUDA-event time {events_ms:.4f} ms (traced); window {summary['window_us'] / 1e3:.4f}"
              f" ms, device busy {summary['busy_us'] / 1e3:.4f} ms, idle share "
              f"{summary['idle_share']:.4f}")
        out["trace"] = dict(kernel=names[0], launches=b2["launches"],
                            device_ms=b2["device_us"] / 1e3, events_ms=events_ms,
                            window_ms=summary["window_us"] / 1e3,
                            busy_ms=summary["busy_us"] / 1e3, idle_share=summary["idle_share"],
                            device_events=summary["device_events"])

        # 2. --debug-nans: the same state with the flag as without; a seeded NaN
        # raises on B2's first pass
        debug = {}
        for engine, kernel in (("auto", "d2q9_kstep"), ("cuda-inplace", "d2q9_kstep_inplace")):
            runs = {}
            for flag in ([], ["--debug-nans"]):
                label = f"tooling: --engine {engine} {' '.join(flag)}".rstrip()
                runs[bool(flag)], _, _ = cli_run(
                    label, ["--engine", engine, "--out-dir", str(tmp / f"{engine}{len(flag)}"),
                            *flag], kernel)
            check(np.array_equal(runs[True].f_final, runs[False].f_final)
                  and np.array_equal(runs[True].av_vels, runs[False].av_vels),
                  f"--engine {engine} --debug-nans changed the run")
            cost_us = (runs[True].compute_seconds - runs[False].compute_seconds) / passes * 1e6
            print(f"tooling: --engine {engine} --debug-nans: state and av_vels bit-equal to the "
                  f"run without it; {runs[False].compute_seconds * 1e3:.4f} ms -> "
                  f"{runs[True].compute_seconds * 1e3:.4f} ms for {passes} launches, "
                  f"{cost_us:.2f} us a launch")
            debug[engine] = dict(ms=runs[False].compute_seconds * 1e3,
                                 debug_ms=runs[True].compute_seconds * 1e3, us_a_launch=cost_us)
        f_nan = state.initial_distributions(params, np.float32)
        f_nan[2, N // 3, N // 2] = np.nan
        f_nan, m_nan = state.to_torch(f_nan, mask, device="cuda")
        aw = d2q9.AccelWeights.from_params(params)
        d2q9_kstep.launches = 0
        previous = profiling.enable_nan_debugging(True)
        try:
            d2q9_kstep.run(f_nan, m_nan, num_steps=TOOLING_STEPS, k_steps=TOOLING_K,
                           omega=params.omega, accel_w1=aw.w1, accel_w2=aw.w2,
                           accel_row=N - 2)
            raised = None
        except FloatingPointError as err:
            raised = str(err)
        finally:
            profiling.enable_nan_debugging(previous)
        check(raised is not None and "steps 1-4 of kernel B2" in raised
              and d2q9_kstep.launches == 1,
              f"a seeded NaN under --debug-nans: {raised!r} after {d2q9_kstep.launches} launches"
              " (want FloatingPointError on B2's first pass)")
        print(f"tooling: a seeded NaN raised on B2's first pass: {raised}")
        out["debug_nans"] = debug

        # 3. the export pair on the card: the plain step, then the runner
        rc, text = run_cli(cli.main, ["--params", str(tmp / "p.params"), "--compile-only",
                                      "--export", str(tmp / "step.pt2")])
        print(f"tooling: --compile-only --export:\n{text.rstrip()}")
        check(rc == 0 and (tmp / "step.pt2").exists(), "--compile-only --export failed")
        rc, text = run_cli(lbm_runner.main, ["--exe", str(tmp / "step.pt2"), *files[:4],
                                             "--out-dir", str(tmp / "runner")])
        print(f"tooling: lbm_runner:\n{text.rstrip()}")
        check(rc == 0, f"lbm_runner returned {rc}")
        torch_run, _, _ = cli_run("tooling: --engine torch", ["--engine", "torch", "--out-dir",
                                                             str(tmp / "torch")])
        for name in ("av_vels.dat", "final_state.dat"):
            check((tmp / "runner" / name).read_bytes() == (tmp / "torch" / name).read_bytes(),
                  f"lbm_runner's {name} differs from --engine torch's")
        runner_av = lbm_io.read_av_vels(tmp / "runner" / "av_vels.dat")
        err = float(np.max(np.abs(runner_av - traced.av_vels) / np.abs(traced.av_vels)))
        check(err <= RUNNER_AV_BAR, f"lbm_runner's av_vels {err} from auto's > {RUNNER_AV_BAR}")
        runner_mlups = float(re.search(r"MLUPS:\s+([0-9.eE+-]+)", text).group(1))
        torch_mlups = N * N * TOOLING_STEPS / torch_run.compute_seconds / 1e6
        print(f"tooling: lbm_runner {runner_mlups} MLUPS (the torch engine {torch_mlups:.1f}); "
              f"outputs bit-equal to --engine torch's, av_vels max rel err {err:.3e} from auto's "
              f"(bar {RUNNER_AV_BAR})")
        out["runner"] = dict(mlups=runner_mlups, torch_mlups=torch_mlups, av_err=err)

        # 4. the native engine in float64 against B2, and 5. the native writers
        check(native_io.load() is not None,
              f"the native library did not build: {native_io.last_build_error}")
        ny, nx = NATIVE_SHAPE
        small = Params(**{**FLAGSHIP, "nx": nx, "ny": ny, "max_iters": NATIVE_STEPS})
        small.to_file(tmp / "s.params")
        Obstacles(random_mask(np.random.default_rng(20261018), ny, nx)).to_file(tmp / "s.dat")
        files = ["--params", str(tmp / "s.params"), "--obstacles", str(tmp / "s.dat"),
                 "--dtype", "float64"]
        native, text, _ = cli_run("tooling: --engine native", ["--engine", "native", "--out-dir",
                                                              str(tmp / "native")])
        print(f"tooling: --engine native at {ny}x{nx}, {NATIVE_STEPS} steps, float64:\n"
              f"{text.rstrip()}")
        cuda, _, _ = cli_run("tooling: --engine cuda", ["--engine", "cuda", "--out-dir",
                                                       str(tmp / "cuda")], "d2q9_kstep")
        err = float(np.max(np.abs(native.av_vels - cuda.av_vels) / np.abs(cuda.av_vels)))
        check(err <= NATIVE_AV_BAR, f"--engine native's av_vels {err} from cuda's > "
                                    f"{NATIVE_AV_BAR}")
        native_mlups = ny * nx * NATIVE_STEPS / native.compute_seconds / 1e6
        print(f"tooling: --engine native {native_mlups:.1f} MLUPS on the host, --engine cuda "
              f"{ny * nx * NATIVE_STEPS / cuda.compute_seconds / 1e6:.1f}; av_vels max rel err "
              f"{err:.3e} (bar {NATIVE_AV_BAR})")
        saved = lbm_io._try_native
        lbm_io._try_native = lambda: None  # the Python writer
        try:
            lbm_io.write_final_state(tmp / "python.dat", small,
                                     Obstacles.from_file(tmp / "s.dat", small).mask,
                                     native.f_final)
        finally:
            lbm_io._try_native = saved
        check((tmp / "python.dat").read_bytes()
              == (tmp / "native" / "final_state.dat").read_bytes(),
              "the native writer's final_state.dat differs from the Python writer's")
        print("tooling: the native writer's final_state.dat is byte-identical to the Python "
              "writer's")
        out["native"] = dict(mlups=native_mlups, av_err=err)
    return out


def phase_halo_bench():
    """Phase 7e's halo bench, in the NCCL group of one: every strategy at
    1024^2, 200 steps. Returns {strategy: MLUPS}."""
    from lbm_tpu_torch.cli import halo_bench

    rc, text = run_cli(halo_bench.main, ["--ny", str(N), "--nx", str(N), "-n",
                                         str(TOOLING_STEPS), "--num-devices", "1"])
    print(f"tooling: halo_bench --ny {N} --nx {N} -n {TOOLING_STEPS}:\n{text.rstrip()}")
    check(rc == 0, f"halo_bench returned {rc}")
    rows = [line.split(",") for line in text.strip().splitlines()[1:]]
    check([r[0] for r in rows] == ["implicit", "ppermute", "manytensors", "allgather", "naive"]
          and all(r[1] == "cuda" for r in rows), f"halo_bench rows: {rows}")
    return {r[0]: float(r[7]) for r in rows}


# ---------------------------------------------- bfloat16 storage and A9 ----

# a bfloat16 pass moves 9 (19) values in and out a cell and the mask byte
BF16_BYTES_2D = 2 * 9 * 2 + 1
BF16_BYTES_3D = 2 * 19 * 2 + 1
BF16_AV_BAR = 1e-4  # the bf16 flagship's av_vels[:100] against run_plain on the card
BF16_AV_PREFIX = 100
BF16_CK_STEPS = 400  # 2-D checkpointed bfloat16 runs: this many steps in two chunks
BF16_CK_SHAPE_3D = (32, 64, 128)
BF16_CK_STEPS_3D = 40


def bf16_held(torch, what, got, ref):
    """A bfloat16 kernel state against its plain version's: within one unit
    in the last place everywhere. The two round the same float32 pass once,
    and the plain version's bfloat16 route divides as the kernels do
    (`d2q9.collide_fields(tensor_scalars=True)`), so bit-equal is expected;
    the line says which held. Prints and returns (units, share that
    differs)."""
    torch.cuda.synchronize()
    check(got.dtype == torch.bfloat16 and ref.dtype == torch.bfloat16,
          f"{what}: not a bfloat16 state ({got.dtype}, {ref.dtype})")
    ulps = ulps_bf16(torch, got, ref)
    share = float((got.view(torch.int16) != ref.view(torch.int16)).float().mean())
    print(f"bf16 parity {what}: {ulps} unit(s) at most, {share:.3e} of values differ")
    check(ulps <= 1, f"{what}: {ulps} bfloat16 units from the plain version")
    return ulps, share


def bf16_bound(cells: int, bytes_a_cell: int, flops: float):
    t_bytes = bytes_a_cell * cells / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_bf16_2d(torch, mods):
    """B1, B2 and B3 on a bfloat16 state against `stepk_plain` on the card
    (1024^2 at K = 1, 2, 4, 8; 64x1001 at K = 4, edge tiles): within one
    unit, Sum|u| (float32) within the float32 bar, B1 == B2 == B3 bit for
    bit, each on the thread path. A9: B2 with shared_reciprocal in float32
    on both paths and in bfloat16 against the plain version's. Then each
    kernel's time a bfloat16 launch at 1024^2, K = 4, beside float32's.
    Returns {kernel: dict of its bfloat16 numbers}."""
    from lbm_tpu_torch.core import state
    d2q9_kstep, d2q9_kstep_inplace, d2q9_kstep_manual = mods
    names = ("d2q9_kstep", "d2q9_kstep_inplace", "d2q9_kstep_manual")
    rng = np.random.default_rng(20261018)
    aw = dict(omega=1.85, accel_w1=0.1 * 0.01 / 9, accel_w2=0.1 * 0.01 / 36)
    out = {name: {} for name in names}
    for (ny, nx), ks in (((N, N), (1, 2, 4, 8)), ((64, 1001), (4,))):
        f_np, mask_np = random_state(rng, ny, nx), random_mask(rng, ny, nx)
        f, mask = state.to_torch(f_np, mask_np, device="cuda", dtype=torch.bfloat16)
        for k in ks:
            kw = dict(k_steps=k, accel_row=ny - 2, **aw)
            ref_f, ref_tot = d2q9_kstep.stepk_plain(f, mask, **kw)
            got = {"d2q9_kstep": d2q9_kstep.stepk(f, mask, **kw),
                   "d2q9_kstep_inplace": d2q9_kstep_inplace.stepk(f.clone(), mask, **kw),
                   "d2q9_kstep_manual": d2q9_kstep_manual.stepk(f, mask, **kw)}
            for name, mod in zip(names, mods):
                check(mod.last_path == "thread", f"{name} bf16 took the {mod.last_path} path")
                kf, kt = got[name]
                ulps, share = bf16_held(torch, f"{name} {ny}x{nx} K={k} ({mod.last_path} path)",
                                        kf, ref_f)
                et = rel_err(kt, ref_tot)
                check(kt.dtype == torch.float32 and et <= BARS["float32"],
                      f"{name} bf16 K={k}: Sum|u| rel err {et} > {BARS['float32']}")
                if (ny, k) == (N, 4):
                    out[name].update(ulps=ulps, share=share, path=mod.last_path,
                                     max_abs_err=float((kf.float() - ref_f.float()).abs().max()))
            b2 = got["d2q9_kstep"]
            for name in names[1:]:
                check(torch.equal(got[name][0], b2[0]) and torch.equal(got[name][1], b2[1]),
                      f"{name} bf16 is not bit-equal to B2 ({ny}x{nx} K={k})")
            print(f"bf16 parity B1 == B2 == B3 bit for bit ({ny}x{nx} K={k}); Sum|u| within "
                  f"{BARS['float32']}")
        del f, ref_f, got, b2

    # A9: B2's shared_reciprocal (the collision takes 1/rho once)
    f_np, mask_np = random_state(rng, N, N), random_mask(rng, N, N)
    for dname, dtype, k in (("float32", torch.float32, 4), ("float32", torch.float32, 2),
                            ("bfloat16", torch.bfloat16, 4)):
        f, mask = state.to_torch(f_np, mask_np, device="cuda", dtype=dtype)
        kw = dict(k_steps=k, accel_row=N - 2, shared_reciprocal=True, **aw)
        ref_f, ref_tot = d2q9_kstep.stepk_plain(f, mask, **kw)
        kf, kt = d2q9_kstep.stepk(f, mask, **kw)
        path = d2q9_kstep.last_path
        if dtype == torch.bfloat16:
            bf16_held(torch, f"B2 shared_reciprocal K={k} ({path} path)", kf, ref_f)
        else:
            ef = rel_err(kf, ref_f)
            print(f"A9 B2 shared_reciprocal float32 K={k} ({path} path): state max rel err "
                  f"{ef:.3e} (bar {BARS['float32']})")
            check(ef <= BARS["float32"], f"B2 shared_reciprocal K={k}: state rel err {ef}")
            plain_f, _ = d2q9_kstep.stepk(f, mask, k_steps=k, accel_row=N - 2, **aw)
            check(not torch.equal(plain_f, kf),
                  "B2 with shared_reciprocal equals B2 without: the switch did nothing")
        et = rel_err(kt, ref_tot)
        check(et <= BARS["float32"], f"B2 shared_reciprocal {dname} K={k}: Sum|u| rel err {et}")
        out["d2q9_kstep"].setdefault("shared_reciprocal_paths", []).append(f"{dname} K={k} {path}")
    del f, ref_f, kf

    # time a bfloat16 launch of each at the main path's shape, beside float32's
    f_np, mask_np = random_state(rng, N, N), random_mask(rng, N, N)
    kw = dict(accel_row=N - 2, **aw)
    passes, k = 500, 4
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        f, mask = state.to_torch(f_np, mask_np, device="cuda", dtype=dtype)
        for name, mod in zip(names, mods):
            g = f.clone()
            t = time_ms(torch, lambda: mod.run(g, mask, num_steps=k * passes, k_steps=k, **kw),
                        1) / passes
            out[name][f"{dname}_ms"] = t
            print(f"bf16 timing {name:19s} {dname:8s}: {t:.4f} ms per K={k} launch "
                  f"({N * N * k / t / 1e3:.0f} MLUPS, {mod.last_path} path)")
    plain_ms = time_ms(torch, lambda: d2q9_kstep.stepk_plain(f, mask, k_steps=k, **kw), 10)
    bound = bf16_bound(N * N, BF16_BYTES_2D, FLOP_PER_CELL_STEP * k * N * N)
    for name in names:
        out[name].update(plain_ms=plain_ms, bound=bound, k_steps=k)
        print(f"bf16 timing {name:19s}: bound {bound[0]:.5f} ms ({bound[1]}: {BF16_BYTES_2D} B a "
              f"cell), plain version {plain_ms:.4f} ms")
    return out


def phase_bf16_main_path(torch, mods, mask, f32_mlups):
    """The flagship through `cli.lbm --engine auto --dtype bfloat16`
    (20,000 steps): the kernel `choose_engine` names for bfloat16 alone
    launched, never the plain engine; MLUPS beside float32's; av_vels[:100]
    against `run_plain` on the card within BF16_AV_BAR. Then checkpointed
    bfloat16 runs through `auto`, `cuda-inplace` and `cuda-manual`
    (BF16_CK_STEPS in two chunks, then resumed from the first): the resumed
    final state and av_vels equal the whole run's bit for bit. Returns
    {kernel: launches}, the picked kernel and the flagship's
    (seconds, mlups)."""
    from lbm_tpu_torch.cli import lbm as cli
    from lbm_tpu_torch.core import io as lbm_io
    from lbm_tpu_torch.core import state
    from lbm_tpu_torch.core.params import Obstacles, Params
    from lbm_tpu_torch.ops import d2q9, passes
    d2q9_kstep = mods[0]
    by_engine = engine_modules(mods)
    steps = FLAGSHIP["max_iters"]
    picked = d2q9_kstep.choose_engine(N, N, torch.bfloat16, num_steps=steps)
    mod = by_engine[picked]
    kernel = mod.__name__.rsplit(".", 1)[1]
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        params, obstacles = Params(**FLAGSHIP), Obstacles(mask)
        params.to_file(tmp / "input.params")
        obstacles.to_file(tmp / "obstacles.dat")
        base = ["--params", str(tmp / "input.params"), "--obstacles", str(tmp / "obstacles.dat"),
                "--dtype", "bfloat16"]
        for m in mods:
            m.launches = 0
        with CountCalls(d2q9, "collide_fields") as plain:
            rc, text = run_cli(cli.main, base + ["--engine", "auto", "--out-dir", str(tmp / "a")])
        print(f"bf16 main path --engine auto --dtype bfloat16:\n{text.rstrip()}")
        check(rc == 0, f"cli returned {rc}")
        check(re.search(rf"^engine:\s+{picked}$", text, re.M) is not None,
              f"--engine auto --dtype bfloat16 did not choose {picked}")
        check(mod.launches > 0 and all(m.launches == 0 for m in mods if m is not mod),
              f"--engine auto --dtype bfloat16 did not go through {kernel} alone")
        check(plain.calls == 0, f"bf16 main path: the plain engine ran {plain.calls} collisions")
        launches[kernel] = mod.launches
        seconds = float(re.search(r"Total compute time:\s+([0-9.eE+-]+)", text).group(1))
        mlups = float(re.search(r"MLUPS:\s+([0-9.eE+-]+)", text).group(1))
        print(f"bf16 main path ({kernel}, {mod.last_path} path): {mod.launches} launches, "
              f"{seconds:.6f} s timed, {mlups} MLUPS against float32's {f32_mlups} MLUPS "
              f"({mlups / f32_mlups:.3f} x)")
        av = lbm_io.read_av_vels(tmp / "a" / "av_vels.dat")
        check(av.shape == (steps,) and np.isfinite(av).all(), "bf16 av_vels.dat is malformed")
        # the plain version on the card over the prefix, from the same start
        p100 = Params(**{**FLAGSHIP, "max_iters": BF16_AV_PREFIX})
        f0, tmask = state.to_torch(state.initial_distributions(p100, torch.bfloat16), mask,
                                   device="cuda")
        def run_plain(f, mask, **kw):
            return passes.run_plain(d2q9_kstep.stepk_plain, f, mask, kernel="B2", **kw)

        _, plain_av = d2q9_kstep.simulate_with(run_plain, p100, f0, tmask)
        plain_av = plain_av.double().cpu().numpy()
        err = float(np.abs(av[:BF16_AV_PREFIX] - plain_av).max() / np.abs(plain_av).max())
        print(f"bf16 av_vels[:{BF16_AV_PREFIX}] vs run_plain on the card: max rel err {err:.3e} "
              f"(bar {BF16_AV_BAR})")
        check(err <= BF16_AV_BAR, f"bf16 av_vels prefix rel err {err} > {BF16_AV_BAR}")

        # checkpointed bfloat16 runs: resumed == whole, bit for bit
        n = BF16_CK_STEPS
        for engine in ("auto", "cuda-inplace", "cuda-manual"):
            m = by_engine[d2q9_kstep.choose_engine(N, N, torch.bfloat16, num_steps=n)
                          if engine == "auto" else engine]
            name = m.__name__.rsplit(".", 1)[1]
            for mm in mods:
                mm.launches = 0
            runs = {"whole": ["--num-steps", str(n)],
                    "part": ["--num-steps", str(n // 2)],
                    "resumed": ["--num-steps", str(n), "--resume"]}
            for label, extra in runs.items():
                d = tmp / f"ck_{engine}_{'whole' if label == 'whole' else 'part'}"
                rc, text = run_cli(cli.main, base + ["--engine", engine, "--out-dir", str(d),
                                                     "--checkpoint-every", str(n // 2), *extra])
                check(rc == 0, f"bf16 checkpointed cli ({engine}, {label}) returned {rc}")
            check(m.launches > 0 and all(mm.launches == 0 for mm in mods if mm is not m),
                  f"bf16 checkpointed --engine {engine} did not go through {name} alone")
            launches[name] = launches.get(name, 0) + m.launches
            whole, part = tmp / f"ck_{engine}_whole", tmp / f"ck_{engine}_part"
            with np.load(whole / "checkpoint.npz") as a, np.load(part / "checkpoint.npz") as b:
                check(a["f"].dtype == np.dtype("V2") and a["f"].tobytes() == b["f"].tobytes(),
                      f"bf16 --engine {engine}: the resumed lattice differs from the whole run's")
                check(np.array_equal(a["av_vels"], b["av_vels"]),
                      f"bf16 --engine {engine}: resumed av_vels differ from the whole run's")
            for fname in ("final_state.dat", "av_vels.dat"):
                check((whole / fname).read_bytes() == (part / fname).read_bytes(),
                      f"bf16 --engine {engine}: resumed {fname} differs from the whole run's")
            print(f"bf16 checkpoint 1024x1024 --engine {engine} ({name}, {m.launches} launches, "
                  f"{m.last_path} path): {n // 2} steps, resumed to {n}: the lattice (|V2), "
                  "av_vels and final_state.dat equal the whole run's bit for bit")
    return launches, kernel, (seconds, mlups)


def phase_bf16_3d(torch, mods3, modsb):
    """B4, B5, B6 and B7 on a bfloat16 state against `stepk_plain` on the
    card at 64x128x256 and 32x256x256 (B4, B6 at K = 1..4, B5, B7 at K = 1,
    2), within one unit (the float32 pass is bit-equal, so bit-equal is
    expected; the line says which held); B4 == B6, B5 == B7 bit for bit;
    B4's peak device memory; `ops.d3q19.simulate(dtype=torch.bfloat16)`
    through each engine (each kernel launched alone, never the plain engine,
    finite av_vels); a checkpointed bfloat16 run through B4, resumed, bit
    for bit. Then each kernel's time a bfloat16 pass beside float32's.
    Returns {kernel: dict of its bfloat16 numbers}."""
    from lbm_tpu_torch.core import state
    from lbm_tpu_torch.models import lbm3d as lbm3d_model
    from lbm_tpu_torch.ops import d3q19
    d3q19_kstep, d3q19_kstep_inplace = mods3
    d3q19_kstep_blocked, d3q19_kstep_inplace_blocked = modsb
    kernels = {"d3q19_kstep": d3q19_kstep, "d3q19_kstep_inplace": d3q19_kstep_inplace,
               "d3q19_kstep_blocked": d3q19_kstep_blocked,
               "d3q19_kstep_inplace_blocked": d3q19_kstep_inplace_blocked}
    out = {name: {"bit_equal": True} for name in kernels}
    rng = np.random.default_rng(20261019)
    for shape in (SHAPE_3D, SHAPE_BLOCKED):
        nz, ny, nx = shape
        f, mask = state.to_torch3d(random_state_3d(rng, nz, ny, nx),
                                   random_mask_3d(rng, nz, ny, nx), device="cuda",
                                   dtype=torch.bfloat16)
        for k in (1, 2, 3, 4):
            kw = dict(k_steps=k, accel_plane=nz - 2, **PHYSICS_3D)
            ref_f, ref_tot = d3q19_kstep.stepk_plain(f, mask, **kw)
            pairs = [("d3q19_kstep", "d3q19_kstep_inplace")]
            if k <= d3q19_kstep_blocked.PREFERRED_K:
                pairs.append(("d3q19_kstep_blocked", "d3q19_kstep_inplace_blocked"))
            for two, inplace in pairs:
                got = {}
                for name in (two, inplace):
                    mod = kernels[name]
                    g = f.clone() if name == inplace else f
                    kf, kt = mod.stepk(g, mask, **kw)
                    ulps, share = bf16_held(
                        torch, f"{name} {nz}x{ny}x{nx} K={k} ({mod.last_path} path)", kf, ref_f)
                    et = rel_err(kt, ref_tot)
                    check(kt.dtype == torch.float32 and et <= BARS["float32"],
                          f"{name} bf16 K={k}: Sum|u| rel err {et}")
                    out[name]["bit_equal"] &= ulps == 0
                    main = SHAPE_BLOCKED if "blocked" in name else SHAPE_3D
                    if shape == main and k == 2:
                        out[name].update(path=mod.last_path, max_abs_err=float(
                            (kf.float() - ref_f.float()).abs().max()))
                    got[name] = (kf, kt)
                # the state bit-equal; Sum|u| too where both take one block
                # (B5 and B7 may pick other tiles: Sum|u| in another order)
                check(torch.equal(got[two][0], got[inplace][0])
                      and ("blocked" in two or torch.equal(got[two][1], got[inplace][1])),
                      f"bf16 {inplace} is not bit-equal to {two} ({nz}x{ny}x{nx} K={k})")
                del got
            del ref_f
        # B4's device memory: the bfloat16 lattice, and a float32 scratch
        # lattice for K > 1 (19 x 4 B a cell beside the lattice's 19 x 2)
        g = f.clone()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        d3q19_kstep_inplace.run(g, mask, num_steps=8, k_steps=4, accel_plane=nz - 2,
                                **PHYSICS_3D)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        lattice = g.numel() * g.element_size()
        print(f"bf16 memory B4 run {nz}x{ny}x{nx} (K=4): allocated on top of the lattice "
              f"{extra} B, {extra / lattice:.4f} bfloat16 lattices (a float32 scratch is 2)")
        if shape == SHAPE_3D:
            out["d3q19_kstep_inplace"]["extra_lattices"] = extra / lattice
        del f, g
    for name, o in out.items():
        print(f"bf16 parity {name}: {'bit-equal' if o['bit_equal'] else 'within one unit'} "
              "to the plain version in every case")

    # the 3-D entry point in bfloat16, each engine's kernel alone
    launches = {}
    for engine, name, shape, steps in (
            ("cuda-inplace", "d3q19_kstep_inplace", SHAPE_3D, 48),
            ("cuda", "d3q19_kstep", SHAPE_3D, 48),
            ("cuda-inplace-blocked", "d3q19_kstep_inplace_blocked", SHAPE_BLOCKED, 48),
            ("cuda-blocked", "d3q19_kstep_blocked", SHAPE_BLOCKED, 48)):
        for m in kernels.values():
            m.launches = 0
        with CountCalls(d3q19, "collide_fields") as plain:
            f_final, av = d3q19.simulate(*shape, num_steps=steps, engine=engine,
                                         dtype=torch.bfloat16, device="cuda", **PHYSICS_3D)
        mod = kernels[name]
        check(f_final.dtype == torch.bfloat16 and torch.isfinite(av).all(),
              f"d3q19.simulate bf16 --engine {engine}: not a finite bfloat16 run")
        check(mod.launches > 0 and all(m.launches == 0 for m in kernels.values() if m is not mod),
              f"d3q19.simulate bf16 --engine {engine} did not go through {name} alone")
        check(plain.calls == 0, f"d3q19.simulate bf16 {engine}: the plain engine ran")
        launches[name] = mod.launches
        print(f"bf16 d3q19.simulate {'x'.join(map(str, shape))} x {steps} --engine {engine}: "
              f"{name} {mod.launches} launches ({mod.last_path} path), av_vels[-1] "
              f"{float(av[-1]):.6e}")

    # a checkpointed bfloat16 run through B4, resumed, against the whole run
    nz, ny, nx = BF16_CK_SHAPE_3D
    n = BF16_CK_STEPS_3D
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(checkpoint_every=n // 2, dtype=torch.bfloat16, engine="cuda-inplace",
                  device="cuda", **PHYSICS_3D)
        d3q19_kstep_inplace.launches = 0
        whole = lbm3d_model.run_simulation_with_checkpoints(
            nz, ny, nx, num_steps=n, checkpoint_path=Path(tmp) / "whole.npz", **kw)
        lbm3d_model.run_simulation_with_checkpoints(
            nz, ny, nx, num_steps=n // 2, checkpoint_path=Path(tmp) / "part.npz", **kw)
        resumed = lbm3d_model.run_simulation_with_checkpoints(
            nz, ny, nx, num_steps=n, checkpoint_path=Path(tmp) / "part.npz", resume=True, **kw)
        check(d3q19_kstep_inplace.launches > 0, "the bf16 3-D checkpointed run did not launch B4")
        check(torch.equal(whole[0], resumed[0]) and np.array_equal(whole[1], resumed[1]),
              "bf16 3-D: the resumed run differs from the whole run")
        launches["d3q19_kstep_inplace"] += d3q19_kstep_inplace.launches
        print(f"bf16 checkpoint 3-D {nz}x{ny}x{nx} (B4, {d3q19_kstep_inplace.launches} launches):"
              f" {n // 2} steps, resumed to {n}: state and av_vels equal the whole run's bit for "
              "bit")

    # time a pass of each, bfloat16 beside float32
    for shape, names, k in ((SHAPE_3D, ("d3q19_kstep", "d3q19_kstep_inplace"), 4),
                            (SHAPE_BLOCKED, ("d3q19_kstep_blocked", "d3q19_kstep_inplace_blocked"),
                             d3q19_kstep_blocked.PREFERRED_K)):
        nz, ny, nx = shape
        f_np, mask_np = random_state_3d(rng, nz, ny, nx), random_mask_3d(rng, nz, ny, nx)
        kw = dict(accel_plane=nz - 2, **PHYSICS_3D)
        passes = 100
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            f, mask = state.to_torch3d(f_np, mask_np, device="cuda", dtype=dtype)
            for name in names:
                mod = kernels[name]
                g = f.clone()
                t = time_ms(torch, lambda: mod.run(g, mask, num_steps=k * passes, k_steps=k,
                                                   **kw), 1) / passes
                out[name][f"{dname}_ms"] = t
                print(f"bf16 timing {name:27s} {dname:8s} {nz}x{ny}x{nx}: {t:.4f} ms per K={k} "
                      f"pass ({nz * ny * nx * k / t / 1e3:.0f} MLUPS, {mod.last_path} path)")
        plain_ms = time_ms(torch, lambda: d3q19_kstep.stepk_plain(f, mask, k_steps=k, **kw), 3)
        bound = bf16_bound(nz * ny * nx, BF16_BYTES_3D, FLOP_PER_CELL_STEP_3D * k * nz * ny * nx)
        for name in names:
            out[name].update(plain_ms=plain_ms, bound=bound, k_steps=k, launches=launches[name])
            print(f"bf16 timing {name:27s}: bound {bound[0]:.5f} ms ({bound[1]}: "
                  f"{BF16_BYTES_3D} B a cell), plain version {plain_ms:.4f} ms")
        if shape == SHAPE_3D:
            out["d3q19_kstep_inplace"]["ms_by_path"] = bf16_b4_paths(
                torch, d3q19_kstep_inplace, f, mask, k, passes, kw)
        del f, g
    return out


def bf16_b4_paths(torch, d3q19_kstep_inplace, f, mask, k, passes, kw):
    """B4's bfloat16 pass on its wave path (one launch a pass) and its step
    path (K launches through the float32 scratch): the state and Sum|u| of
    three passes bit-equal, then each path's ms a pass, in turns step, wave,
    wave, step. Returns {path: ms}."""
    got = {}
    for path in ("step", "wave"):
        g = f.clone()
        got[path] = d3q19_kstep_inplace.run(g, mask, num_steps=3 * k, k_steps=k, path=path, **kw)
        check(d3q19_kstep_inplace.last_path == path, f"bf16 B4 asked for {path}, ran "
              f"{d3q19_kstep_inplace.last_path}")
    check(torch.equal(got["wave"][0], got["step"][0]) and torch.equal(got["wave"][1],
                                                                      got["step"][1]),
          f"bf16 B4 K={k}: the wave path is not bit-equal to the step path")
    times = {"step": [], "wave": []}
    for path in ("step", "wave", "wave", "step"):
        g = f.clone()
        times[path].append(time_ms(torch, lambda: d3q19_kstep_inplace.run(
            g, mask, num_steps=k * passes, k_steps=k, path=path, **kw), 1) / passes)
    ms = {path: sum(t) / len(t) for path, t in times.items()}
    nz, ny, nx = f.shape[1:]
    print(f"bf16 timing d3q19_kstep_inplace by path {nz}x{ny}x{nx} K={k}: wave {ms['wave']:.4f}, "
          f"step {ms['step']:.4f} ms a pass ({100 * (ms['wave'] / ms['step'] - 1):+.1f}%); "
          "three passes' state and Sum|u| bit-equal")
    return ms


# phase 7g: B6's layouts at the 3-D bench shapes (f32), in float64 at a small
# shape, and in bfloat16 at the bench shape
LAYOUT_CASES = ((SHAPE_3D, 4), (SHAPE_BLOCKED, 2))
LAYOUT_F64_SHAPE = (8, 32, 64)
LAYOUT_PASSES = 100


def zmajor(t):
    """A q-major (19, nz, ny, nx) tensor as its z-major copy (nz, 19, ny, nx)."""
    return t.transpose(0, 1).contiguous()


def phase_layouts_3d(torch, mods3):
    """Phase 7g: B6 (`d3q19_kstep.stepk` / `run`) with layout='zmajor' and
    'fused' at 64x128x256 K = 4 and 32x256x256 K = 2 in float32 on each path
    (and K = 1, 3 at the bench shape), at 8x32x64 in float64, and in
    bfloat16 (the step path) at 64x128x256 K = 4: each pass bit-equal to
    the q-major pass once transposed, state and Sum|u|, and held to its
    plain version (`stepk_plain(layout=)`: float32 1e-5, float64 1e-12,
    bfloat16 one unit); the modes on z-major bit-equal to the q-major modes
    and held to the plain modes; `run` in each layout bit-equal to q-major.
    Then ms a pass in each layout beside q-major's in the same call (a chain
    of stepk passes, in the order q, z, fused, fused, z, q). Returns the
    launches of B6 in the phase and the times."""
    from lbm_tpu_torch.core import state
    d3q19_kstep = mods3[0]
    rng = np.random.default_rng(20261021)
    d3q19_kstep.launches = 0
    out = {"ms": {}}

    def held(what, got_f, got_t, ref_f, ref_t, bar):
        if got_f.dtype == torch.bfloat16:
            bf16_held(torch, what, got_f, ref_f)
            et = rel_err(got_t, ref_t)
            check(et <= BARS["float32"], f"{what}: Sum|u| rel err {et}")
            return
        ef, et = rel_err(got_f, ref_f), rel_err(got_t, ref_t)
        check(ef <= bar and et <= bar, f"{what}: state {ef}, Sum|u| {et} > {bar}")

    cases = [(shape, k, "float32", torch.float32) for shape, k in LAYOUT_CASES]
    cases += [(SHAPE_3D, k, "float32", torch.float32) for k in (1, 3)]
    cases += [(LAYOUT_F64_SHAPE, k, "float64", torch.float64) for k in (1, 2, 3, 4)]
    cases += [(SHAPE_3D, 4, "bfloat16", torch.bfloat16)]
    for (nz, ny, nx), k, dname, dtype in cases:
        f, mask = state.to_torch3d(random_state_3d(rng, nz, ny, nx),
                                   random_mask_3d(rng, nz, ny, nx), device="cuda", dtype=dtype)
        kw = dict(k_steps=k, accel_plane=nz - 2, **PHYSICS_3D)
        bar = BARS.get(dname, BARS["float32"])
        grid = f"{nz}x{ny}x{nx} {dname} K={k}"
        fz = zmajor(f)
        pz_f, pz_t = d3q19_kstep.stepk_plain(fz, mask, layout="zmajor", **kw)
        paths = ("step",) if dtype == torch.bfloat16 else d3q19_kstep.PATHS
        for path in paths:
            q_f, q_t = d3q19_kstep.stepk(f, mask, path=path, **kw)
            z_f, z_t = d3q19_kstep.stepk(fz, mask, path=path, layout="zmajor", **kw)
            check(d3q19_kstep.last_path == path, f"{grid}: z-major took {d3q19_kstep.last_path}")
            u_f, u_t = d3q19_kstep.stepk(f, mask, path=path, layout="fused", **kw)
            torch.cuda.synchronize()
            check(z_f.shape == (nz, 19, ny, nx), f"{grid}: z-major returned {tuple(z_f.shape)}")
            check(torch.equal(z_f.transpose(0, 1), q_f) and torch.equal(z_t, q_t),
                  f"{grid} {path} path: z-major is not bit-equal to q-major")
            check(torch.equal(u_f, q_f) and torch.equal(u_t, q_t),
                  f"{grid} {path} path: fused is not bit-equal to q-major")
            held(f"{grid} z-major ({path} path)", z_f, z_t, pz_f, pz_t, bar)
            print(f"layouts {grid} ({path} path): z-major and fused bit-equal to q-major, state "
                  f"and Sum|u|; z-major against its plain version: state "
                  f"{rel_err(z_f.float(), pz_f.float()):.3e} (bar {bar})")
            del q_f, z_f, u_f
        if (nz, ny, nx) == SHAPE_3D and k == 4 and dtype == torch.float32:
            for mode in ("stream_only", "copy", "collide_no_roll"):
                mkw = dict(kw, k_steps=2)
                m_q = d3q19_kstep.stepk(f, mask, mode=mode, **mkw)
                m_z = d3q19_kstep.stepk(fz, mask, mode=mode, layout="zmajor", **mkw)
                ref = d3q19_kstep.stepk_plain(f, mask, mode=mode, **mkw)
                torch.cuda.synchronize()
                what = f"{grid} mode {mode} (K=2, {d3q19_kstep.last_path} path)"
                check(torch.equal(m_z[0].transpose(0, 1), m_q[0]) and torch.equal(m_z[1], m_q[1]),
                      f"{what}: z-major is not bit-equal to q-major")
                if mode == "collide_no_roll":
                    check(rel_err(m_z[0].transpose(0, 1), ref[0]) <= bar, f"{what}: state")
                else:
                    check(torch.equal(m_z[0].transpose(0, 1), ref[0]), f"{what}: state")
                if mode != "copy":
                    check(rel_err(m_z[1], ref[1]) <= bar, f"{what}: Sum|u|")
                print(f"layouts {what}: z-major bit-equal to q-major and held to the plain mode")
        runs = {layout: d3q19_kstep.run(f, mask, num_steps=3 * k, k_steps=k, layout=layout,
                                        **{key: v for key, v in kw.items() if key != "k_steps"})
                for layout in d3q19_kstep.LAYOUTS}
        for layout in ("zmajor", "fused"):
            check(all(torch.equal(a, b) for a, b in zip(runs[layout], runs["qmajor"])),
                  f"{grid}: run(layout={layout!r}) is not bit-equal to q-major's")
        print(f"layouts {grid}: run() of 3 passes in each layout bit-equal to q-major's")
        del f, fz, pz_f, runs
    out["launches"] = d3q19_kstep.launches

    # ms a pass: a chain of stepk passes in each layout, the turns
    # q, z, fused, fused, z, q, each layout's mean of its two turns
    timed = [(shape, k, "float32", torch.float32) for shape, k in LAYOUT_CASES]
    for (nz, ny, nx), k, dname, dtype in timed + [(SHAPE_3D, 4, "bfloat16", torch.bfloat16)]:
        f, mask = state.to_torch3d(random_state_3d(rng, nz, ny, nx),
                                   random_mask_3d(rng, nz, ny, nx), device="cuda", dtype=dtype)
        kw = dict(k_steps=k, accel_plane=nz - 2, **PHYSICS_3D)
        states = {"qmajor": f, "zmajor": zmajor(f), "fused": f.clone()}

        def chain(layout):
            cur = states[layout]
            for _ in range(LAYOUT_PASSES):
                cur = d3q19_kstep.stepk(cur, mask, layout=layout, **kw)[0]
            return cur

        turns = {layout: [] for layout in states}
        for layout in ("qmajor", "zmajor", "fused", "fused", "zmajor", "qmajor"):
            turns[layout].append(time_ms(torch, lambda: chain(layout), 1) / LAYOUT_PASSES)
        path = d3q19_kstep.last_path
        grid = f"{nz}x{ny}x{nx} {dname} K={k}"
        ms = {layout: sum(t) / len(t) for layout, t in turns.items()}
        out["ms"][grid] = dict(ms, path=path, turns=turns)
        print(f"layouts timing {grid} ({path} path): ms a pass q-major {ms['qmajor']:.4f}, "
              f"z-major {ms['zmajor']:.4f} ({ms['zmajor'] / ms['qmajor']:.4f} x), fused "
              f"{ms['fused']:.4f} ({ms['fused'] / ms['qmajor']:.4f} x); turns {turns}")
        del f, states
    return out


# phase 7h: bfloat16 on the multi-device engines at world size 1
BF16_SHARDED_STEPS = 10000
BF16_SHARDED_SHORT = 2000
BF16_SHARDED_PLAIN = (256, 256, 200)  # ny, nx, steps of the plain 'sharded' engine
BF16_SHARDED_CK_STEPS = 400
BF16_SHARDED_3D_CK_STEPS = 200
BF16_SHARDED_AV_BAR = 1e-5  # against the single-device run: Sum|u| (float32) in another order


def bf16_units(torch, a, b) -> int:
    """Largest distance in bfloat16 units between two arrays of values that
    bfloat16 holds (float64 numpy arrays of bfloat16 values)."""
    return ulps_bf16(torch, torch.from_numpy(a).to(torch.bfloat16),
                     torch.from_numpy(b).to(torch.bfloat16))


def phase_bf16_sharded(torch, mods, mods3, modsb, mask):
    """Phase 7h: bfloat16 on the multi-device engines at world size 1, in the
    NCCL group of `nccl_world_of_one`. The flagship (the golden blob's mask,
    omega 1.85) through `run_simulation_sharded(engine='sharded-cuda',
    dtype=torch.bfloat16)`, 10,000 steps; `overlap=True` and B2 as the local
    kernel (`kstep_sharded.simulate(local_engine='two-stream')`), 2,000; the
    plain `sharded` engine (ppermute) at 256x256 x 200; a checkpointed
    `sharded-cuda` run resumed. 3-D: `sharded-cuda` at 64x128x256 x 1,200,
    with overlap, `sharded-cuda-zy` on a (1, 1) mesh, and a checkpointed
    z-mesh run resumed. Each state bit-equal to the single-device bfloat16
    run of the same local kernel (`cuda-inplace`: B1, B4; the torch engine
    for the plain engine), av_vels within 1e-5 (the plain engine within two
    units), each run's kernel alone launched, never the plain engine; the
    resumes bit for bit. Prints MLUPS beside the single-device engine's and
    a chunk's device and host ms. Returns the launches and the numbers."""
    from lbm_tpu_torch.core import state
    from lbm_tpu_torch.core.params import Obstacles, Params
    from lbm_tpu_torch.models import lbm as lbm_model
    from lbm_tpu_torch.models import lbm3d as lbm3d_model
    from lbm_tpu_torch.ops import d2q9, d3q19
    from lbm_tpu_torch.parallel import kstep_sharded, kstep_sharded_3d as ks3
    bf16 = torch.bfloat16
    every = (*mods, *mods3, *modsb)
    names = [m.__name__.rsplit(".", 1)[1] for m in every]
    out = {"launches": dict.fromkeys(names, 0), "runs": {}}

    def reset():
        for m in every:
            m.launches = 0

    def alone(label, name):
        """Checks that `name` alone launched since reset(); adds its launches."""
        counts = {n: m.launches for n, m in zip(names, every)}
        check(counts[name] > 0 and sum(counts.values()) == counts[name],
              f"{label}: not {name} alone: {counts}")
        out["launches"][name] += counts[name]
        return counts[name], every[names.index(name)].last_path

    def av_err(got, want):
        return float(np.max(np.abs(got[1:] - want[1:]) / np.abs(want[1:])))

    obstacles = Obstacles(mask)
    refs = {}
    for steps in (BF16_SHARDED_STEPS, BF16_SHARDED_SHORT):
        params = Params(**{**FLAGSHIP, "max_iters": steps})
        refs[steps] = lbm_model.run_simulation(params, obstacles, dtype=bf16,
                                               engine="cuda-inplace", device="cuda")
        mlups = N * N * steps / refs[steps].compute_seconds / 1e6
        print(f"bf16 sharded: --engine cuda-inplace --dtype bfloat16 (B1) reference, {steps} "
              f"steps: {refs[steps].compute_seconds:.6f} s, {mlups:.1f} MLUPS")
        out["runs"][f"cuda-inplace {steps}"] = dict(mlups=mlups,
                                                    seconds=refs[steps].compute_seconds)
    for label, steps, kw in (("sharded-cuda", BF16_SHARDED_STEPS, {}),
                             ("sharded-cuda --overlap", BF16_SHARDED_SHORT, {"overlap": True})):
        params, ref = Params(**{**FLAGSHIP, "max_iters": steps}), refs[steps]
        reset()
        with CountCalls(d2q9, "collide_fields") as plain:
            res = lbm_model.run_simulation_sharded(params, obstacles, dtype=bf16,
                                                   engine="sharded-cuda", num_devices=1,
                                                   device="cuda", **kw)
        launches, path = alone(label, "d2q9_kstep_inplace")
        check(plain.calls == 0, f"{label}: the plain engine ran {plain.calls} collisions")
        check(res.f_final.dtype == bf16 and torch.equal(res.f_final, ref.f_final),
              f"{label} bf16: the final state differs from cuda-inplace's")
        err = av_err(res.av_vels, ref.av_vels)
        check(err <= BF16_SHARDED_AV_BAR, f"{label} bf16: av_vels rel err {err}")
        mlups = N * N * steps / res.compute_seconds / 1e6
        ref_mlups = out["runs"][f"cuda-inplace {steps}"]["mlups"]
        print(f"bf16 sharded: {label} --dtype bfloat16, {N}x{N} x {steps}: B1 {launches} "
              f"launches on the {path} path, {res.compute_seconds:.6f} s timed, {mlups:.1f} "
              f"MLUPS against cuda-inplace's {ref_mlups:.1f} ({mlups / ref_mlups:.4f} x); state "
              f"bit-equal to cuda-inplace's, av_vels[1:] max rel err {err:.3e}")
        out["runs"][label] = dict(launches=launches, path=path, mlups=mlups, av_err=err,
                                  seconds=res.compute_seconds, ref_mlups=ref_mlups)

    # B2 as the local kernel
    params = Params(**{**FLAGSHIP, "max_iters": BF16_SHARDED_SHORT})
    f0 = state.initial_distributions(params, bf16)
    mesh = kstep_sharded.make_row_mesh()
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_b2, av_b2 = kstep_sharded.simulate(params, f0, mask, mesh, local_engine="two-stream")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, path = alone("the two-stream ghost-band run", "d2q9_kstep")
    check(torch.equal(f_b2.cpu(), refs[BF16_SHARDED_SHORT].f_final),
          "bf16 ghost-band run on B2: the state differs from cuda-inplace's")
    err = av_err(av_b2.double().cpu().numpy(), refs[BF16_SHARDED_SHORT].av_vels)
    check(err <= BF16_SHARDED_AV_BAR, f"bf16 ghost-band run on B2: av_vels rel err {err}")
    mlups = N * N * BF16_SHARDED_SHORT / seconds / 1e6
    print(f"bf16 sharded: ghost-band run on B2 (two-stream), {BF16_SHARDED_SHORT} steps: "
          f"{launches} launches on the {path} path, {mlups:.1f} MLUPS on the host's clock (the "
          f"first call); state bit-equal to cuda-inplace's, av_vels rel err {err:.3e}")
    out["runs"]["two-stream"] = dict(launches=launches, path=path, mlups=mlups, av_err=err)

    # a chunk of the bfloat16 ghost-band run: device and host ms
    aw = d2q9.AccelWeights.from_params(params)
    f_sh, mask_ext, _ = kstep_sharded.prepare(params, f0, mask, mesh)
    chunk = kstep_sharded.make_chunk_fn(mesh, k_steps=4, omega=params.omega, accel_w1=aw.w1,
                                        accel_w2=aw.w2, accel_row=N - 2, ny=N)
    chunk.start(f_sh.to_local(), mask_ext.to_local())
    tots = torch.empty(4, device=chunk.buf.device)
    n = SHARDED_TIMING_CHUNKS
    chunk_ms = time_ms(torch, lambda: chunk(tots), n)
    t0 = time.perf_counter()
    for _ in range(n):
        chunk(tots)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    print(f"bf16 sharded: a bfloat16 chunk (K=4, B1 on the {chunk.buf.dtype} extended block) "
          f"{chunk_ms:.4f} ms on the device's clock, {host_ms:.4f} ms on the host's")
    out["chunk_2d"] = dict(chunk_ms=chunk_ms, host_ms=host_ms)
    del chunk, f_sh

    # the plain engine, every operation in bfloat16, against the torch engine
    ny, nx, steps = BF16_SHARDED_PLAIN
    small = Params(nx=nx, ny=ny, max_iters=steps, reynolds_dim=10, density=0.1, accel=0.01,
                   omega=1.85)
    small_obs = Obstacles(random_mask(np.random.default_rng(20261022), ny, nx))
    ref = lbm_model.run_simulation(small, small_obs, dtype=bf16, engine="torch", device="cuda")
    reset()
    res = lbm_model.run_simulation_sharded(small, small_obs, dtype=bf16, engine="sharded",
                                           strategy="ppermute", num_devices=1, device="cuda")
    check(sum(m.launches for m in every) == 0, "the plain 'sharded' engine launched a kernel")
    check(torch.equal(res.f_final, ref.f_final),
          "bf16 --engine sharded: the state differs from the torch engine's")
    units = bf16_units(torch, res.av_vels, ref.av_vels)
    check(units <= 2, f"bf16 --engine sharded: av_vels {units} units from the torch engine's")
    mlups = ny * nx * steps / res.compute_seconds / 1e6
    ref_mlups = ny * nx * steps / ref.compute_seconds / 1e6
    print(f"bf16 sharded: --engine sharded --strategy ppermute --dtype bfloat16, {ny}x{nx} x "
          f"{steps}: {mlups:.1f} MLUPS against the torch engine's {ref_mlups:.1f}; state "
          f"bit-equal, av_vels {units} unit(s) from the torch engine's")
    out["runs"]["sharded ppermute"] = dict(mlups=mlups, ref_mlups=ref_mlups, av_units=units)

    # a checkpointed sharded-cuda run, resumed
    n = BF16_SHARDED_CK_STEPS
    params = Params(**{**FLAGSHIP, "max_iters": n})
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        kw = dict(dtype=bf16, engine="sharded-cuda", num_devices=1, device="cuda",
                  checkpoint_every=n // 2)
        reset()
        whole = lbm_model.run_simulation_with_checkpoints(params, obstacles,
                                                          checkpoint_path=tmp / "w.npz", **kw)
        lbm_model.run_simulation_with_checkpoints(params, obstacles, num_steps=n // 2,
                                                  checkpoint_path=tmp / "p.npz", **kw)
        resumed = lbm_model.run_simulation_with_checkpoints(
            params, obstacles, checkpoint_path=tmp / "p.npz", resume=True, **kw)
        launches, path = alone("checkpointed sharded-cuda bf16", "d2q9_kstep_inplace")
        check(resumed.steps_run == n // 2 and torch.equal(resumed.f_final, whole.f_final)
              and np.array_equal(resumed.av_vels, whole.av_vels),
              "bf16 checkpointed sharded-cuda: the resumed run differs from the whole run")
        with np.load(tmp / "w.npz") as a, np.load(tmp / "p.npz") as b:
            check(a["f"].dtype == np.dtype("V2") and a["f"].tobytes() == b["f"].tobytes(),
                  "bf16 checkpointed sharded-cuda: the resumed lattice differs")
        print(f"bf16 sharded: --engine sharded-cuda --checkpoint-every {n // 2}, {n // 2} steps "
              f"resumed to {n}: state, av_vels and the lattice (|V2) bit-equal to the whole "
              f"run's; B1 {launches} launches")

    # 3-D: the bench shape on a z-mesh, with overlap, and a (1, 1) mesh
    nz, ny, nx = SHAPE_3D
    steps, cells = STEPS_3D, nz * ny * nx
    ref3 = None
    for label, kw in (("sharded-cuda", {}), ("sharded-cuda --overlap", {"overlap": True}),
                      ("sharded-cuda-zy --mesh-shape 1 1",
                       {"engine": "sharded-cuda-zy", "mesh_shape": (1, 1)})):
        reset()
        with CountCalls(d3q19, "collide_fields") as plain:
            res = lbm3d_model.run_simulation_sharded(
                nz, ny, nx, num_steps=steps, dtype=bf16, num_devices=1, device="cuda",
                **{"engine": "sharded-cuda", **kw}, **PHYSICS_3D)
        launches, path = alone(f"3-D {label}", "d3q19_kstep_inplace")
        check(plain.calls == 0, f"3-D {label} bf16: the plain engine ran")
        if ref3 is None:
            k3 = res.k_steps
            f, m3 = d3q19.initial_state(nz, ny, nx, density=PHYSICS_3D["density"], dtype=bf16,
                                        device="cuda")
            kw3 = dict(num_steps=steps, engine="cuda-inplace", k_steps=k3, **PHYSICS_3D)
            d3q19.advance(f.clone(), m3, **kw3)  # warm-up
            g = f.clone()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ref_f, ref_av = d3q19.advance(g, m3, **kw3)
            end.record()
            end.synchronize()
            ref3_mlups = cells * steps / (start.elapsed_time(end) / 1e3) / 1e6
            ref3 = (ref_f.cpu(), ref_av.double().cpu().numpy())
            print(f"bf16 sharded 3-D: cuda-inplace --dtype bfloat16 (B4) reference at "
                  f"{nz}x{ny}x{nx} x {steps} (K={k3}): {ref3_mlups:.1f} MLUPS")
            out["runs"]["3-D cuda-inplace"] = dict(mlups=ref3_mlups, k_steps=k3)
            reset()
        check(res.k_steps == k3, f"3-D {label} ran at K={res.k_steps}, not {k3}")
        check(res.f_final.dtype == bf16 and torch.equal(res.f_final, ref3[0]),
              f"3-D {label} bf16: the state differs from cuda-inplace's")
        err = av_err(res.av_vels, ref3[1])
        check(err <= BF16_SHARDED_AV_BAR, f"3-D {label} bf16: av_vels[1:] rel err {err}")
        mlups = cells * steps / res.compute_seconds / 1e6
        print(f"bf16 sharded 3-D: {label} --dtype bfloat16 at {nz}x{ny}x{nx} x {steps}: B4 "
              f"{launches} launches on the {path} path (K={res.k_steps}), {mlups:.1f} MLUPS "
              f"against cuda-inplace's {ref3_mlups:.1f} ({mlups / ref3_mlups:.4f} x); state "
              f"bit-equal, av_vels[1:] max rel err {err:.3e}")
        out["runs"][f"3-D {label}"] = dict(launches=launches, path=path, mlups=mlups,
                                           av_err=err, ref_mlups=ref3_mlups)

    # a checkpointed bfloat16 z-mesh run, resumed
    n = BF16_SHARDED_3D_CK_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        kw = dict(checkpoint_every=n // 2, engine="sharded-cuda", dtype=bf16, num_devices=1,
                  device="cuda", **PHYSICS_3D)
        reset()
        whole = lbm3d_model.run_simulation_with_checkpoints(
            nz, ny, nx, num_steps=n, checkpoint_path=tmp / "w.npz", **kw)
        lbm3d_model.run_simulation_with_checkpoints(
            nz, ny, nx, num_steps=n // 2, checkpoint_path=tmp / "p.npz", **kw)
        resumed = lbm3d_model.run_simulation_with_checkpoints(
            nz, ny, nx, num_steps=n, checkpoint_path=tmp / "p.npz", resume=True, **kw)
        launches, path = alone("3-D checkpointed sharded-cuda bf16", "d3q19_kstep_inplace")
        check(resumed[3] == n // 2 and torch.equal(resumed[0], whole[0])
              and np.array_equal(resumed[1], whole[1]),
              "bf16 3-D checkpointed sharded-cuda: the resumed run differs from the whole run")
        print(f"bf16 sharded 3-D: checkpointed z-mesh run, {n // 2} steps resumed to {n}: state "
              f"and av_vels bit-equal to the whole run's; B4 {launches} launches")

    # a chunk of the bfloat16 ghost-plane run: device and host ms
    k = out["runs"]["3-D cuda-inplace"]["k_steps"]
    mesh3 = ks3.make_z_mesh(1)
    mask3 = d3q19.default_obstacle_mask(nz, ny, nx)
    f0 = d3q19.initial_distributions(nz, ny, nx, PHYSICS_3D["density"], bf16)
    f_sh, mask_ext = ks3.prepare(f0, mask3, mesh3, k_steps=k, density=PHYSICS_3D["density"])
    chunk = ks3.make_chunk_fn(mesh3, k_steps=k, accel_plane=nz - 2, nz=nz, **PHYSICS_3D)
    chunk.start(f_sh.to_local(), mask_ext.to_local())
    tots = torch.empty(k, device=chunk.buf.device)
    n = SHARDED_TIMING_CHUNKS
    chunk_ms = time_ms(torch, lambda: chunk(tots), n)
    t0 = time.perf_counter()
    for _ in range(n):
        chunk(tots)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    print(f"bf16 sharded 3-D: a bfloat16 chunk (K={k}, B4 on the extended slab) {chunk_ms:.4f} "
          f"ms on the device's clock, {host_ms:.4f} ms on the host's")
    out["chunk_3d"] = dict(chunk_ms=chunk_ms, host_ms=host_ms)
    return out


def grouping_child() -> int:
    """Run in a process with LBM_D3Q19_GROUPING=reference (`phase_grouping`):
    B4, B5, B6 and B7 in float32 at the per-speed grouping against the plain
    per-speed step; the state must also differ from the paired grouping's.
    Prints one JSON line."""
    import torch

    sys.path.insert(0, str(REPO))
    from lbm_tpu_torch.core import state
    from lbm_tpu_torch.ops import (d3q19, d3q19_kstep, d3q19_kstep_blocked, d3q19_kstep_inplace,
                                   d3q19_kstep_inplace_blocked)
    check(d3q19.GROUPING != "paired" and d3q19.kernel_variant() == "per_speed",
          f"the child runs the {d3q19.GROUPING} grouping")
    result = {}
    rng = np.random.default_rng(20261020)
    for shape, mods, k in ((SHAPE_3D, (d3q19_kstep, d3q19_kstep_inplace), 4),
                           (SHAPE_BLOCKED, (d3q19_kstep_blocked, d3q19_kstep_inplace_blocked), 2)):
        nz, ny, nx = shape
        f, mask = state.to_torch3d(random_state_3d(rng, nz, ny, nx),
                                   random_mask_3d(rng, nz, ny, nx), device="cuda",
                                   dtype=torch.float32)
        kw = dict(k_steps=k, accel_plane=nz - 2, **PHYSICS_3D)
        ref_f, ref_tot = d3q19_kstep.stepk_plain(f, mask, **kw)
        d3q19.GROUPING = "paired"
        paired_f, _ = d3q19_kstep.stepk_plain(f, mask, **kw)
        d3q19.GROUPING = "reference"
        for mod in mods:
            g = f.clone()
            kf, kt = mod.stepk(g, mask, **kw)
            torch.cuda.synchronize()
            name = mod.__name__.rsplit(".", 1)[1]
            result[name] = dict(
                shape=list(shape), k=k, path=mod.last_path,
                state_rel_err=rel_err(kf, ref_f), tot_rel_err=rel_err(kt, ref_tot),
                bit_equal=bool(torch.equal(kf, ref_f)),
                differs_from_paired=not torch.equal(kf, paired_f),
                max_abs_from_paired=float((kf - paired_f).abs().max()))
        del f, ref_f, paired_f, g
    print(json.dumps({"grouping": d3q19.GROUPING, "kernels": result}))
    return 0


def phase_grouping(torch):
    """A9: the per-speed D3Q19 grouping on the card, in a process with
    LBM_D3Q19_GROUPING=reference (the grouping is fixed at import, as in the
    JAX package): its library (the per_speed build variant) built and each of
    B4-B7 within the float32 bar of the plain per-speed step, and not equal
    to the paired grouping's state. Returns the child's numbers."""
    env = dict(os.environ, LBM_D3Q19_GROUPING="reference")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "sys.exit(chip_smoke.grouping_child())")
    res = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, env=env, timeout=600, cwd=str(REPO))
    check(res.returncode == 0, f"the grouping child failed ({res.returncode}):\n"
                               f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    got = json.loads(res.stdout.strip().splitlines()[-1])
    for name, r in got["kernels"].items():
        print(f"A9 grouping {got['grouping']}: {name} {'x'.join(map(str, r['shape']))} "
              f"K={r['k']} float32 ({r['path']} path): state max rel err "
              f"{r['state_rel_err']:.3e} ({'bit-equal' if r['bit_equal'] else 'not bit-equal'}"
              f"), Sum|u| {r['tot_rel_err']:.3e}; differs from the paired grouping by up to "
              f"{r['max_abs_from_paired']:.3e}")
        check(r["state_rel_err"] <= BARS["float32"] and r["tot_rel_err"] <= BARS["float32"],
              f"A9 grouping: {name} off the plain per-speed step")
        check(r["differs_from_paired"], f"A9 grouping: {name} equals the paired grouping")
    return got["kernels"]


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
        # with the per-speed grouping's libraries of the 3-D sources, which the
        # A9 phase's child process loads
        variants = {"d3q19_kstep": ["per_speed"], "d3q19_blocked": ["per_speed"]}
        for name, lib_path in _build.build_all(variants).items():
            if ":" not in name:
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
        phase_paths_3d(torch)
        ms3, plain_ms3, bound3, ms3_paths, paths_ms3 = phase_timing_3d(torch, mods3, k3)
        paths3 = phase_main_path_3d(torch, mods3)
        phase_golden_3d(torch)
        ck_launches = phase_checkpoint(torch, mods, mods3, mask)
        tooling = phase_tooling(torch, mods, mask)
        with nccl_world_of_one(torch):
            sharded = phase_sharded(torch, mods, golden, mask, stencil)
            sharded3 = phase_sharded_3d(torch, mods3, modsb)
            tooling["halo_bench_mlups"] = phase_halo_bench()
            bf16_sharded = phase_bf16_sharded(torch, mods, mods3, modsb, mask)

        abs_err_b = phase_parity_blocked(torch, mods3, modsb)
        phase_paths_blocked(torch)
        ms_b, plain_ms_b, bound_b, paths_ms_b = phase_timing_blocked(torch, mods3, modsb)
        paths_b = phase_main_path_blocked(torch, mods3, modsb)
        phase_golden_blocked(torch)
        ck_launches["d3q19_kstep_inplace_blocked"] = phase_checkpoint_blocked(torch, mods3, modsb)

        bf16_2d = phase_bf16_2d(torch, mods)
        bf16_launches, bf16_kernel, bf16_flagship = phase_bf16_main_path(
            torch, mods, mask, flagship["auto"][2])
        bf16_3d = phase_bf16_3d(torch, mods3, modsb)
        layouts = phase_layouts_3d(torch, mods3)
        grouping = phase_grouping(torch)

        abs_err_blur = phase_blur_parity(torch, stencil)
        times_blur = phase_blur_timing(torch, stencil)
        paths_blur = phase_blur_main_path(torch, stencil)

        overlap = phase_overlap(torch, overlap_probe, card)
        resident_opt = phase_blur_resident_opt(torch, blur_resident_opt, stencil, card)
    except Failure as err:
        print(f"chip_smoke FAILED: {err}", file=sys.stderr)
        return 1

    def bf16_entry(o, launches, **extra):
        """A kernel's bfloat16 numbers: ms a pass beside float32's in the same
        call, the bound of a bfloat16 pass, its path and launches."""
        return {"ms": o["bfloat16_ms"], "float32_ms_same_call": o["float32_ms"],
                "plain_ms": o["plain_ms"], "bound_ms": o["bound"][0], "bound_by": o["bound"][1],
                "k_steps": o["k_steps"], "path": o.get("path"), "launches": launches,
                "max_abs_err": o.get("max_abs_err"), **extra}

    def bf16_sharded_entry(name, labels):
        """A kernel's launches and runs in the bfloat16 multi-device phase."""
        return {"launches": bf16_sharded["launches"][name],
                "runs": {label: bf16_sharded["runs"][label] for label in labels}}

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
        **({"sharded_launches": sharded["fused"]["launches"] + sharded["overlap"]["launches"],
            "sharded_path": sharded["fused"]["path"],
            "sharded_cuda_mlups": sharded["fused"]["mlups"],
            "sharded_cuda_overlap_mlups": sharded["overlap"]["mlups"]}
           if name == "d2q9_kstep_inplace" else {}),
        **({"sharded_launches": sharded["two_stream"]["launches"],
            "sharded_path": sharded["two_stream"]["path"]} if name == "d2q9_kstep" else {}),
        "tooling_launches": tooling["launches"][name],
        **({"tooling": {k: v for k, v in tooling.items() if k != "launches"}}
           if name == "d2q9_kstep" else {}),
        "bf16": bf16_entry(
            bf16_2d[name], bf16_launches.get(name, 0),
            ulps=bf16_2d[name]["ulps"], share_differing=bf16_2d[name]["share"],
            **({"flagship_seconds": bf16_flagship[0], "flagship_mlups": bf16_flagship[1]}
               if name == bf16_kernel else {})),
        **({"shared_reciprocal": bf16_2d[name]["shared_reciprocal_paths"]}
           if name == "d2q9_kstep" else {}),
        **({"bf16_sharded": bf16_sharded_entry(name, [
            f"cuda-inplace {BF16_SHARDED_STEPS}", "sharded-cuda", "sharded-cuda --overlap"]),
            "bf16_sharded_chunk": bf16_sharded["chunk_2d"]}
           if name == "d2q9_kstep_inplace" else {}),
        **({"bf16_sharded": bf16_sharded_entry(name, ["two-stream", "sharded ppermute"])}
           if name == "d2q9_kstep" else {}),
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
        "main_path_mlups": paths3[name][2], "path": paths3[name][3],
        "ms_by_path": ms3_paths[name], "timed_path": paths_ms3[name],
        "main_path_32x256x256": dict(zip(("launches", "seconds", "mlups", "path"),
                                         paths_b[f"{name} 32x256x256"])),
        "checkpoint_launches": ck_launches.get(name, 0),
        **({"sharded_launches": sum(r["launches"] for r in sharded3["runs"].values())
                                + sharded3["checkpoint_launches"],
            "sharded_path": sharded3["runs"][SHARDED_3D_FUSED]["path"],
            "sharded_cuda_mlups": sharded3["runs"][SHARDED_3D_FUSED]["mlups"],
            "sharded_cuda_mlups_by_run": {k: r["mlups"] for k, r in sharded3["runs"].items()},
            "sharded_chunk": sharded3["chunk"]}
           if name == "d3q19_kstep_inplace" else
           {"sharded_launches": sharded3["two_stream"]["launches"],
            "sharded_path": sharded3["two_stream"]["path"],
            "sharded_cuda_mlups": sharded3["two_stream"]["mlups"]}),
        "bf16": bf16_entry(bf16_3d[name], bf16_3d[name]["launches"],
                           bit_equal=bf16_3d[name]["bit_equal"],
                           **{key: bf16_3d[name][key] for key in ("extra_lattices", "ms_by_path")
                              if key in bf16_3d[name]}),
        "grouping_per_speed": grouping[name],
        **({"bf16_sharded": bf16_sharded_entry(name, [
            "3-D cuda-inplace", "3-D sharded-cuda", "3-D sharded-cuda --overlap",
            "3-D sharded-cuda-zy --mesh-shape 1 1"]),
            "bf16_sharded_chunk": bf16_sharded["chunk_3d"]}
           if name == "d3q19_kstep_inplace" else
           {"layouts": {"launches": layouts["launches"], "ms_a_pass": layouts["ms"]}}),
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
        "bf16": bf16_entry(bf16_3d[name], bf16_3d[name]["launches"],
                           bit_equal=bf16_3d[name]["bit_equal"]),
        "grouping_per_speed": grouping[name],
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
