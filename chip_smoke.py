#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (lbm_tpu_torch) runs on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. prints the card's name and power limit; builds the CUDA kernels from
     lbm_tpu_torch/csrc/ with nvcc (one process per source, all started
     together) and prints the build time;
  2. D2Q9 kernels vs plain version at 1024x1024: for kernels B2 (d2q9_kstep)
     and B1 (d2q9_kstep_inplace), at K=1 and at the K of choose_config, in
     float64 and float32, plus one case with a ghost window (row_offset,
     valid rows and columns strictly inside, global_ny != ny): one stepk
     with the kernel and one with stepk_plain on the card, from a
     numpy-seeded state. B1 must be bit-equal to B2, also over three
     passes of `run` (where B1 chains its boundary snapshot); the same on
     three grids whose width is not a multiple of 32 (narrower tiles), and
     a width no tile divides must raise;
  3. the 2-D main path: the flagship run (1024x1024, 20,000 steps, float32)
     through `lbm_tpu_torch.cli.lbm --engine auto`, which must pick
     cuda-inplace (B1), launch it and never call the plain engine; then the
     same run with `--engine cuda` (B2). Each final_state.dat is held to
     check/1024x1024.final_state.dat.gz by the checker's per-cell rule
     (verify/check.py: column 5, 1%), and the first 100 av_vels to a
     100-step run of the plain engine on the card (4e-4);
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
  7. checkpoint/resume on the card, 2-D (1024^2, B1) and 3-D (64x128x256,
     B4): N steps with --checkpoint-every N/2, then 2N with --resume; av_vels
     and the final state must equal an uninterrupted 2N run bit for bit;
  8. one JSON line `{"kernels": [...]}` with each kernel's launches on its
     path, parity, time per launch, its bound and the plain version's time;
  9. last line: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

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
# H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# floating-point operations of one cell-step of collide_fields (adds, products,
# the two divisions and the square root)
FLOP_PER_CELL_STEP = 94

KERNELS = {
    "d2q9_kstep_inplace": "lbm_tpu/ops/d2q9_pallas_inplace.py:78",
    "d2q9_kstep": "lbm_tpu/ops/d2q9_pallas.py:83",
}
KERNELS_3D = {
    "d3q19_kstep_inplace": "lbm_tpu/ops/d3q19_pallas_inplace.py:50",
    "d3q19_kstep": "lbm_tpu/ops/d3q19_pallas.py:81",
}
# the 3-D bench shape and run (bench.py d3q19_mlups_64x128x256) and physics
SHAPE_3D = (64, 128, 256)
STEPS_3D = 1200
PHYSICS_3D = dict(omega=1.85, density=0.1, accel=0.005)
AV_VELS_PREFIX_3D = 24
# operations of one cell-step of d3q19.collide_fields' paired grouping: 18
# adds for rho, 3 x (9 adds + a division), 5 for u^2, 2 for c_sq, 3 weight
# products, 3 for the rest speed, 9 pairs x 12 plus 9 for their eu, the root
FLOP_PER_CELL_STEP_3D = 179
GOLDEN_3D = REPO / "experiments" / "d3q19-drift" / "d3q19_16x64x128_6000.av_vels.dat"
GOLDEN_3D_SHAPE = (16, 64, 128)
GOLDEN_3D_BAR_F32 = 1.5e-3  # the floor of experiments/d3q19-drift/description.md
GOLDEN_3D_BAR_F64 = 1e-10   # first 200 steps


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


def phase_parity(torch, mods, k_main):
    """Phase 2. Returns {kernel: max_abs_err} of the float32 main-K case."""
    from lbm_tpu_torch.core import state
    d2q9_kstep, d2q9_kstep_inplace = mods
    rng = np.random.default_rng(20261016)
    f_np, mask_np = random_state(rng, N, N), random_mask(rng, N, N)
    aw = dict(omega=1.85, accel_w1=0.1 * 0.01 / 9, accel_w2=0.1 * 0.01 / 36)
    window = dict(row_offset=100, valid_rows=(37, 1000), valid_cols=(5, 1000),
                  global_ny=1200, accel_row=700)
    abs_err = {}
    for dname, dtype in (("float64", torch.float64), ("float32", torch.float32)):
        f, mask = state.to_torch(f_np, mask_np, device="cuda", dtype=dtype)
        cases = [(k, "full", dict(accel_row=N - 2)) for k in sorted({1, k_main})]
        cases.append((k_main, "window", window))
        for k, label, extra in cases:
            kw = dict(k_steps=k, **aw, **extra)
            ref_f, ref_tot = d2q9_kstep.stepk_plain(f, mask, **kw)
            torch.cuda.synchronize()
            b2_f, b2_tot = d2q9_kstep.stepk(f, mask, **kw)
            torch.cuda.synchronize()
            b1_f, b1_tot = d2q9_kstep_inplace.stepk(f.clone(), mask, **kw)
            torch.cuda.synchronize()
            for name, kf, kt in (("d2q9_kstep", b2_f, b2_tot),
                                 ("d2q9_kstep_inplace", b1_f, b1_tot)):
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
            print(f"parity B1 == B2 bit for bit ({dname} K={k} {label})")
        # several passes of run: B1 hands each pass its boundary snapshot
        run_kw = dict(num_steps=3 * k_main, k_steps=k_main, accel_row=N - 2, **aw)
        b2_f, b2_tot = d2q9_kstep.run(f, mask, **run_kw)
        b1_f, b1_tot = d2q9_kstep_inplace.run(f.clone(), mask, **run_kw)
        torch.cuda.synchronize()
        check(torch.equal(b1_f, b2_f) and torch.equal(b1_tot, b2_tot),
              f"B1 run is not bit-equal to B2 run ({dname}, 3 passes of K={k_main})")
        print(f"parity B1 run == B2 run bit for bit ({dname}, 3 passes of K={k_main})")
    return abs_err


def phase_narrow_tiles(torch, mods, k_main):
    """Grids whose width is not a multiple of 32 run on the narrower tiles of
    TILE_CANDIDATES (checked as in phase 2); a width that no tile divides
    and a tile side shorter than K raise."""
    from lbm_tpu_torch.core import state
    d2q9_kstep, d2q9_kstep_inplace = mods
    rng = np.random.default_rng(11)
    aw = dict(omega=1.85, accel_w1=0.1 * 0.01 / 9, accel_w2=0.1 * 0.01 / 36)
    for ny, nx in ((1024, 1008), (1000, 1008), (1024, 1000)):
        th, tw, _ = d2q9_kstep.choose_config(ny, nx)
        check(d2q9_kstep.choose_engine(ny, nx) == "cuda-inplace",
              f"choose_engine({ny}, {nx}) is not cuda-inplace")
        f_np, mask_np = random_state(rng, ny, nx), random_mask(rng, ny, nx)
        for dname, dtype in (("float64", torch.float64), ("float32", torch.float32)):
            f, mask = state.to_torch(f_np, mask_np, device="cuda", dtype=dtype)
            kw = dict(k_steps=k_main, accel_row=ny - 2, **aw)
            ref_f, ref_tot = d2q9_kstep.stepk_plain(f, mask, **kw)
            b2_f, b2_tot = d2q9_kstep.stepk(f, mask, **kw)
            b1_f, b1_tot = d2q9_kstep_inplace.stepk(f.clone(), mask, **kw)
            run_kw = dict(num_steps=3 * k_main, k_steps=k_main, accel_row=ny - 2, **aw)
            r2 = d2q9_kstep.run(f, mask, **run_kw)
            r1 = d2q9_kstep_inplace.run(f.clone(), mask, **run_kw)
            torch.cuda.synchronize()
            ef, et = rel_err(b2_f, ref_f), rel_err(b2_tot, ref_tot)
            print(f"parity {ny}x{nx} tile {th}x{tw} {dname} K={k_main}: state max rel err "
                  f"{ef:.3e}, Sum|u| max rel err {et:.3e}")
            check(np.isfinite(ef) and ef <= BARS[dname] and np.isfinite(et) and et <= BARS[dname],
                  f"{ny}x{nx} {dname}: kernel B2 disagrees with the plain version")
            check(torch.equal(b1_f, b2_f) and torch.equal(b1_tot, b2_tot)
                  and torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1]),
                  f"{ny}x{nx} {dname}: B1 is not bit-equal to B2")
    f, mask = state.to_torch(random_state(rng, 64, 1001), random_mask(rng, 64, 1001),
                             device="cuda", dtype=torch.float32)
    for what, call in (
            ("a 64x1001 grid", lambda: d2q9_kstep.stepk(f, mask, k_steps=4, accel_row=62, **aw)),
            ("tile 4x8 at K=8", lambda: d2q9_kstep_inplace.stepk(
                f[:, :, :1000].contiguous(), mask[:, :1000], k_steps=8, accel_row=62,
                tile=(4, 8), **aw))):
        try:
            call()
        except ValueError as err:
            print(f"raises as it must on {what}: {err}")
        else:
            raise Failure(f"no error on {what}")


def phase_timing(torch, mods, k_main):
    """Time per launch of each kernel, and of the plain version, at the main
    path's shapes (1024^2 float32, K of choose_config), inside `run` as the
    main path calls them."""
    from lbm_tpu_torch.core import state
    d2q9_kstep, d2q9_kstep_inplace = mods
    rng = np.random.default_rng(7)
    f, mask = state.to_torch(random_state(rng, N, N), random_mask(rng, N, N),
                             device="cuda", dtype=torch.float32)
    kw = dict(omega=1.85, accel_w1=0.1 * 0.01 / 9, accel_w2=0.1 * 0.01 / 36,
              accel_row=N - 2)
    passes = 500
    ms = {}
    for name, mod in (("d2q9_kstep", d2q9_kstep), ("d2q9_kstep_inplace", d2q9_kstep_inplace)):
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
    for name, t in ms.items():
        print(f"timing {name:19s}: {t:.4f} ms per K={k_main} launch "
              f"({cells * k_main / t / 1e3:.0f} MLUPS), bound {bound[0]:.4f} ms ({bound[1]}), "
              f"plain version {plain_ms:.4f} ms")
    return ms, plain_ms, bound


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


def phase_main_path(torch, mods, golden, mask):
    """Phase 3. Returns {kernel: (launches, seconds, mlups)} of each path."""
    from lbm_tpu_torch.cli import lbm as cli
    from lbm_tpu_torch.core import io as lbm_io
    from lbm_tpu_torch.core.params import Obstacles, Params
    from lbm_tpu_torch.models import lbm as lbm_model
    from lbm_tpu_torch.ops import d2q9
    d2q9_kstep, d2q9_kstep_inplace = mods

    results = {}
    avs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        params = Params(**FLAGSHIP)
        obstacles = Obstacles(mask)
        params.to_file(tmp / "input_1024x1024.params")
        obstacles.to_file(tmp / "obstacles_1024x1024.dat")
        print(f"main path: flagship mask has {obstacles.num_blocked} blocked cells")
        for engine, kernel, mod, other in (
                ("auto", "d2q9_kstep_inplace", d2q9_kstep_inplace, d2q9_kstep),
                ("cuda", "d2q9_kstep", d2q9_kstep, d2q9_kstep_inplace)):
            out = tmp / engine
            argv = ["--params", str(tmp / "input_1024x1024.params"),
                    "--obstacles", str(tmp / "obstacles_1024x1024.dat"),
                    "--engine", engine, "--dtype", "float32", "--out-dir", str(out)]
            d2q9_kstep.launches = d2q9_kstep_inplace.launches = 0
            with CountCalls(d2q9, "collide_fields") as plain:
                rc, text = run_cli(cli.main, argv)
            launches, other_launches = mod.launches, other.launches
            print(f"main path --engine {engine}:\n{text.rstrip()}")
            check(rc == 0, f"cli returned {rc}")
            check(launches > 0, f"--engine {engine}: {kernel} was never launched")
            check(other_launches == 0, f"--engine {engine}: the other kernel was launched")
            check(plain.calls == 0,
                  f"--engine {engine}: the plain engine ran {plain.calls} collisions")
            if engine == "auto":
                check(re.search(r"^engine:\s+cuda-inplace$", text, re.M) is not None,
                      "--engine auto did not choose cuda-inplace")
            seconds = float(re.search(r"Total compute time:\s+([0-9.eE+-]+)", text).group(1))
            mlups = float(re.search(r"MLUPS:\s+([0-9.eE+-]+)", text).group(1))
            # launches count the warm-up run and the timed run, which are equal
            per_launch_ms = seconds / (launches / 2) * 1e3
            print(f"main path {kernel}: {launches} launches, {seconds:.6f} s timed, "
                  f"{mlups} MLUPS, {per_launch_ms:.4f} ms per launch in the timed run")
            results[kernel] = (launches, seconds, mlups)

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
            avs[kernel] = av

    plain = lbm_model.run_simulation(Params(**FLAGSHIP), Obstacles(mask), dtype=torch.float32,
                                     engine="torch", num_steps=100, device="cuda")
    for kernel, av in avs.items():
        err = float(np.max(np.abs(av[:100] - plain.av_vels) / np.abs(plain.av_vels)))
        print(f"av_vels[:100] of {kernel} vs the plain engine on the card: max rel err "
              f"{err:.3e} (bar {AV_VELS_BAR})")
        check(err <= AV_VELS_BAR, f"{kernel}: av_vels prefix rel err {err} > {AV_VELS_BAR}")
    return results


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
    Returns {kernel: launches of the chunked and resumed runs}."""
    from lbm_tpu_torch.cli import lbm as cli
    from lbm_tpu_torch.cli import lbm3d as cli3
    from lbm_tpu_torch.core.params import Obstacles, Params
    from lbm_tpu_torch.models import lbm as lbm_model
    from lbm_tpu_torch.ops import d3q19
    d2q9_kstep, d2q9_kstep_inplace = mods
    d3q19_kstep, d3q19_kstep_inplace = mods3
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # 2-D, kernel B1: 2000 steps in chunks of 1000, then on to 4000
        n = 2000
        params, obstacles = Params(**FLAGSHIP), Obstacles(mask)
        params.to_file(tmp / "input.params")
        obstacles.to_file(tmp / "obstacles.dat")
        base = ["--params", str(tmp / "input.params"), "--obstacles", str(tmp / "obstacles.dat"),
                "--engine", "auto", "--out-dir", str(tmp / "ck2d"),
                "--checkpoint-every", str(n // 2)]
        d2q9_kstep.launches = d2q9_kstep_inplace.launches = 0
        for argv in (base + ["--num-steps", str(n)],
                     base + ["--num-steps", str(2 * n), "--resume"]):
            rc, text = run_cli(cli.main, argv)
            check(rc == 0, f"2-D checkpointed cli returned {rc}")
        launches["d2q9_kstep_inplace"] = d2q9_kstep_inplace.launches
        check(d2q9_kstep_inplace.launches > 0 and d2q9_kstep.launches == 0,
              "the 2-D checkpointed run did not go through B1 alone")
        ref = lbm_model.run_simulation(params, obstacles, dtype=torch.float32, engine="auto",
                                       num_steps=2 * n, device="cuda")
        with np.load(tmp / "ck2d" / "checkpoint.npz") as ck:
            check(int(ck["step"]) == 2 * n and int(ck["k_steps"]) > 0,
                  "the 2-D checkpoint does not record step and k_steps")
            check(np.array_equal(ck["av_vels"], ref.av_vels),
                  "2-D: resumed av_vels differ from the uninterrupted run")
            check(np.array_equal(ck["f"], ref.f_final),
                  "2-D: resumed final state differs from the uninterrupted run")
        print(f"checkpoint 2-D 1024x1024 (B1, {launches['d2q9_kstep_inplace']} launches): "
              f"{n} steps in chunks of {n // 2}, resumed to {2 * n}: av_vels and final state "
              "equal the uninterrupted run bit for bit")

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (REPO / "lbm_tpu_torch").is_dir() or not GOLDEN.exists() or not GOLDEN_3D.exists():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from lbm_tpu_torch.ops import (_build, d2q9_kstep, d2q9_kstep_inplace, d3q19_kstep,
                                   d3q19_kstep_inplace)
    mods = (d2q9_kstep, d2q9_kstep_inplace)
    mods3 = (d3q19_kstep, d3q19_kstep_inplace)

    try:
        card = card_line()
        print(card)
        t0 = time.perf_counter()
        for name, lib_path in _build.build_all().items():
            _build.load(name)
            print(f"built {lib_path.relative_to(REPO)}")
        print(f"built and loaded the kernels in {time.perf_counter() - t0:.1f} s")

        th, tw, k_main = d2q9_kstep.choose_config(N, N, torch.float32)
        print(f"choose_config(1024, 1024, float32) = tile {th}x{tw}, K={k_main}")
        abs_err = phase_parity(torch, mods, k_main)
        phase_narrow_tiles(torch, mods, k_main)
        ms, plain_ms, bound = phase_timing(torch, mods, k_main)
        t0 = time.perf_counter()
        golden, mask = load_golden()
        print(f"loaded {GOLDEN.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s")
        paths = phase_main_path(torch, mods, golden, mask)

        k3 = d3q19_kstep_inplace.choose_k(STEPS_3D)
        block3 = d3q19_kstep.choose_block(SHAPE_3D[2])
        print(f"3-D: choose_k({STEPS_3D}) = {k3}, choose_block({SHAPE_3D[2]}) = {block3}")
        abs_err3 = phase_parity_3d(torch, mods3, k3)
        ms3, plain_ms3, bound3 = phase_timing_3d(torch, mods3, k3)
        paths3 = phase_main_path_3d(torch, mods3)
        phase_golden_3d(torch)
        ck_launches = phase_checkpoint(torch, mods, mods3, mask)
    except Failure as err:
        print(f"chip_smoke FAILED: {err}", file=sys.stderr)
        return 1

    kernels = [{
        "name": name, "route": "cuda", "source": "lbm_tpu_torch/csrc/d2q9_kstep.cu",
        "replaces": replaces, "launches": paths[name][0], "parity": "ok",
        "max_abs_err": abs_err[name], "ms": ms[name], "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
        "k_steps": k_main, "tile": [th, tw], "flagship_seconds": paths[name][1],
        "flagship_mlups": paths[name][2],
        "checkpoint_launches": ck_launches.get(name, 0),
    } for name, replaces in KERNELS.items()]
    kernels += [{
        "name": name, "route": "cuda", "source": "lbm_tpu_torch/csrc/d3q19_kstep.cu",
        "replaces": replaces, "launches": paths3[name][0], "parity": "ok",
        "max_abs_err": abs_err3[name], "ms": ms3[name], "plain_ms": plain_ms3,
        "bound_ms": bound3[0], "bound_by": bound3[1], "library_ms": None,
        "k_steps": k3, "block": list(block3), "main_path_seconds": paths3[name][1],
        "main_path_mlups": paths3[name][2],
        "checkpoint_launches": ck_launches.get(name, 0),
    } for name, replaces in KERNELS_3D.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
