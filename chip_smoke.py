#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port (lbm_tpu_torch) runs on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
  1. prints the card's name and power limit; builds the CUDA kernels from
     lbm_tpu_torch/csrc/ with nvcc and prints the build time;
  2. kernel vs plain version at 1024x1024: for kernels B2 (d2q9_kstep) and
     B1 (d2q9_kstep_inplace), at K=1 and at the K of choose_config, in
     float64 and float32, plus one case with a ghost window (row_offset,
     valid rows and columns strictly inside, global_ny != ny): one stepk
     with the kernel and one with stepk_plain on the card, from a
     numpy-seeded state. B1 must be bit-equal to B2, also over three
     passes of `run` (where B1 chains its boundary snapshot); the same on
     three grids whose width is not a multiple of 32 (narrower tiles), and
     a width no tile divides must raise;
  3. the main path: the flagship run (1024x1024, 20,000 steps, float32)
     through `lbm_tpu_torch.cli.lbm --engine auto`, which must pick
     cuda-inplace (B1), launch it and never call the plain engine; then the
     same run with `--engine cuda` (B2). Each final_state.dat is held to
     check/1024x1024.final_state.dat.gz by the checker's per-cell rule
     (verify/check.py: column 5, 1%), and the first 100 av_vels to a
     100-step run of the plain engine on the card (4e-4);
  4. one JSON line `{"kernels": [...]}` with each kernel's launches on its
     path, parity, time per launch, its bound and the plain version's time;
  5. last line: {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

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

    plain_calls = [0]
    collide_fields = d2q9.collide_fields

    def counting_collide_fields(*args, **kwargs):
        plain_calls[0] += 1
        return collide_fields(*args, **kwargs)

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
            d2q9.collide_fields = counting_collide_fields
            d2q9_kstep.launches = d2q9_kstep_inplace.launches = 0
            plain_calls[0] = 0
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(argv)
            finally:
                d2q9.collide_fields = collide_fields
            launches, other_launches = mod.launches, other.launches
            text = buf.getvalue()
            print(f"main path --engine {engine}:\n{text.rstrip()}")
            check(rc == 0, f"cli returned {rc}")
            check(launches > 0, f"--engine {engine}: {kernel} was never launched")
            check(other_launches == 0, f"--engine {engine}: the other kernel was launched")
            check(plain_calls[0] == 0,
                  f"--engine {engine}: the plain engine ran {plain_calls[0]} collisions")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (REPO / "lbm_tpu_torch").is_dir() or not GOLDEN.exists():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from lbm_tpu_torch.ops import _build, d2q9_kstep, d2q9_kstep_inplace
    mods = (d2q9_kstep, d2q9_kstep_inplace)

    try:
        card = card_line()
        print(card)
        t0 = time.perf_counter()
        lib_path = _build.build()
        _build.load()
        print(f"built {lib_path.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s")

        th, tw, k_main = d2q9_kstep.choose_config(N, N, torch.float32)
        print(f"choose_config(1024, 1024, float32) = tile {th}x{tw}, K={k_main}")
        abs_err = phase_parity(torch, mods, k_main)
        phase_narrow_tiles(torch, mods, k_main)
        ms, plain_ms, bound = phase_timing(torch, mods, k_main)
        t0 = time.perf_counter()
        golden, mask = load_golden()
        print(f"loaded {GOLDEN.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s")
        paths = phase_main_path(torch, mods, golden, mask)
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
    } for name, replaces in KERNELS.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
