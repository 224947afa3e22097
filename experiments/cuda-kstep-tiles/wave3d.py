#!/usr/bin/env python3
"""Check and tune the wave path of the one-step D3Q19 kernels B6 (d3q19_kstep)
and B4 (d3q19_kstep_inplace): one launch a K-step pass, a z-wavefront whose
middle steps stay in L2 (csrc/d3q19_kstep.cu `wave_kernel`).

`check_paths` holds, at K = 1..4 in float32 and float64, on each shape of
CHECK_SHAPES (the two 3-D bench grids, three small grids with 3, 4 and an
odd number of planes, rows and columns that no block divides) and on a
ghost window: the wave path's state and Sum|u| bit-equal to the step
path's, B4 == B6 bit for bit, both within the bar of `stepk_plain` (1e-5 in
float32, 1e-12 in float64), three passes of `run` on either path bit-equal,
B6's modes (stream_only, copy bit-equal to their plain versions' state,
collide_no_roll within the bar), the wave path again at the plans of
TUNE_PLANS (chunk, lag) and with 7 blocks in all (every item waits on items
that other blocks hold: the launch must not hang), and a K=2 pass of each
kernel on the wave path captured in a CUDA graph and replayed twice (each
launch leaves its counters at zero, so a replay steps again).

`--probe` is the short first call after a change to csrc/d3q19_kstep.cu:
what `nvcc -Xptxas -v` says of it (registers, spills), the blocks an SM of
each wave instance, `check_paths`, and one K=2 pass of B4 and B6 on each
path at the two grids. Without it the script times B4 and B6 on the wave
path at each plan of `--chunks` x `--lags` (0: `wave_lag`'s) x `--blocks`
and K of `--ks` at each grid of
`--grids`, float32, beside the step path and `copy_` of the lattice (CUDA
events over `--passes` passes at 32x256x256, scaled by the cells
elsewhere, median of `--repeats`), into results_wave3d.csv beside this file
(or --out).

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/wave3d.py --probe
    python3 experiments/cuda-kstep-tiles/wave3d.py [--grids 64x128x256 32x256x256]
        [--ks 1 2 3 4] [--chunks 1 2 4 8] [--lags 0 3 4 6 8] [--blocks 0 264]
        [--passes 100] [--repeats 3] [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from lbm_tpu_torch.core import state  # noqa: E402
from lbm_tpu_torch.ops import _build, d3q19_kstep as b6, d3q19_kstep_inplace as b4  # noqa: E402
from lbm_tpu_torch.ops import d3q19_lattice  # noqa: E402

KW = dict(omega=1.85, density=0.1, accel=0.005)
DTYPES = {"float32": torch.float32, "float64": torch.float64}
BARS = {"float32": 1e-5, "float64": 1e-12}
GRIDS = ((64, 128, 256), (32, 256, 256))
# (shape, block): the bench grids at the default block, and small grids with
# edge blocks in x and y
CHECK_SHAPES = (((64, 128, 256), None), ((32, 256, 256), None), ((3, 10, 40), None),
                ((4, 9, 70), (32, 8, 1)), ((7, 13, 33), (64, 4, 1)))
TUNE_PLANS = ((1, 2), (8, 5), (3, 4))  # (chunk, lag)
MODES = ("stream_only", "copy", "collide_no_roll")


def make_case(shape, dtype, seed=3):
    rng = np.random.default_rng(seed)
    f_np = d3q19_lattice.initial_distributions(*shape, 0.1, np.float64)
    f_np = f_np * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, f_np.shape))
    mask_np = rng.uniform(size=shape) < 0.05
    mask_np[0] = mask_np[-1] = True
    return state.to_torch3d(f_np, mask_np, device="cuda", dtype=dtype)


@contextlib.contextmanager
def plan(**keys):
    """Wave launches on the plan `keys` ("chunk", "lag", "blocks") of
    d3q19_kstep's test hook, for the duration of the block."""
    b6._plan_override.update(keys)
    try:
        yield
    finally:
        b6._plan_override.clear()


def replayed(fn, times: int = 2):
    """fn's result after its launches, captured in a CUDA graph, were replayed
    `times` times. A first call, on the stream of the capture, builds the
    kernels and makes that stream's counters, so that the graph holds no
    reset of them: each replay starts on the zeros its predecessor left."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        result = fn()
    for _ in range(times):
        graph.replay()
    torch.cuda.synchronize()
    return result


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def ptxas_report() -> int:
    """What nvcc -Xptxas -v says of csrc/d3q19_kstep.cu; its return code."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(Path(tmp) / "probe.so"), str(_build.source_path("d3q19_kstep"))]
        res = subprocess.run(cmd, capture_output=True, text=True)
    lines = [ln for ln in res.stderr.splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln or "error" in ln]
    print("\n".join(lines))
    if res.returncode:
        print(res.stderr)
    return res.returncode


def check_paths(shapes=CHECK_SHAPES, ks=(1, 2, 3, 4), dtypes=DTYPES, log=print) -> list:
    """The cases of the module doc; returns the names of those that failed."""
    bad = []

    def hold(cond, what):
        if not cond:
            bad.append(what)
            log(f"FAILED {what}")

    for shape, block in shapes:
        nz, ny, nx = shape
        window = dict(plane_offset=4, valid_planes=(1, nz - 1), valid_rows=(2, ny - 2),
                      global_nz=nz + 8, accel_plane=nz // 2 + 4)
        for dname, dtype in dtypes.items():
            f, mask = make_case(shape, dtype)
            for k in ks:
                for label, extra in (("full", dict(accel_plane=nz - 2)), ("window", window)):
                    if label == "window" and k not in (2, 3):
                        continue
                    plain_kw = dict(k_steps=k, **KW, **extra)
                    kw = dict(block=block, **plain_kw)
                    what = f"{nz}x{ny}x{nx} {dname} K={k} {label}"
                    ref_f, ref_t = b6.stepk_plain(f, mask, **plain_kw)
                    step_f, step_t = b6.stepk(f, mask, path="step", **kw)
                    wave_f, wave_t = b6.stepk(f, mask, path="wave", **kw)
                    g = f.clone()
                    b4_f, b4_t = b4.stepk(g, mask, path="wave", **kw)
                    h = f.clone()
                    b4s_f, b4s_t = b4.stepk(h, mask, path="step", **kw)
                    torch.cuda.synchronize()
                    ef, et = rel_err(wave_f, ref_f), rel_err(wave_t, ref_t)
                    log(f"{what}: wave vs plain state {ef:.3e}, Sum|u| {et:.3e}; wave == step "
                        f"{torch.equal(wave_f, step_f) and torch.equal(wave_t, step_t)}, "
                        f"B4 wave == B6 wave {torch.equal(b4_f, wave_f)}")
                    hold(ef <= BARS[dname] and et <= BARS[dname], f"{what}: wave vs plain")
                    hold(torch.equal(wave_f, step_f) and torch.equal(wave_t, step_t),
                         f"{what}: B6 wave != step")
                    hold(torch.equal(b4_f, wave_f) and torch.equal(b4_t, wave_t),
                         f"{what}: B4 wave != B6 wave")
                    hold(torch.equal(b4s_f, step_f) and torch.equal(b4s_t, step_t),
                         f"{what}: B4 step != B6 step")
                    hold(b4_f.data_ptr() == g.data_ptr(), f"{what}: B4 not in place")
                    if label == "full" and k == 2:
                        for chunk, lag in TUNE_PLANS:
                            with plan(chunk=chunk, lag=lag):
                                t_f, t_t = b6.stepk(f, mask, path="wave", **kw)
                                u_f, u_t = b4.stepk(f.clone(), mask, path="wave", **kw)
                            hold(torch.equal(t_f, step_f) and torch.equal(t_t, step_t)
                                 and torch.equal(u_f, step_f) and torch.equal(u_t, step_t),
                                 f"{what}: plan chunk {chunk} lag {lag}")
                        # B6 replayed: the same pass again; B4: two passes in place
                        r_f, r_t = replayed(lambda: b6.stepk(f, mask, path="wave", **kw))
                        hold(torch.equal(r_f, step_f) and torch.equal(r_t, step_t),
                             f"{what}: B6 wave replayed from a graph")
                        # B4 in place: three passes, the first call and two replays
                        x = f.clone()
                        three_f, three_t = b6.run(f, mask, num_steps=3 * k, k_steps=k,
                                                  path="step", block=block, **KW, **extra)
                        _, r_t = replayed(lambda: b4.stepk(x, mask, path="wave", **kw))
                        hold(torch.equal(x, three_f) and torch.equal(r_t, three_t[-k:]),
                             f"{what}: B4 wave replayed from a graph")
                        del r_f, x, three_f
                    for kk, mod in (("B6", b6), ("B4", b4)):
                        x = f.clone() if mod is b4 else f
                        with plan(blocks=7):
                            lo_f, lo_t = mod.stepk(x, mask, path="wave", **kw)
                        hold(torch.equal(lo_f, step_f) and torch.equal(lo_t, step_t),
                             f"{what}: {kk} wave at 7 blocks")
                    del ref_f, step_f, wave_f, b4_f, b4s_f, g, h
                plain_kw = dict(k_steps=k, accel_plane=nz - 2, **KW)
                kw = dict(block=block, **plain_kw)
                for mode in MODES:
                    ref_f, ref_t = b6.stepk_plain(f, mask, mode=mode, **plain_kw)
                    m_f, m_t = b6.stepk(f, mask, mode=mode, **kw)
                    torch.cuda.synchronize()
                    what = f"{nz}x{ny}x{nx} {dname} K={k} {mode}"
                    if mode == "collide_no_roll":
                        ok = rel_err(m_f, ref_f) <= BARS[dname]
                    else:  # the state only moves: bit for bit
                        ok = torch.equal(m_f, ref_f)
                    if mode == "copy":
                        ok = ok and not bool(m_t.any())
                    else:
                        ok = ok and rel_err(m_t, ref_t) <= BARS[dname]
                    hold(ok and b6.last_path == "wave", f"{what} ({b6.last_path} path)")
                    del ref_f, m_f
                run_kw = dict(num_steps=3 * k, k_steps=k, block=block, accel_plane=nz - 2, **KW)
                r_step = b6.run(f, mask, path="step", **run_kw)
                r_wave = b6.run(f, mask, path="wave", **run_kw)
                g = f.clone()
                r_b4 = b4.run(g, mask, path="wave", **run_kw)
                torch.cuda.synchronize()
                hold(all(torch.equal(a, b) for a, b in zip(r_step, r_wave))
                     and all(torch.equal(a, b) for a, b in zip(r_step, r_b4)),
                     f"{nz}x{ny}x{nx} {dname} K={k}: run on the two paths")
                del r_step, r_wave, r_b4, g
            log(f"checked {nz}x{ny}x{nx} {dname}")
            del f, mask
            torch.cuda.empty_cache()
    return bad


def time_run(run, passes: int) -> float:
    """Device ms a pass of `run(passes)` by CUDA events, after a warm-up."""
    run(2)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(passes)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / passes


def pass_ms(case: str, f, mask, k: int, passes: int, wave=None) -> float:
    """Device ms a pass of `case` ("copy_", or "B6"/"B4" and "step"/"wave"),
    the wave path on the plan `wave` (keys of `plan`)."""
    g = f.clone()
    kw = dict(k_steps=k, accel_plane=f.shape[1] - 2, **KW)
    if case == "copy_":
        other = torch.empty_like(f)

        def run(n):
            for _ in range(n):
                other.copy_(g)
        return time_run(run, passes)
    name, path = case.split()
    mod = b6 if name == "B6" else b4
    with plan(**(wave or {})):
        return time_run(lambda n: mod.run(g, mask, num_steps=k * n, path=path, **kw), passes)


def probe() -> int:
    if ptxas_report():
        return 1
    for mode in range(-1, 4):
        for dtype in DTYPES.values():
            n = _build.load("d3q19_kstep").d3q19_wave_blocks(mode, int(dtype == torch.float64),
                                                             256)
            print(f"wave_kernel mode {mode} {dtype}: {n} blocks an SM of 256 threads")
    bad = check_paths()
    for shape in GRIDS:
        f, mask = make_case(shape, torch.float32)
        for case in ("B6 step", "B6 wave", "B4 step", "B4 wave", "copy_"):
            print(f"probe timing {'x'.join(map(str, shape))} K=2 {case}: "
                  f"{pass_ms(case, f, mask, 2, 20):.4f} ms a pass", flush=True)
    if bad:
        print("FAILED:", *bad, sep="\n  ")
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--grids", nargs="+", default=["64x128x256", "32x256x256"])
    ap.add_argument("--ks", nargs="+", type=int, default=[1, 2, 3, 4])
    ap.add_argument("--chunks", nargs="+", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--lags", nargs="+", type=int, default=[0, 3, 4, 6, 8],
                    help="lags (0: d3q19_kstep.wave_lag's)")
    ap.add_argument("--blocks", nargs="+", type=int, default=[0],
                    help="blocks a launch (0: as many as the card keeps resident)")
    ap.add_argument("--passes", type=int, default=100, help="passes at 32x256x256")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_wave3d.csv")))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wave3d: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    if args.probe:
        return probe()
    rows = []
    for grid in args.grids:
        shape = tuple(int(v) for v in grid.split("x"))
        f, mask = make_case(shape, torch.float32)
        passes = max(20, args.passes * 32 * 256 * 256 // (shape[0] * shape[1] * shape[2]))
        for k in args.ks:
            cases = [("B6 step", {}), ("B4 step", {}), ("copy_", {})]
            for c, lag, blocks in ((c, lag, b) for c in args.chunks for lag in args.lags
                                   for b in args.blocks):
                keys = dict(chunk=c, **({"lag": lag} if lag else {}),
                            **({"blocks": blocks} if blocks else {}))
                cases += [("B4 wave", keys), ("B6 wave", keys)]
            for case, wave in cases:
                ms = [pass_ms(case, f, mask, k, passes, wave) for _ in range(args.repeats)]
                rows.append(dict(grid=grid, k=k, case=case, chunk=wave.get("chunk", ""),
                                 lag=wave.get("lag") or "",
                                 blocks=wave.get("blocks", ""), passes=passes,
                                 ms_per_pass=round(statistics.median(ms), 5),
                                 ms_min=round(min(ms), 5), ms_max=round(max(ms), 5)))
                print(rows[-1], flush=True)
        del f, mask
        torch.cuda.empty_cache()
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; float32; experiments/cuda-kstep-tiles/wave3d.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    for grid in args.grids:
        for k in args.ks:
            for name in ("B6", "B4"):
                sel = [r for r in rows if r["grid"] == grid and r["k"] == k
                       and r["case"] == f"{name} wave"]
                best = min(sel, key=lambda r: r["ms_per_pass"])
                step = next(r for r in rows if r["grid"] == grid and r["k"] == k
                            and r["case"] == f"{name} step")
                print(f"{grid} K={k} {name}: wave best {best['ms_per_pass']} ms at chunk "
                      f"{best['chunk']} lag {best['lag']} blocks "
                      f"{best['blocks'] or 'resident'}; step "
                      f"{step['ms_per_pass']} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
