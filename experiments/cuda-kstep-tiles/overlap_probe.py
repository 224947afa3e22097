#!/usr/bin/env python3
"""The D2Q9 overlap probes on the card: kernel B11 (lbm_tpu_torch.ops.overlap_probe).

The card's counterpart of experiments/d2q9-overlap/probe.py (`time_engine`,
`check_correct`, `analyze`, `main`). Every probe moves the bytes of a D2Q9
pass over a (9, n, n) float32 state and runs R dependent rounds of
x * 1.0001 + 0.0001 on each value; wall(R) shows whether the copy and the
arithmetic overlap (wall ~ max(copy, compute)) or run in series (wall ~
copy + compute), whether an explicit pipeline (depth 2/3/4/6, strided or
contiguous copies) beats the blocks resident on an SM, and whether one
aliased memory stream beats two.

Engines: probe.py's table (`op.ENGINES`), and each strided manual engine
again in (9, 1, 512) tiles (`manual@1x512`, ...): a stage of 9 copies of
2 KB, one a plane, the TPU stage's 9 strided descriptors, against the 144
copies of 128 B of the default (9, 16, 32) tile and the one copy of
`manual_flat`; all three stages hold the same 4,608 values.

Each time is CUDA events around `iters` chained calls after a warm-up,
ping-ponging two buffers for the two-stream engines and in place for the
aliased ones; the best of 3 (as probe.py), with the spread
(greatest minus least). At R = 0 `Tensor.copy_` is timed too (engine
`copy_`), the library's call for the same function. `torch` is eager PyTorch
with at least one round, as probe.py's `build_xla`. Before any timing, every
engine is held to its plain version bit for bit at 256x256 (probe.py's
canary size, bands 32 and 64, R = 0 and 2), and the manual engines to `auto`;
then every kernel engine at --size and R = 16, where each block of a manual
engine walks many tiles through its ring (the smem totals too).

Beside probe.py's overlap fractions (`analyze`, which takes the auto engine
as serialized and so reads 0 for it whatever the card does), each kernel
row with R > 0 gets `compute_us`, the engine's arithmetic alone: R times its
cost a round, the slope of its wall between R = 256 and R = 512 at the same
grid, where the arithmetic is 7-14x the bytes' time and a
copy term, hidden or not, cancels; and `overlap`, the fraction (copy +
compute - wall) / min(copy, compute) with the engine's own wall(0) as its
copy: 0 when the two run in series, 1 when the shorter is hidden.

Writes results_overlap.csv beside this file (or --out): probe.csv's columns
and the card's name and power limit, spread, blocks an SM, the bound.

Each strided manual engine moves a stage as one TMA box where
`op.choose_path` allows it (the (9, 16, 32) tile) and as bulk copies a row
segment otherwise (the (9, 1, 512) tile); `check_box_paths` holds the two
paths to each other and to the plain version bit for bit at 256x256 and at
72x100 (edge tiles), and every row of the CSV names its path.

`--probe` is the short first call after a change to csrc/overlap_probe.cu:
what `nvcc -Xptxas -v` says of it (registers, shared memory, spills), the
canary, the path check, the check at --size and R = 16, each kernel's
blocks an SM and its grid, and 20 calls of each engine at R = 0 and 16; no
CSV.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/overlap_probe.py [--probe] [--size 4096] [--band 64]
        [--iters 200] [--rounds 0 16 32 64] [--engines auto manual ...] [--out FILE]
    python3 experiments/cuda-kstep-tiles/overlap_probe.py --analyze FILE
"""

from __future__ import annotations

import argparse
import csv
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from lbm_tpu_torch.ops import _build  # noqa: E402
from lbm_tpu_torch.ops import overlap_probe as op  # noqa: E402

# H100 SXM data sheet: HBM3 rate; 67 TFLOP/s of float32 counts an FMA as two
# operations, and a round's multiply and add are rounded apart, so each is
# one instruction: half that rate
HBM_BYTES_PER_S = 3.35e12
F32_INSTR_PER_S = 67e12 / 2
CANARY = 256
CANARY_BANDS = (32, 64)
CANARY_ROUNDS = (0, 2)
SLOPE_ROUNDS = (256, 512)
ROW_SUFFIX = "@1x512"
# probe.py's engines, and the strided manual ones in op.ROW_TILE tiles
ENGINES = list(op.ENGINES) + [e + ROW_SUFFIX for e in op.STRIDED]
FIELDS = ["engine", "platform", "grid", "band", "rounds", "iters", "us_per_iter", "rw_gbps",
          "spread_us", "blocks_per_sm", "path", "bound_us", "bound_by", "compute_us", "overlap",
          "card"]
# grids of the path check (ny, nx, band): the canary's, and one whose tiles
# of either shape leave edge tiles in both axes
PATH_CASES = ((CANARY, CANARY, 32), (72, 100, 12))


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def bound_us(name: str, ny: int, nx: int, rounds: int) -> tuple[float, str]:
    """The least time of one call: its bytes (the state read and written
    once) at the HBM rate, or its operations (2 a value and round), whichever
    is longer."""
    values = 9 * ny * nx
    if name == "torch":
        rounds = max(rounds, 1)
    t_bytes = 2 * 4 * values / HBM_BYTES_PER_S * 1e6
    t_ops = 2 * rounds * values / F32_INSTR_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build(name: str, ny: int, nx: int, band: int, rounds: int):
    """The engine `name` of ENGINES; `<engine>@1x512` is the strided manual
    engine in op.ROW_TILE tiles."""
    if name.endswith(ROW_SUFFIX):
        return op.ENGINES[name[:-len(ROW_SUFFIX)]](ny, nx, band, rounds, tile=op.ROW_TILE)
    return op.ENGINES[name](ny, nx, band, rounds)


def runner(name: str, ny: int, nx: int, band: int, rounds: int):
    """(run(n), reset()) for n chained calls of the engine on a 0.5-filled
    state on the card; `copy_` is Tensor.copy_ between two buffers."""
    state = torch.full((9, ny, nx), 0.5, device="cuda")
    other = torch.empty_like(state)
    probe = None if name == "copy_" else build(name, ny, nx, band, rounds)
    bufs = [state, other]

    def reset():
        bufs[0], bufs[1] = state, other
        state.fill_(0.5)

    def run(n: int):
        if name == "torch":
            x = bufs[0]
            for _ in range(n):
                x = probe(x)
        elif name == "copy_":
            for _ in range(n):
                bufs[1].copy_(bufs[0])
                bufs.reverse()
        elif probe.alias:
            for _ in range(n):
                probe(bufs[0])
        else:
            for _ in range(n):
                probe(bufs[0], out=bufs[1])
                bufs.reverse()

    return run, reset, probe


def probe_path(probe, ny: int, nx: int) -> str:
    """The path an engine's launches take on an aligned state: "tma" or
    "values" (auto), "box" or "bulk" (manual); "" for `torch` and `copy_`."""
    if not isinstance(probe, op.Probe):
        return ""
    if probe.kind == "auto":
        return op.auto_path(nx, True)
    return op.choose_path(ny, nx, probe.tile, probe.flat, aligned=True)


def check_box_paths(engines=op.STRIDED, cases=PATH_CASES, rounds_list=CANARY_ROUNDS, log=print):
    """Each strided manual engine on the box path ((9, 16, 32) tiles) against
    the same engine on the bulk path ((9, 1, 512) tiles) and its plain
    version, bit for bit, with the path each launch took. Raises
    RuntimeError on a difference or a path other than expected. Returns the
    cases held."""
    held = 0
    for ny, nx, band in cases:
        for rounds in rounds_list:
            f = torch.from_numpy(np.random.default_rng(ny + rounds).random(
                (9, ny, nx), dtype=np.float32)).cuda()
            for name in engines:
                got = {}
                for label, tile in (("box", op.TILE), ("bulk", op.ROW_TILE)):
                    probe = op.ENGINES[name](ny, nx, band, rounds, tile=tile)
                    got[label] = probe(f.clone())
                    torch.cuda.synchronize()
                    if op.last_path != label:
                        raise RuntimeError(f"{name} {ny}x{nx} tile {tile}: took the "
                                           f"{op.last_path} path, not {label}")
                ref = probe.plain(f.clone())
                what = f"{name} {ny}x{nx} band {band} R={rounds}"
                if not (torch.equal(got["box"], ref) and torch.equal(got["bulk"], ref)):
                    raise RuntimeError(f"{what}: box {float((got['box'] - ref).abs().max())}, "
                                       f"bulk {float((got['bulk'] - ref).abs().max())} from "
                                       "the plain version")
                log(f"{what}: box path == bulk path == plain, bit for bit")
                held += 1
    return held


def time_engine(name, ny, nx, band, rounds, iters, repeats=3):
    """Device ms per call: (best, spread) over `repeats` timings of `iters`
    chained calls, and the blocks of its kernel on one SM (None for
    `torch` and `copy_`)."""
    run, reset, probe = runner(name, ny, nx, band, rounds)
    run(3)  # build, load, warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(repeats):
        reset()
        start.record()
        run(iters)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    blocks = probe.blocks_per_sm() if isinstance(probe, op.Probe) else None
    return min(times), max(times) - min(times), blocks


def canary(engines, size: int = CANARY, bands=CANARY_BANDS, rounds_list=CANARY_ROUNDS):
    """Every engine against its plain version on the card, bit for bit (the
    smem total too), and the manual engines against `auto` (probe.py's
    check_correct). An engine whose ring needs more bands than the grid has
    (manual6 at 256x256, band 64) must refuse to build, as probe.py's does.
    Raises RuntimeError on a difference. Returns (cases held, cases
    refused)."""
    held, refused = 0, []
    for band in bands:
        for rounds in rounds_list:
            f = torch.from_numpy(np.random.default_rng(band + rounds).random(
                (9, size, size), dtype=np.float32)).cuda()
            auto = op.build_auto(size, size, band, rounds)(f.clone())
            for name in engines:
                try:
                    probe = build(name, size, size, band, rounds)
                except ValueError as err:
                    if "bands" not in str(err):
                        raise
                    refused.append(f"{name} band {band} R={rounds}")
                    continue
                if isinstance(probe, op.Probe):
                    got = probe(f.clone())
                    total = probe.total
                    ref = probe.plain(f.clone())
                else:  # torch: its own plain version
                    got, ref, total = probe(f.clone()), op.work_plain(f, max(rounds, 1)), None
                torch.cuda.synchronize()
                what = f"{name} {size}x{size} band {band} R={rounds}"
                if not torch.equal(got, ref):
                    raise RuntimeError(f"{what}: differs from its plain version by "
                                       f"{float((got - ref).abs().max())}")
                if total is not None and not torch.equal(total, probe.total):
                    raise RuntimeError(f"{what}: smem total {float(total)} != plain "
                                       f"{float(probe.total)}")
                if name.startswith("manual") and not torch.equal(got, auto):
                    raise RuntimeError(f"{what}: differs from auto")
                held += 1
    return held, refused


def us_per_round(engines, n, band, rounds=SLOPE_ROUNDS, iters=20):
    """{engine: us of one round of its arithmetic at n x n}: the slope of its
    wall between two large R (kernel engines only)."""
    lo, hi = rounds
    out = {}
    for name in engines:
        if name != "torch":
            t_lo = time_engine(name, n, n, band, lo, iters)[0]
            t_hi = time_engine(name, n, n, band, hi, iters)[0]
            out[name] = (t_hi - t_lo) * 1e3 / (hi - lo)
    return out


def overlap_fraction(copy, compute, wall):
    denom = min(copy, compute)
    return (copy + compute - wall) / denom if denom > 0 else 0.0


def sweep(engines, n, band, iters, rounds_list, card, library=True, log=print):
    """One row a case, in probe.py's CSV columns and this harness's; with
    `library`, a `copy_` row where R = 0 is swept."""
    rows = []
    cases = [(e, r) for e in engines for r in rounds_list]
    if library and 0 in rounds_list:
        cases.append(("copy_", 0))
    for name, rounds in cases:
        best, spread, blocks = time_engine(name, n, n, band, rounds, iters)
        b_us, b_by = bound_us(name, n, n, rounds)
        rows.append(dict(engine=name, platform="gpu", grid=f"{n}x{n}", band=band, rounds=rounds,
                         iters=iters, us_per_iter=round(best * 1e3, 1),
                         rw_gbps=round(2 * 9 * n * n * 4 / (best * 1e-3) / 1e9, 1),
                         spread_us=round(spread * 1e3, 1), blocks_per_sm=blocks or "",
                         path=path_of(name, n, n), bound_us=round(b_us, 1), bound_by=b_by,
                         compute_us="", overlap="", card=card))
        log(f"{name:23s} R={rounds:<3d} {best * 1e3:9.1f} us (spread {spread * 1e3:.1f}, "
            f"bound {b_us:.1f} {b_by}, {blocks or '-'} blocks an SM, "
            f"{path_of(name, n, n) or '-'} path)")
    return rows


def path_of(name: str, ny: int, nx: int) -> str:
    """probe_path of engine `name` (band 64 needs ny >= 64 x depth)."""
    if name in ("torch", "copy_"):
        return ""
    return probe_path(build(name, ny, nx, ny // 8, 0), ny, nx)


def add_overlap(rows, per_round):
    """compute_us and overlap on each row with R > 0 whose engine has a cost
    a round and an R = 0 row."""
    copy = {r["engine"]: r["us_per_iter"] for r in rows if r["rounds"] == 0}
    for r in rows:
        if r["rounds"] > 0 and r["engine"] in per_round and r["engine"] in copy:
            c = per_round[r["engine"]] * r["rounds"]
            r["compute_us"] = round(c, 1)
            r["overlap"] = round(overlap_fraction(copy[r["engine"]], c, r["us_per_iter"]), 3)


def ptxas_report() -> None:
    """What nvcc -Xptxas -v says of csrc/overlap_probe.cu; exits on an error."""
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                              str(Path(tmp) / "probe.so"), str(_build.source_path("overlap_probe"))],
                             capture_output=True, text=True)
    out = res.stdout + res.stderr
    print(f"== nvcc -Xptxas -v overlap_probe.cu (rc {res.returncode})")
    print("\n".join(ln for ln in out.splitlines()
                    if "registers" in ln or "spill" in ln or "error" in ln.lower()
                    or "Compiling entry" in ln or "smem" in ln))
    if res.returncode:
        print(out)
        raise SystemExit(1)


def check_full(engines, n: int, band: int, rounds: int = 16, log=print) -> float:
    """Every kernel engine at n x n against its plain version on the card,
    bit for bit, the smem total too. At 4096^2, band 64, each block of a
    manual engine walks tens of tiles through its ring. Raises RuntimeError
    on a difference; returns the greatest |difference| (0.0)."""
    f = torch.from_numpy(np.random.default_rng(11).random((9, n, n), dtype=np.float32)).cuda()
    bad, max_err = [], 0.0
    for name in engines:
        probe = build(name, n, n, band, rounds)
        if not isinstance(probe, op.Probe):
            continue
        got = probe(f.clone())
        total = probe.total
        ref = probe.plain(f.clone())
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        same = torch.equal(got, ref) and (total is None or torch.equal(total, probe.total))
        extra = (f", grid {probe.grid_blocks(f.device)} blocks, {probe.tiles()} tiles"
                 if probe.kind == "manual" else "")
        log(f"{name:23s} {n}^2 R={rounds} ({probe_path(probe, n, n)} path): "
            f"{'bit-equal' if same else 'DIFFERS'} "
            f"(max |d| {err}{', smem total ' + repr(float(total)) if total is not None else ''}), "
            f"{probe.blocks_per_sm()} blocks an SM{extra}")
        if not same:
            bad.append(name)
        max_err = max(max_err, err)
        del got, ref
    if bad:
        raise RuntimeError(f"{n}^2 R={rounds}: differ from their plain versions: {bad}")
    return max_err


def probe_run(engines, n, band) -> int:
    ptxas_report()
    held, refused = canary(engines)
    print(f"canary: {held} cases bit-equal, refused (too few bands): {refused or 'none'}")
    try:
        print(f"paths: {check_box_paths()} cases held")
        check_full(engines, n, band)
    except RuntimeError as err:
        print(f"FAILED: {err}")
        return 1
    for name in engines:
        for rounds in (0, 16):
            best, spread, _ = time_engine(name, n, n, band, rounds, 20, 2)
            print(f"{name:23s} R={rounds:<3d} {best * 1e3:9.1f} us (20 calls, spread "
                  f"{spread * 1e3:.1f})")
    return 0


def write_csv(rows, path):
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=FIELDS)
        writer.writeheader()
        writer.writerows(rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--analyze", metavar="CSV", default=None,
                    help="summarise an existing probe CSV and exit")
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--band", type=int, default=64)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--rounds", type=int, nargs="*", default=[0, 16, 32, 64])
    ap.add_argument("--engines", nargs="*", default=ENGINES, choices=ENGINES)
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_overlap.csv")))
    ap.add_argument("--probe", action="store_true",
                    help="ptxas report, parity and a short timing; no CSV")
    args = ap.parse_args()
    if args.analyze:
        op.analyze(args.analyze)
        return 0
    if not torch.cuda.is_available():
        print("overlap_probe: CUDA is not available", file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    if args.probe:
        return probe_run(args.engines, args.size, args.band)
    held, refused = canary(args.engines)
    print(f"canary: {held} cases at {CANARY}x{CANARY} bit-equal to the plain versions "
          f"(manual == auto); refused to build, too few bands: {refused or 'none'}")
    check_full(args.engines, args.size, args.band)
    rows = sweep(args.engines, args.size, args.band, args.iters, args.rounds, card)
    per_round = us_per_round(args.engines, args.size, args.band)
    print(f"arithmetic a round (slope R = {SLOPE_ROUNDS[0]} -> {SLOPE_ROUNDS[1]}): "
          + ", ".join(f"{e} {c:.3f} us" for e, c in per_round.items()))
    add_overlap(rows, per_round)
    write_csv(rows, args.out)
    op.analyze(args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
