#!/usr/bin/env python3
"""Time the tile copies B12 and B11 `auto` of two copies of the port on one card.

Each copy (a directory that holds a `lbm_tpu_torch/` package, e.g. the parent
commit unpacked by `git archive`) runs in a process of its own, which imports
that copy's package and builds its kernels into that copy's `build/`. The
processes run in the order A, B, B, A, so that a drift of the card's clock or
temperature falls on both copies alike. Each process times, `repeats` times
and the cases in turn:

- B12 (`copy_floor.run_copy`) at tiles 16x32 and 32x128, at 1024^2 and
  4096^2 float32, by CUDA events over `passes` passes (1,000 at 1024^2, 100
  at 4096^2) after a warm-up;
- `Tensor.copy_` ping-ponging two buffers, at both grids;
- B11 `auto`, `auto_halo`, `auto_smem` and `auto_full` at 4096^2, band 64,
  R = 0, 16 and 64: best of 3 x 200 chained calls, as overlap_probe.py;
- the host's time to enqueue a B12 pass (`B12-enqueue`): the host clock
  around 2,000 passes at 384^2 (16x32), a grid whose pass the card, with the
  lattices in L2, finishes faster than the host issues it.

Writes one CSV row a timing to results_ab_copy.csv beside this file (or
--out), headed by the card's name and power limit, and prints each case's
median for A and B and B's against A's.

`--probe` is the short first call after a change to csrc/copy_floor.cu,
csrc/overlap_probe.cu or csrc/tile_copy.cuh, on this checkout alone: what
`nvcc -Xptxas -v` says of the two sources, the blocks an SM that B12's
occupancy query gives the TMA rings the CPU tests assume, B12 on both paths
in float32 and float64 held bit-equal to `run_copy_plain` on grids with and
without edge tiles, TMA and one-value B11 `auto` instances held bit-equal
to their plain versions, then one round of the timings.

Run on a machine with the card, from the repository root:

    git archive PARENT lbm_tpu_torch | tar -x -C build/parent
    python3 experiments/cuda-kstep-tiles/ab_copy.py --a build/parent --b . \\
        [--repeats 3] [--out FILE]
    python3 experiments/cuda-kstep-tiles/ab_copy.py --probe
"""

from __future__ import annotations

import argparse
import csv
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
COPY_GRIDS = {1024: 1000, 4096: 100}  # grid: passes a timing
COPY_TILES = ((16, 32), (32, 128))
PROBE_SIZE, PROBE_BAND, PROBE_ITERS = 4096, 64, 200
PROBE_ENGINES = ("auto", "auto_halo", "auto_smem", "auto_full")
PROBE_ROUNDS = (0, 16, 64)
ENQUEUE_GRID, ENQUEUE_PASSES = 384, 2000


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def events_ms(torch, fn, count: int) -> float:
    """Device ms of fn() over one timing, divided by count."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / count


def b12_cases(copy_floor):
    """(name, grid, tile, call(f, n)) of the B12 cases."""
    for n in COPY_GRIDS:
        for by, bx in COPY_TILES:
            yield "B12", n, (by, bx), lambda f, k, t=(by, bx): copy_floor.run_copy(f, k, *t)


def library_call(torch, f):
    bufs = [torch.empty_like(f), torch.empty_like(f)]

    def run(k):
        src = f
        for i in range(k):
            bufs[i % 2].copy_(src)
            src = bufs[i % 2]
    return run


def probe_runner(torch, op, name, n, band, rounds):
    """run(k): k chained calls of the engine, ping-ponging two buffers."""
    state = torch.full((9, n, n), 0.5, device="cuda")
    other = torch.empty_like(state)
    probe = op.ENGINES[name](n, n, band, rounds)
    bufs = [state, other]

    def run(k):
        for _ in range(k):
            probe(bufs[0], out=bufs[1])
            bufs.reverse()
    return run


def worker(root: str, repeats: int) -> list[dict]:
    """Every case of this copy of the port, `repeats` times; rows of us."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from lbm_tpu_torch.ops import copy_floor
    from lbm_tpu_torch.ops import overlap_probe as op

    rows = []
    states = {n: torch.rand((9, n, n), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(n)) for n in COPY_GRIDS}
    cases = [(name, n, tile, (lambda k, c=call, f=states[n]: c(f, k)), COPY_GRIDS[n])
             for name, n, tile, call in b12_cases(copy_floor)]
    cases += [("copy_", n, "", library_call(torch, states[n]), COPY_GRIDS[n]) for n in COPY_GRIDS]
    for _, _, _, run, _ in cases:
        run(2)
    for rep in range(repeats):
        for name, n, tile, run, passes in cases:
            us = events_ms(torch, lambda: run(passes), passes) * 1e3
            rows.append(dict(kernel=name, grid=n, tile="x".join(map(str, tile)), rounds="",
                             repeat=rep, us=round(us, 3)))
    del states
    g = torch.rand((9, ENQUEUE_GRID, ENQUEUE_GRID), device="cuda")
    copy_floor.run_copy(g, 2, 16, 32)
    for rep in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        copy_floor.run_copy(g, ENQUEUE_PASSES, 16, 32)
        us = (time.perf_counter() - t0) / ENQUEUE_PASSES * 1e6
        torch.cuda.synchronize()
        rows.append(dict(kernel="B12-enqueue", grid=ENQUEUE_GRID, tile="16x32", rounds="",
                         repeat=rep, us=round(us, 3)))
    del g
    runners = {(e, r): probe_runner(torch, op, e, PROBE_SIZE, PROBE_BAND, r)
               for e in PROBE_ENGINES for r in PROBE_ROUNDS}
    runners[("copy_", 0)] = library_call(torch, torch.full((9, PROBE_SIZE, PROBE_SIZE), 0.5,
                                                           device="cuda"))
    for run in runners.values():
        run(3)
    for rep in range(repeats):
        for (name, rounds), run in runners.items():
            best = min(events_ms(torch, lambda: run(PROBE_ITERS), PROBE_ITERS) for _ in range(3))
            rows.append(dict(kernel=name, grid=PROBE_SIZE, tile=f"band {PROBE_BAND}",
                             rounds=rounds, repeat=rep, us=round(best * 1e3, 3)))
    return rows


def ptxas_report(source: str) -> None:
    """What nvcc -Xptxas -v says of csrc/<source>.cu; exits on an error."""
    sys.path.insert(0, str(REPO))
    from lbm_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                              str(Path(tmp) / "lib.so"), str(_build.source_path(source))],
                             capture_output=True, text=True)
    out = res.stdout + res.stderr
    print(f"== nvcc -Xptxas -v {source}.cu (rc {res.returncode})")
    print("\n".join(ln for ln in out.splitlines()
                    if "registers" in ln or "spill" in ln or "error" in ln.lower()
                    or "Compiling entry" in ln or "smem" in ln))
    if res.returncode:
        print(out)
        raise SystemExit(1)


# the float32 TMA rings whose blocks an SM tests/test_torch_copy_floor.py
# takes as the card's (H100_BLOCKS)
OCCUPANCY_RINGS = (((9, 16, 32), 1), ((9, 8, 128), 2), ((9, 4, 128), 2), ((9, 4, 256), 2),
                   ((9, 2, 256), 2), ((9, 4, 256), 4), ((9, 2, 256), 4))

# (ny, nx, tiles) of the B12 parity cases: tiles that divide the grid, edge
# tiles, full-width bands, widths that TMA cannot take in float32 (1001, 33,
# 1002) or in either type (1001, 33)
B12_PARITY = (
    (1024, 1024, ((16, 32), (32, 128), (16, 1024), (64, 1024), (5, 7))),
    (72, 130, ((16, 32), (16, 130), (5, 7))),
    (64, 1001, ((16, 32), (16, 1001))),
    (17, 36, ((16, 32), (8, 12))),
    (17, 33, ((16, 32),)),
    (20, 1002, ((16, 32), (16, 1002))),
    # clusters of 4 tiles after the bands above raised the kernel's shared
    # memory limit (a launch the card refused before fit_smem)
    (256, 1024, ((16, 64), (16, 32))),
)


def b12_parity(torch, copy_floor, log=print) -> int:
    """B12 on the path its layout gives, float32 and float64, three passes
    bit-equal to run_copy_plain: TMA where nx and the tile's width are whole
    16-byte pieces, one value a piece elsewhere (both must run); an
    unaligned state must take the scalar path. Raises RuntimeError on a
    difference; returns the cases held."""
    held = 0
    ran = set()
    gen = torch.Generator("cuda").manual_seed(5)
    for ny, nx, tiles in B12_PARITY:
        for dtype in (torch.float32, torch.float64):
            f = torch.rand((9, ny, nx), device="cuda", dtype=dtype, generator=gen)
            ref = copy_floor.run_copy_plain(f, 3, 1, 1)
            for by, bx in tiles:
                path, chunk, stages = copy_floor.plan(f, f, by, bx)
                out = copy_floor.run_copy(f, 3, by, bx)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise RuntimeError(f"B12 {path} {ny}x{nx} {dtype} tile {by}x{bx}: differs "
                                       f"by {float((out - ref).abs().max())}")
                ran.add((path, dtype))
                held += 1
                log(f"B12 {ny}x{nx} {str(dtype)[6:]} tile {by}x{bx}: {path} bit-equal "
                    f"(chunk {chunk}, {stages} stage(s))")
    missing = {(p, d) for p in copy_floor.PATHS for d in (torch.float32, torch.float64)} - ran
    if missing:
        raise RuntimeError(f"B12 parity never ran {sorted(map(str, missing))}")
    # a state 4 bytes off 16: the scalar path
    flat = torch.rand(9 * 64 * 64 + 1, device="cuda", generator=gen)
    f = flat[1:].view(9, 64, 64)
    chosen = copy_floor.plan(f, torch.empty_like(f), 16, 32)[0]
    out = copy_floor.run_copy(f, 2, 16, 32)
    torch.cuda.synchronize()
    if chosen != "scalar" or not torch.equal(out, f):
        raise RuntimeError(f"B12 unaligned state: path {chosen}, equal {torch.equal(out, f)}")
    log("B12 unaligned 64x64 float32: scalar path, bit-equal")
    return held + 1


def auto_values_parity(torch, op, log=print) -> int:
    """The one-value path of every `auto` instance against its plain version,
    R = 0 and 2, the smem totals too: at a width of 250 (nx % 4 == 2) and on a
    state 4 bytes off 16 at 128. Raises RuntimeError; returns the cases held."""
    held = 0
    names = [e for e in op.ENGINES if e.startswith("auto")]
    for ny, nx, band, offset in ((64, 250, 16, 0), (48, 128, 16, 1)):
        for rounds in (0, 2):
            gen = torch.Generator("cuda").manual_seed(nx + rounds)
            flat = torch.rand(9 * ny * nx + offset, device="cuda", generator=gen)

            def state():  # a fresh copy at the same offset from 16 bytes
                return flat.clone()[offset:].view(9, ny, nx)
            for name in names:
                probe = op.ENGINES[name](ny, nx, band, rounds)
                got = probe(state())
                total = probe.total
                ref = probe.plain(state())
                torch.cuda.synchronize()
                if not torch.equal(got, ref) or (probe.smem and not torch.equal(total,
                                                                                probe.total)):
                    raise RuntimeError(f"B11 {name} one-value path {ny}x{nx} R={rounds}: "
                                       "differs from its plain version")
                held += 1
            log(f"B11 one-value path {ny}x{nx} band {band} R={rounds} "
                f"({'4 B off 16' if offset else 'nx % 4 = 2'}): {len(names)} auto instances "
                "bit-equal (smem totals too)")
    return held


def probe_run(repeats: int) -> int:
    sys.path.insert(0, str(REPO))
    import torch

    from lbm_tpu_torch.ops import copy_floor
    from lbm_tpu_torch.ops import overlap_probe as op

    print(card_name())
    for source in ("copy_floor", "overlap_probe"):
        ptxas_report(source)
    for chunk, stages in OCCUPANCY_RINGS:
        print(f"B12 TMA ring, float32 chunk {chunk}, {stages} stage(s): "
              f"{copy_floor.blocks_per_sm(4, chunk, stages)} blocks an SM")
    try:
        print(f"B12 parity: {b12_parity(torch, copy_floor)} cases")
        print(f"B11 one-value parity: {auto_values_parity(torch, op)} cases")
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        import overlap_probe as harness

        held, refused = harness.canary([e for e in harness.ENGINES if e.startswith("auto")])
        print(f"B11 canary: {held} auto cases bit-equal at 256^2 ({refused or 'none'} refused)")
        harness.check_full([e for e in harness.ENGINES if e.startswith("auto")], PROBE_SIZE,
                           PROBE_BAND, 16)
    except RuntimeError as err:
        print(f"FAILED: {err}")
        return 1
    for r in worker(str(REPO), repeats):
        print(r, flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="directory of copy A (the reference)")
    ap.add_argument("--b", help="directory of copy B (the change)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_ab_copy.csv")))
    ap.add_argument("--probe", action="store_true",
                    help="ptxas, parity and one round of timings of this checkout; no CSV")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.repeats)))
        return 0
    if args.probe:
        return probe_run(1)
    if not (args.a and args.b):
        ap.error("--a and --b are required (or --probe)")
    card = card_name()
    print(card)
    rows = []
    for order, (label, root) in enumerate((("A", args.a), ("B", args.b), ("B", args.b),
                                           ("A", args.a))):
        out = subprocess.run([sys.executable, __file__, "--worker", root,
                              "--repeats", str(args.repeats)], capture_output=True, text=True)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return 1
        got = json.loads(out.stdout.strip().splitlines()[-1])
        rows += [dict(copy=label, root=root, process=order, **r) for r in got]
        print(f"process {order} ({label}, {root}): {len(got)} timings", flush=True)
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; float32; A = {args.a}, B = {args.b}; processes A, B, B, A; "
                 "experiments/cuda-kstep-tiles/ab_copy.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    cases = list(dict.fromkeys((r["kernel"], r["grid"], r["tile"], r["rounds"]) for r in rows))
    for case in cases:
        med = {}
        for label in ("A", "B"):
            us = [r["us"] for r in rows
                  if r["copy"] == label and (r["kernel"], r["grid"], r["tile"], r["rounds"]) == case]
            if us:
                med[label] = statistics.median(us)
        what = " ".join(str(c) for c in case if c != "")
        line = "  ".join(f"{k} {v:.3f} us" for k, v in med.items())
        if len(med) == 2:
            line += f"  B against A {100 * (med['B'] / med['A'] - 1):+.2f}%"
        print(f"{what:36s} {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
