#!/usr/bin/env python3
"""Time the resident blur, kernels B8 and B13, of two copies of the port on one card.

Each copy (a directory that holds a `lbm_tpu_torch/` package, e.g. the parent
commit unpacked by `git archive`) runs in a process of its own, which imports
that copy's package and builds its kernels into that copy's `build/`. The
processes run in the order A, B, B, A, so that a drift of the card's clock or
temperature falls on both copies alike. Each process times:

- B8 (`stencil.blur_resident`) at 4x320x512 float32, the image chip_smoke.py
  times: the ms of one launch of 200 passes (the blur CLI's main path, 20
  launches) and µs a pass from runs of 200 and 2,200 passes;
- B13, every variant at bricks and leaf where it fits, bfloat16, as
  blur_resident_opt.py's sweep: µs a pass, the median over `--repeats` of
  (t(n_hi) - t(n_lo)) / (n_hi - n_lo) after a warm run at each count, and the
  device ms of all of a row's launches; their sum over the rows is the
  sweep's `main_path_ms`, chip_smoke.py's;
- with `--depth K ...`, B13 again at each depth K that a variant's tile
  takes (the passes a block runs between two exchanges of tile edges; a copy
  that has no depth runs none of these rows).

Writes one CSV row a timing to results_ab_resident.csv beside this file (or
--out), headed by the card's name and power limit, and prints each case's
median for A and B and B's against A's.

`--probe` is the short check after a change to csrc/blur_resident.cuh, on
this checkout alone: what `nvcc -Xptxas -v` says of the two sources that
include it, every B13 variant and B8 held bit for bit to their plain
versions (blur_resident_opt.py's `check_parity` and `check_reuse`), then one
round of the timings of B8 and of v0, v5 and v6 at bricks and v5 and v6 at
leaf, at the rule's depth and at each `--depth`.

Run on a machine with the card, from the repository root:

    git archive PARENT lbm_tpu_torch | tar -x -C build/parent
    python3 experiments/cuda-kstep-tiles/ab_resident.py --a build/parent --b . \\
        [--depth 1 2 4] [--repeats 5] [--out FILE]
    python3 experiments/cuda-kstep-tiles/ab_resident.py --probe [--depth 1 2 4]
"""

from __future__ import annotations

import argparse
import csv
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
B8_SHAPE, B8_INTERIOR = (4, 320, 512), (302, 499)
B8_PASSES, B8_LONG, B8_LAUNCHES = 200, 2200, 20
PROBE_CASES = (("bricks", "v0-roll"), ("bricks", "v5-ringzero"), ("bricks", "v6-bf16-fold"),
               ("leaf", "v5-ringzero"), ("leaf", "v6-bf16-fold"))


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def load_copy(root: str):
    """(torch, stencil, blur_resident_opt, the sweep harness) of the copy at
    root: its package is imported first, so that the harness, which imports
    the package too, gets that copy's."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from lbm_tpu_torch.ops import _build, stencil
    from lbm_tpu_torch.ops import blur_resident_opt as bro

    for source in ("stencil", "blur_resident_opt"):  # built before any timing
        _build.load(source)
    spec = importlib.util.spec_from_file_location("sweep_harness", HERE / "blur_resident_opt.py")
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    return torch, stencil, bro, harness


def build(bro, variant, img, hw0, depth):
    """bro.build at the rule's depth (None), or at `depth` (a copy that has
    no depth takes only None)."""
    return bro.build(variant, img, hw0) if depth is None else bro.build(variant, img, hw0,
                                                                        depth=depth)


def b8_rows(torch, stencil, harness, launches=B8_LAUNCHES):
    img_np, int_np = harness.study_case(B8_SHAPE, B8_INTERIOR)
    x, m = (torch.from_numpy(a).cuda() for a in (img_np, int_np))
    short = harness.time_ms(lambda: stencil.blur_resident(x, m, num_passes=B8_PASSES), launches)
    long = harness.time_ms(lambda: stencil.blur_resident(x, m, num_passes=B8_LONG),
                           max(1, launches // 4))
    return [dict(kernel="B8", image="4x320x512", variant="v0", depth="", what="ms_200",
                 value=round(short, 5)),
            dict(kernel="B8", image="4x320x512", variant="v0", depth="", what="us_per_pass",
                 value=round((long - short) / (B8_LONG - B8_PASSES) * 1e3, 4))]


def b13_rows(torch, bro, harness, cases, repeats, depth=None):
    """One row of µs a pass and one of the ms of all launches for each
    (image, variant) of `cases` that fits and takes `depth`."""
    rows = []
    for name, variant in cases:
        shape, hw0 = harness.IMAGES[name]
        if not harness.fits(variant, shape):
            continue
        img_np, int_np = harness.study_case(shape, hw0)
        img = torch.from_numpy(img_np).to("cuda", torch.bfloat16)
        interior = torch.from_numpy(int_np).to("cuda", torch.bfloat16)
        try:
            call, layout = build(bro, variant, img, hw0, depth)
        except ValueError:  # the tile takes no halo this deep
            continue
        if layout == "rank2":
            img = bro.to_rank2(img).contiguous()
            interior = bro.rank2_interior(interior, shape[0]).contiguous()
        hi = harness.n_hi(int(img.numel()))
        us, spread, _, _, total = harness.time_variant(call, img, interior, harness.N_LO, hi,
                                                       repeats)
        got = getattr(call, "depth", 1)
        base = dict(kernel="B13", image=name, variant=variant, depth="" if depth is None else got)
        rows += [dict(base, what="us_per_pass", value=round(us, 4)),
                 dict(base, what="spread_us", value=round(spread, 4)),
                 dict(base, what="sweep_ms", value=round(total, 3))]
    return rows


def all_cases(harness, bro):
    return [(name, v) for name in harness.IMAGES for v in bro.VARIANTS]


def worker(root: str, repeats: int, depths) -> list[dict]:
    """Every timing of this copy of the port."""
    torch, stencil, bro, harness = load_copy(root)
    rows = b8_rows(torch, stencil, harness)
    rows += b13_rows(torch, bro, harness, all_cases(harness, bro), repeats)
    if "depth" in bro.build.__code__.co_varnames:
        for k in depths:
            rows += b13_rows(torch, bro, harness, all_cases(harness, bro), repeats, depth=k)
    return rows


def ptxas_report(source: str) -> None:
    """What nvcc -Xptxas -v says of csrc/<source>.cu; exits on an error."""
    from lbm_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                              str(Path(tmp) / "lib.so"), str(_build.source_path(source))],
                             capture_output=True, text=True)
    out = res.stdout + res.stderr
    print(f"== nvcc -Xptxas -v {source}.cu (rc {res.returncode})")
    print("\n".join(ln for ln in out.splitlines()
                    if "registers" in ln or "spill" in ln or "error" in ln.lower()
                    or "Compiling entry" in ln))
    if res.returncode:
        print(out)
        raise SystemExit(1)


def probe_run(depths) -> int:
    torch, stencil, bro, harness = load_copy(str(REPO))
    print(card_name())
    for source in ("blur_resident_opt", "stencil"):
        ptxas_report(source)
    try:
        harness.check_parity()
        harness.check_reuse()
    except RuntimeError as err:
        print(f"FAILED: {err}")
        return 1
    rows = b8_rows(torch, stencil, harness, launches=5)
    for depth in (None, *depths):
        rows += b13_rows(torch, bro, harness, PROBE_CASES, 1, depth=depth)
    for r in rows:
        if r["what"] != "spread_us":
            print(r, flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="directory of copy A (the reference)")
    ap.add_argument("--b", help="directory of copy B (the change)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--depth", type=int, nargs="*", default=[],
                    help="B13 again at each of these depths (copies that take one)")
    ap.add_argument("--out", default=str(HERE / "results_ab_resident.csv"))
    ap.add_argument("--probe", action="store_true",
                    help="ptxas, parity and one round of timings of this checkout; no CSV")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.repeats, args.depth)))
        return 0
    if args.probe:
        return probe_run(args.depth)
    if not (args.a and args.b):
        ap.error("--a and --b are required (or --probe)")
    card = card_name()
    print(card)
    rows = []
    for order, (label, root) in enumerate((("A", args.a), ("B", args.b), ("B", args.b),
                                           ("A", args.a))):
        out = subprocess.run([sys.executable, __file__, "--worker", root, "--repeats",
                              str(args.repeats), "--depth", *map(str, args.depth)],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout, out.stderr, file=sys.stderr)
            return 1
        got = json.loads(out.stdout.strip().splitlines()[-1])
        rows += [dict(copy=label, root=root, process=order, **r) for r in got]
        print(f"process {order} ({label}, {root}): {len(got)} timings", flush=True)
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; B8 float32 4x320x512, B13 bfloat16 bricks and leaf; A = {args.a}, "
                 f"B = {args.b}; processes A, B, B, A; experiments/cuda-kstep-tiles/"
                 "ab_resident.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    cases = list(dict.fromkeys((r["kernel"], r["image"], r["variant"], r["depth"], r["what"])
                               for r in rows if r["what"] != "spread_us"))
    for case in cases:
        med = {}
        for label in ("A", "B"):
            vals = [r["value"] for r in rows if r["copy"] == label
                    and (r["kernel"], r["image"], r["variant"], r["depth"], r["what"]) == case]
            if vals:
                med[label] = statistics.median(vals)
        what = " ".join(str(c) for c in case if c != "")
        line = "  ".join(f"{k} {v:.4f}" for k, v in med.items())
        if len(med) == 2:
            line += f"  B against A {100 * (med['B'] / med['A'] - 1):+.2f}%"
        print(f"{what:44s} {line}")
    for label in ("A", "B"):
        per_process = {}
        for r in rows:
            if r["copy"] == label and r["what"] == "sweep_ms" and r["depth"] == "":
                per_process[r["process"]] = per_process.get(r["process"], 0.0) + r["value"]
        print(f"sweep main_path_ms {label}: " + ", ".join(f"{v:.1f}" for v in
                                                          per_process.values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
