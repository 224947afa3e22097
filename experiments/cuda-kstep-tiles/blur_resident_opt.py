#!/usr/bin/env python3
"""The resident-blur variants on the card: kernel B13 (lbm_tpu_torch.ops.blur_resident_opt).

The card's counterpart of experiments/blur-resident-opt/run.py `main`: what
one blur pass costs when the image stays on chip for the whole run, for
each of the study's eight formulations of a pass (v0-roll .. v7-bf16-arith),
at its two images: bricks (4, 304, 512) with a (302, 499) interior and leaf
(4, 1032, 896) with (1024, 768). The image is `default_rng(0).random` times
the interior; image and mask are bfloat16 in memory, as in `main`.

Per-pass cost, as run.py measures it: the median over --repeats of
(t(n_hi) - t(n_lo)) / (n_hi - n_lo), n_lo = 2000 and n_hi from run.py's
rule, each run timed by CUDA events around one launch after a warm run at
each count. The spread is the greatest minus the least of those quotients.
Beside each: the checksum of the n_hi run (compare it only within a
variant: after thousands of passes a bfloat16 state stops decaying), the
tile, a block's shared memory and the blocks, the bound (a pass's
operations at 67 TFLOP/s: `FLOP_PER_VALUE` a value), the plain version's
time a pass (`PLAIN_PASSES` passes) and the library's (one
`stencil.blur_step_conv` on the same image). A variant whose tiles do not
fit the SMs' shared memory gets a row with fits = false, the bytes a block
would need and no time.

Before any timing, every variant is held to its plain version bit for bit
at bricks and at a small shape that no tile divides (`ODD`), in float32 and
bfloat16 I/O, at `PARITY_PASSES` passes (an odd count runs one pass fewer,
as run.py's `_pingpong`), and v0 and v1 to kernel B8
(`stencil.blur_resident`); the variants that fit leaf are held there too.

Writes results_blur_resident_opt.csv beside this file (or --out): run.py's
columns and the card's name and power limit, spread, tile, bytes a block,
blocks, fits, bound, plain and library times, the median ms of an n_lo run,
and the device ms of all of a row's launches (`sweep_ms`, warm runs
included) beside the sum of their bounds (`sweep_bound_ms`).

`--probe` is the short first call after a change to csrc/blur_resident_opt.cu:
what `nvcc -Xptxas -v` says of it (registers, shared memory, spills), the
parity checks, and one run of n_lo passes of each variant; no CSV.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/blur_resident_opt.py [--probe] [--images bricks leaf]
        [--variants v0-roll ...] [--repeats 5] [--out FILE]
"""

from __future__ import annotations

import argparse
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

from lbm_tpu_torch.ops import _build, stencil  # noqa: E402
from lbm_tpu_torch.ops import blur_resident_opt as bro  # noqa: E402

# H100 SXM data sheet: float32 rate outside the tensor cores, HBM3 rate
F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
# operations a value and pass: v0-v3 rows 3, columns 3, the 1/16 and the
# mask 2 (stencil's FLOP_PER_VALUE_SEPARABLE); v4 two folded stages of 4
# (a sum, two products, a sum) and the mask; v5-v7 the same with a select
FLOP_PER_VALUE = {v: (9 if bro.SPECS[v].folded else 8) for v in bro.VARIANTS}
# run.py's images: padded (C, h, w) and the interior they hold
IMAGES = {"bricks": ((4, 304, 512), (302, 499)), "leaf": ((4, 1032, 896), (1024, 768))}
ODD = ((3, 37, 53), (33, 47))  # three channels, sides no tile divides
N_LO = 2000
PARITY_PASSES = (0, 2, 7, 200)
LEAF_PARITY_PASSES = (2, 200)
REPEATS = 5
PLAIN_PASSES = 20
LIBRARY_CALLS = 20
FIELDS = ["image", "platform", "variant", "us_per_pass", "gvals_per_s", "checksum", "card",
          "spread_us", "tile", "block_bytes", "blocks", "fits", "bound_us", "plain_us",
          "library_us", "n_lo", "n_hi", "lo_ms", "sweep_ms", "sweep_bound_ms"]


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def n_hi(n_vals: int) -> int:
    """run.py's long run: hi - lo sized to tens of milliseconds of passes."""
    return N_LO + 2 * (max(4000, int(1.8e10 / n_vals)) // 2)


def study_case(shape, hw0):
    """run.py main's image and interior, float32 numpy."""
    (c, h, w), (h0, w0) = shape, hw0
    rng = np.random.default_rng(0)
    interior = np.zeros((h, w), np.float32)
    interior[1:1 + h0, 1:1 + w0] = 1
    return rng.random((c, h, w)).astype(np.float32) * interior, interior


def prepare(variant, img_np, int_np, hw0, dtype, device="cuda"):
    """(call, image, interior) of a variant on the device, in its layout."""
    img = torch.from_numpy(img_np).to(device, dtype)
    interior = torch.from_numpy(int_np).to(device, dtype)
    call, layout = bro.build(variant, img, hw0)
    if layout == "rank2":
        img = bro.to_rank2(img).contiguous()
        interior = bro.rank2_interior(interior, img_np.shape[0]).contiguous()
    return call, img, interior


def fits(variant, shape, device="cuda") -> bool:
    return bro.tiling(variant, *shape, *stencil.device_limits(torch.device(device))) is not None


def bound_us(variant, shape) -> float:
    """A pass's operations at the float32 rate (the image crosses device
    memory once a run, so its bytes bind no pass)."""
    return FLOP_PER_VALUE[variant] * int(np.prod(shape)) / F32_FLOP_PER_S * 1e6


def run_bound_ms(variant, shape, passes, itemsize) -> tuple[float, str]:
    """The least time of one launch: the image in and out and the mask once
    at the memory rate, or `passes` passes' operations."""
    c, h, w = shape
    t_bytes = (2 * c + 1) * h * w * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = passes * bound_us(variant, shape) / 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_parity(cases=None, dtypes=(torch.float32, torch.bfloat16), log=print) -> float:
    """Every variant against its plain version on the card, bit for bit, and
    v0 and v1 against B8, at `cases` {label: (shape, hw0, passes)} (bricks
    and ODD at PARITY_PASSES, leaf at LEAF_PARITY_PASSES for the variants
    that fit it). Raises RuntimeError on a difference; returns the greatest
    |difference| (0.0)."""
    if cases is None:
        cases = {"bricks": (*IMAGES["bricks"], PARITY_PASSES), "odd": (*ODD, PARITY_PASSES),
                 "leaf": (*IMAGES["leaf"], LEAF_PARITY_PASSES)}
    max_err, held, bad = 0.0, 0, []
    for label, (shape, hw0, passes) in cases.items():
        img_np, int_np = study_case(shape, hw0)
        for dtype in dtypes:
            dname = str(dtype).removeprefix("torch.")
            for variant in bro.VARIANTS:
                if not fits(variant, shape):
                    continue
                call, x, m = prepare(variant, img_np, int_np, hw0, dtype)
                for n in passes:
                    got = call(n, x, m)
                    refs = {"plain": call.plain(n, x, m)}
                    if bro.SPECS[variant].instance == "v0":
                        refs["B8"] = stencil.blur_resident(x, m, num_passes=2 * (n // 2))
                    torch.cuda.synchronize()
                    for what, ref in refs.items():
                        err = float((got.float() - ref.float()).abs().max())
                        max_err = max(max_err, err)
                        held += 1
                        if not torch.equal(got, ref):
                            bad.append(f"{variant} {label} {dname} n={n} vs {what}: max |d| {err}")
            log(f"parity {label} {tuple(shape)} {dname}: every variant that fits bit-equal to "
                f"its plain version at passes {list(passes)}, v0 and v1 to B8")
    if bad:
        raise RuntimeError("B13 differs: " + "; ".join(bad))
    log(f"parity: {held} comparisons bit-equal")
    return max_err


def time_launch(call, x, m, n) -> tuple[float, torch.Tensor]:
    """Device ms of one launch of n passes (CUDA events), and its output."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = call(n, x, m)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def time_variant(call, x, m, lo, hi, repeats):
    """run.py's per-pass cost: the median over `repeats` of (t(hi) - t(lo)) /
    (hi - lo), after a warm run at each count. Returns (us a pass, spread us,
    checksum of the last hi run, median ms of a lo run, ms of all its
    launches, the warm ones included)."""
    total = time_launch(call, x, m, lo)[0] + time_launch(call, x, m, hi)[0]
    deltas, t_los, out = [], [], None
    for _ in range(repeats):
        t_lo, _ = time_launch(call, x, m, lo)
        t_hi, out = time_launch(call, x, m, hi)
        deltas.append((t_hi - t_lo) / (hi - lo) * 1e3)
        t_los.append(t_lo)
        total += t_lo + t_hi
    checksum = float(out.float().sum())
    return (statistics.median(deltas), max(deltas) - min(deltas), checksum,
            statistics.median(t_los), total)


def time_ms(fn, calls: int) -> float:
    """Device ms per call of `calls` calls of fn after one warm call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def library_us(img_np, int_np, dtype=torch.bfloat16) -> float:
    """One `stencil.blur_step_conv` (depthwise conv2d) on the image: the
    library's pass."""
    x = torch.from_numpy(img_np).to("cuda", dtype)
    m = torch.from_numpy(int_np).to("cuda", dtype)
    return time_ms(lambda: stencil.blur_step_conv(x, m), LIBRARY_CALLS) * 1e3


def sweep(images, variants, repeats, card, log=print):
    """One row a (image, variant), in run.py's CSV columns and this
    harness's; bfloat16 image and mask, as run.py's main."""
    rows = []
    for name in images:
        shape, hw0 = IMAGES[name]
        img_np, int_np = study_case(shape, hw0)
        n_vals = int(np.prod(shape))
        hi = n_hi(n_vals)
        lib_us = library_us(img_np, int_np)
        for variant in variants:
            row = dict(image=name, platform="gpu", variant=variant, card=card, n_lo=N_LO, n_hi=hi,
                       bound_us=round(bound_us(variant, shape), 5), library_us=round(lib_us, 3))
            if not fits(variant, shape):
                need = bro.needed_bytes(variant, *shape,
                                        stencil.device_limits(torch.device("cuda"))[0])
                row.update(us_per_pass="", gvals_per_s="", checksum="", spread_us="", tile="",
                           block_bytes=need, blocks="", fits=False, plain_us="", lo_ms="",
                           sweep_ms="", sweep_bound_ms="")
                log(f"{name:7s} {variant:14s} does not fit: {need:,} B a block")
                rows.append(row)
                continue
            call, x, m = prepare(variant, img_np, int_np, hw0, torch.bfloat16)
            us, spread, checksum, lo_ms, sweep_ms = time_variant(call, x, m, N_LO, hi, repeats)
            plain = time_ms(lambda: call.plain(PLAIN_PASSES, x, m), 1) / PLAIN_PASSES * 1e3
            row.update(us_per_pass=round(us, 4), gvals_per_s=round(n_vals / us / 1e3, 1),
                       checksum=f"{checksum:.6g}", spread_us=round(spread, 4),
                       tile=f"{call.tile[0]}x{call.tile[1]}", block_bytes=call.block_bytes,
                       blocks=call.blocks, fits=True, plain_us=round(plain, 2),
                       lo_ms=round(lo_ms, 4), sweep_ms=round(sweep_ms, 3),
                       sweep_bound_ms=round(
                           (repeats + 1) * (N_LO + hi) * bound_us(variant, shape) / 1e3, 3))
            log(f"{name:7s} {variant:14s} {us:8.4f} us/pass (spread {spread:.4f}) "
                f"{n_vals / us / 1e3:7.1f} Gval/s checksum={checksum:.6g}; tile {row['tile']}, "
                f"{call.block_bytes:,} B a block, {call.blocks} blocks; bound "
                f"{row['bound_us']} us, plain {row['plain_us']} us, conv {row['library_us']} us")
            rows.append(row)
            del x, m
    return rows


def write_csv(rows, path) -> None:
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=FIELDS)
        writer.writeheader()
        writer.writerows(rows)


def ptxas_report() -> None:
    """What nvcc -Xptxas -v says of csrc/blur_resident_opt.cu; exits on an error."""
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                              str(Path(tmp) / "bro.so"),
                              str(_build.source_path("blur_resident_opt"))],
                             capture_output=True, text=True)
    out = res.stdout + res.stderr
    print(f"== nvcc -Xptxas -v blur_resident_opt.cu (rc {res.returncode})")
    print("\n".join(ln for ln in out.splitlines()
                    if "registers" in ln or "spill" in ln or "error" in ln.lower()
                    or "Compiling entry" in ln or "smem" in ln))
    if res.returncode:
        print(out)
        raise SystemExit(1)


def probe_run(images, variants) -> int:
    ptxas_report()
    try:
        check_parity()
    except RuntimeError as err:
        print(f"FAILED: {err}")
        return 1
    for name in images:
        shape, hw0 = IMAGES[name]
        img_np, int_np = study_case(shape, hw0)
        for variant in variants:
            if not fits(variant, shape):
                print(f"{name:7s} {variant:14s} does not fit")
                continue
            call, x, m = prepare(variant, img_np, int_np, hw0, torch.bfloat16)
            time_launch(call, x, m, N_LO)
            t, _ = time_launch(call, x, m, N_LO)
            print(f"{name:7s} {variant:14s} {N_LO} passes in {t:.3f} ms ({t / N_LO * 1e3:.3f} us "
                  f"a pass with the launch), tile {call.tile}, {call.block_bytes:,} B a block")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", nargs="*", default=list(IMAGES), choices=list(IMAGES))
    ap.add_argument("--variants", nargs="*", default=list(bro.VARIANTS), choices=bro.VARIANTS)
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_blur_resident_opt.csv")))
    ap.add_argument("--probe", action="store_true",
                    help="ptxas report, parity and one run a variant; no CSV")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("blur_resident_opt: CUDA is not available", file=sys.stderr)
        return 1
    card = card_name()
    print(card)
    if args.probe:
        return probe_run(args.images, args.variants)
    check_parity()
    rows = sweep(args.images, args.variants, args.repeats, card)
    write_csv(rows, args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
