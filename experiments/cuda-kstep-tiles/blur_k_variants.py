#!/usr/bin/env python3
"""Time variants of the k-pass blur B9 against each other on one card.

Each variant is csrc/stencil.cu of this tree with a few lines replaced (the
table VARIANTS: name -> (what it tests, [(old text, new text), ...]); old
text must be in the source once, or at least once where a third element
"all" asks for every occurrence),
copied with the rest of `lbm_tpu_torch/` into build/blur_k_variants/<name>/
and built there, all variants' nvcc started together. Each variant then
runs in a process of its own, in the order of `--variants` and back again
(a, b, ..., b, a), and times at the padded 4096x4096 RGBA image
(4x4128x4224), float32 and bfloat16: B9's trip alone (the kernel's k = 0
instance: rows through the ring and out as they came in) and B9 at each k of
`--ks`, at `--band` rows and `--windows` windows a block (the defaults of
ops/stencil.py when not given), by CUDA events over `--launches`
launches, beside a copy of the image (`clone`). Variants marked
"diagnostic" leave out part of the work, so only their times mean anything;
the others are held bit for bit to `blur_k_plain` (the trip alone: to its
input) before they are timed. Writes results_blur_k_variants.csv beside
this file (or --out) and prints each variant's median against the first.

Run on a machine with the card, from the repository root:

    python3 experiments/cuda-kstep-tiles/blur_k_variants.py [--variants base lead8 ...]
        [--ks 1 4 8] [--band ROWS] [--windows N] [--launches 30] [--out FILE]
"""

from __future__ import annotations

import argparse
import csv
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
ROOT = REPO / "build" / "blur_k_variants"
SHAPE, INNER = (4, 4128, 4224), (4096, 4096)
DTYPE_NAMES = ("float32", "bfloat16")

_STORE_F4 = "*reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);"
_STORE_U2 = "*reinterpret_cast<uint2*>(p) = make_uint2("
_STORE_U4 = "*reinterpret_cast<uint4*>(p) = make_uint4("
VARIANTS = {
    "base": ("the tree's kernel", []),
    "lead2": ("two rows in flight ahead, not four",
              [("constexpr int kRingLead = 4;", "constexpr int kRingLead = 2;")]),
    "lead6": ("six rows in flight ahead", [("constexpr int kRingLead = 4;",
                                            "constexpr int kRingLead = 6;")]),
    "lead8": ("eight rows in flight ahead", [("constexpr int kRingLead = 4;",
                                              "constexpr int kRingLead = 8;")]),
    "lead12": ("twelve rows in flight ahead", [("constexpr int kRingLead = 4;",
                                                "constexpr int kRingLead = 12;")]),
    "stcs": ("the output stored with evict-first (st.global.cs)",
             [(_STORE_F4, "__stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], "
                          "v[3]));"),
              (_STORE_U2 + "pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));",
               "__stcs(reinterpret_cast<uint2*>(p), make_uint2(pack_bf16(v[0], v[1]), "
               "pack_bf16(v[2], v[3])));"),
              (_STORE_U4 + "pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),\n"
               "                                            pack_bf16(v[4], v[5]), "
               "pack_bf16(v[6], v[7]));",
               "__stcs(reinterpret_cast<uint4*>(p), make_uint4(pack_bf16(v[0], v[1]), "
               "pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7])));")]),
    "channel_grid": ("one channel a block, the channel in the grid (the mask into every block)",
                     [("return min(c, max(1, kMaxWarps / windows));", "return 1;")]),
    "no_fma": ("x + 2 y as a product and a sum, not one fused multiply-add",
               [("{ return __fmaf_rn(2.0f, y, x); }", "{ return x + 2.0f * y; }")]),
    "bf16_v4": ("bfloat16 at four values a lane at every k (8-byte accesses)",
                [("return sizeof(T) == 4 ? 4 : (K <= 4 ? 8 : 4);", "return 4;")]),
    "two_blocks": ("__launch_bounds__ asks for two blocks an SM (at most 113 registers)",
                   [("__global__ void __launch_bounds__((kMaxWarps + 1) * 32)\nblur_k_kernel",
                     "__global__ void __launch_bounds__((kMaxWarps + 1) * 32, 2)\nblur_k_kernel")]),
    "no_store": ("diagnostic: nothing stored (the loads alone)",
                 [("    T* dst = out + (size_t)(r0 + t - 2 * K) * w + gcol;\n    if (vector) {",
                   "    T* dst = out + (size_t)(r0 + t - 2 * K) * w + gcol;\n"
                   "    if (r0 >= 0) return;\n    if (vector) {")]),
    "no_mask_copy": ("diagnostic: the mask's bulk copies left out (the ring's mask is stale)",
                     [("tile_copy::mbar_expect_tx(&full[s], (chans + 1u) * span * sizeof(T));",
                       "tile_copy::mbar_expect_tx(&full[s], chans * 1u * span * sizeof(T));"),
                      ("          tile_copy::bulk_load(dst + done, interior + row + pos, "
                       "n * sizeof(T), &full[s]);\n", "")]),
}


def prepare(name: str) -> Path:
    """build/blur_k_variants/<name>/lbm_tpu_torch with the variant's lines."""
    root = ROOT / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(REPO / "lbm_tpu_torch", root / "lbm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = root / "lbm_tpu_torch" / "csrc" / "stencil.cu"
    text = src.read_text()
    for old, new, *every in VARIANTS[name][1]:
        if text.count(old) != 1 and not (every and text.count(old)):
            raise SystemExit(f"variant {name}: {old!r} is not in stencil.cu exactly once")
        text = text.replace(old, new)
    src.write_text(text)
    return root


def make(torch, dtype, seed=4):
    import numpy as np

    rng = np.random.default_rng(seed)
    interior = np.zeros(SHAPE[1:], np.float32)
    interior[1:1 + INNER[0], 1:1 + INNER[1]] = 1
    img = rng.random(SHAPE).astype(np.float32) * interior
    return (torch.from_numpy(img).to("cuda", dtype), torch.from_numpy(interior).to("cuda", dtype))


def time_ms(torch, fn, launches: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def worker(root: str, name: str, ks, launches: int, build_only: bool, band, windows) -> None:
    sys.path.insert(0, root)
    import torch

    from lbm_tpu_torch.ops import _build, stencil

    band = band or stencil.DEFAULT_BAND
    stencil.K_WINDOWS = windows or stencil.K_WINDOWS

    lib = _build.load("stencil")
    if build_only:
        print(json.dumps({}))
        return
    diagnostic = name in ("no_store", "no_mask_copy")
    times, equal = {}, {}
    for dname in DTYPE_NAMES:
        x, m = make(torch, getattr(torch, dname))
        entry = getattr(lib, "stencil_k_" + ("f32" if dname == "float32" else "bf16"))
        stream = torch.cuda.current_stream().cuda_stream

        def trip():
            out = torch.empty_like(x)
            rc = entry(x.data_ptr(), m.data_ptr(), out.data_ptr(), *x.shape,
                       band, 0, stencil.K_WINDOWS, 0, stream)
            if rc:
                raise RuntimeError(f"stencil_k at k = 0 returned {rc}")
            return out

        cases = {"copy": (lambda: x.clone(), None), "trip": (trip, x)}
        for k in ks:
            cases[f"B9 k={k}"] = (lambda k=k: stencil.blur_k(x, m, k_passes=k, band=band),
                                  stencil.blur_k_plain(x, m, k_passes=k))
        for case, (fn, ref) in cases.items():
            key = f"{dname} {case}"
            if ref is not None and not diagnostic:
                equal[key] = bool(torch.equal(fn(), ref))
            times[key] = time_ms(torch, fn, launches)
        del x, m, cases
        torch.cuda.empty_cache()
    print(json.dumps({"times": times, "equal": equal}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--ks", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--launches", type=int, default=30)
    ap.add_argument("--band", type=int, default=0, help="rows a block writes (0: the default)")
    ap.add_argument("--windows", type=int, default=0,
                    help="windows a channel in a block (0: the default)")
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_blur_k_variants.csv")))
    ap.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker, args.ks, args.launches, args.build_only, args.band, args.windows)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)

    def cmd(name, build_only=False):
        return ([sys.executable, __file__, "--worker", str(ROOT / name), name, "--ks",
                 *map(str, args.ks), "--launches", str(args.launches), "--band", str(args.band),
                 "--windows", str(args.windows)]
                + (["--build-only"] if build_only else []))

    def finish(proc):
        out, err = proc.communicate()
        if proc.returncode:
            print(out, err, file=sys.stderr)
            raise SystemExit(1)
        return json.loads(out.strip().splitlines()[-1])

    for name in args.variants:
        prepare(name)
    builds = [subprocess.Popen(cmd(name, True), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True) for name in args.variants]
    for proc in builds:
        finish(proc)
    rows = []
    order = args.variants + args.variants[::-1]
    for process, name in enumerate(order):
        res = finish(subprocess.Popen(cmd(name), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
        bad = [key for key, ok in res["equal"].items() if not ok]
        if bad:
            print(f"variant {name}: NOT equal to the plain version: {bad}", file=sys.stderr)
            return 1
        for key, ms in res["times"].items():
            dname, case = key.split(" ", 1)
            rows.append(dict(variant=name, process=process, dtype=dname, case=case,
                             ms_per_launch=round(ms, 6)))
        print(f"process {process} ({name}):",
              {key: round(ms, 5) for key, ms in res["times"].items()}, flush=True)
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; {'x'.join(map(str, SHAPE))}, {args.launches} launches a timing, "
                 f"band {args.band or 'default'}, windows {args.windows or 'default'}, "
                 "processes in the order of the variants and back; "
                 "experiments/cuda-kstep-tiles/blur_k_variants.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    first = args.variants[0]
    for dname in DTYPE_NAMES:
        for case in ["copy", "trip"] + [f"B9 k={k}" for k in args.ks]:
            med = {name: statistics.median(r["ms_per_launch"] for r in rows
                                           if r["variant"] == name and r["dtype"] == dname
                                           and r["case"] == case) for name in args.variants}
            print(f"{dname} {case}: " + ", ".join(
                f"{name} {ms:.5f}" + ("" if name == first else
                                      f" ({100 * (ms / med[first] - 1):+.1f}%)")
                for name, ms in med.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
