#!/usr/bin/env python3
"""Time the k-pass blur B9 of two copies of the port on one card, B10 as the control.

Each copy (a directory that holds a `lbm_tpu_torch/` package, e.g. the parent
commit unpacked by `git archive`) runs in a process of its own, which
imports that copy's package and builds its kernels into that copy's
`build/`. Both copies are built before anything is timed. The processes run
in the order A, B, B, A, so that a drift of the card's clock or temperature
falls on both copies alike. Each times, at the padded 4096x4096 RGBA image
of the blur's main path (4x4128x4224) in float32 and in bfloat16: B9
(`stencil.blur_k`, the copy's default band and block) at each k of `--ks`,
B10 (`stencil.blur_step`, which a change to B9 leaves alone: the control),
and a copy of the image (`clone`: the trip alone, image in and out, no
mask). Each is timed `--repeats` times by CUDA events over `--launches`
launches after a warm-up. Writes one CSV row per timing to
results_ab_blur.csv beside this file (or --out), with the path B9 took ("-"
where the copy has no `last_path`), and prints each median, its least and
greatest time, B's median against A's and B9's share of its byte bound.

`--probe` is the short first call after a change to csrc/stencil.cu: what
`nvcc -Xptxas -v` says of it (registers, spills), its shared memory against
`stencil.blur_k_smem_bytes`, B9 against `blur_k_plain` at k = 1..8 in both
types on the vector path (4x304x512 at bands 64 and 100, 3x304x512 at 1, 2
and 8 windows a block, 4x4128x4224 at k = 1, 4, 8) and the thread path
(4x40x250 float32, 4x40x252 bfloat16), bit for bit, with the path of each
launch, then one round of timings of the tree it runs in. `--sass` prints,
for each B9 instance of the built library, its instructions by opcode
(`cuobjdump -sass`), the whole kernel and its longest loop.

Run on a machine with the card, from the repository root:

    git archive PARENT lbm_tpu_torch | tar -x -C build/parent
    python3 experiments/cuda-kstep-tiles/ab_blur.py --a build/parent --b . \\
        [--ks 1 2 4 8] [--launches 30] [--repeats 5] [--out FILE]
    python3 experiments/cuda-kstep-tiles/ab_blur.py --probe
    python3 experiments/cuda-kstep-tiles/ab_blur.py --sass
"""

from __future__ import annotations

import argparse
import csv
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SHAPE, INNER = (4, 4128, 4224), (4096, 4096)
HBM_BYTES_PER_S = 3.35e12
DTYPE_NAMES = ("float32", "bfloat16")


def bound_ms(itemsize: int) -> float:
    """One trip's bytes at the card's memory rate: image in, image out and
    the mask, (2C + 1) values a pixel."""
    c, h, w = SHAPE
    return (2 * c + 1) * h * w * itemsize / HBM_BYTES_PER_S * 1e3


def make(torch, shape, inner, dtype, seed=4):
    """A padded image as the blur's main path has it: noise inside the
    interior, zero in the ring."""
    import numpy as np

    rng = np.random.default_rng(seed)
    interior = np.zeros(shape[1:], np.float32)
    interior[1:1 + inner[0], 1:1 + inner[1]] = 1
    img = rng.random(shape).astype(np.float32) * interior
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


def worker(root: str, ks, launches: int, repeats: int, build_only: bool) -> None:
    """Time B9, B10 and the copy of the package under `root`; print one JSON line."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from lbm_tpu_torch.ops import _build, stencil

    _build.load("stencil")
    if build_only:
        print(json.dumps({}))
        return
    times, paths = {}, {}
    for dname in DTYPE_NAMES:
        x, m = make(torch, SHAPE, INNER, getattr(torch, dname))
        cases = {"copy": lambda: x.clone(), "B10": lambda: stencil.blur_step(x, m)}
        for k in ks:
            cases[f"B9 k={k}"] = lambda k=k: stencil.blur_k(x, m, k_passes=k)
        for rep in range(repeats):
            for name, fn in cases.items():
                key = f"{dname} {name}"
                times.setdefault(key, []).append(time_ms(torch, fn, launches))
                paths[key] = (getattr(stencil, "last_path", None) or "-"
                              if name.startswith("B9") else "")
        del x, m
        torch.cuda.empty_cache()
    print(json.dumps({"times": times, "paths": paths}))


def ptxas_report() -> int:
    """What nvcc -Xptxas -v says of csrc/stencil.cu; its return code."""
    from lbm_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(Path(tmp) / "probe.so"), str(_build.source_path("stencil"))]
        res = subprocess.run(cmd, capture_output=True, text=True)
    lines = [ln for ln in res.stderr.splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln or "error" in ln]
    print("\n".join(lines))
    if res.returncode:
        print(res.stderr)
    return res.returncode


def sass_report() -> int:
    """Instructions by opcode of each B9 instance (blur_k_kernel<T, K>) in
    the library of csrc/stencil.cu, and of the instance's longest loop (the
    instructions between a backward branch and its target)."""
    import collections
    import re
    import shutil

    from lbm_tpu_torch.ops import _build

    lib = _build.build("stencil")
    tool = shutil.which("cuobjdump") or str(Path(_build.nvcc_path()).with_name("cuobjdump"))
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True)
    if res.returncode:
        print(res.stderr)
        return res.returncode
    kernels, name = {}, None
    for line in res.stdout.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1) if "blur_k_kernel" in found.group(1) else None
            if name:
                kernels[name] = []
            continue
        ins = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if name and ins:
            kernels[name].append((int(ins.group(1), 16), ins.group(2).strip()))
    for name, body in kernels.items():
        def ops(lines):
            return collections.Counter(
                re.sub(r"^@!?U?P\w+\s+", "", text).split()[0].split(".")[0] for _, text in lines)
        loops = []
        for addr, text in body:
            jump = re.match(r"(?:@!?U?P\w+\s+)?BRA(?:\.\w+)*\s+(?:\S+,\s+)?(0x[0-9a-f]+)", text)
            if jump and int(jump.group(1), 16) < addr:
                loops.append((int(jump.group(1), 16), addr))
        longest = max(loops, key=lambda lo: lo[1] - lo[0], default=None)
        print(f"{name}: {len(body)} instructions", dict(ops(body).most_common(16)))
        if longest:
            inner = [ins for ins in body if longest[0] <= ins[0] <= longest[1]]
            print(f"  longest loop {hex(longest[0])}..{hex(longest[1])}: {len(inner)} "
                  "instructions", dict(ops(inner).most_common(24)))
    return 0


def probe(args) -> int:
    sys.path.insert(0, str(REPO))
    import torch

    from lbm_tpu_torch.ops import _build, stencil

    if ptxas_report():
        return 1
    lib = _build.load("stencil")
    bad = 0
    for channels, windows, k, dtype in ((1, 1, 1, torch.float32), (4, 2, 4, torch.float32),
                                        (4, 2, 4, torch.bfloat16), (1, 8, 8, torch.bfloat16)):
        itemsize = torch.empty((), dtype=dtype).element_size()
        c_bytes = lib.stencil_k_smem_bytes(channels, windows, k, itemsize)
        py_bytes = stencil.blur_k_smem_bytes(channels, windows, k, dtype)
        print(f"smem channels={channels} windows={windows} k={k} itemsize={itemsize}: kernel "
              f"{c_bytes}, stencil.blur_k_smem_bytes {py_bytes}")
        bad += c_bytes != py_bytes
    default_windows = stencil.K_WINDOWS
    # (shape, interior, types, k, bands, windows a block)
    cases = [((4, 304, 512), (302, 499), DTYPE_NAMES, range(1, 9), (64, 100), (default_windows,)),
             ((3, 304, 512), (302, 499), DTYPE_NAMES, (1, 4, 8), (64,), (1, 2, 8)),
             ((4, 40, 250), (38, 248), ("float32",), range(1, 9), (16,), (default_windows,)),
             ((4, 40, 252), (38, 250), ("bfloat16",), range(1, 9), (16,), (default_windows,)),
             (SHAPE, INNER, DTYPE_NAMES, (1, 4, 8), (None,), (default_windows,))]
    for shape, inner, dnames, ks, bands, windows_list in cases:
        for dname in dnames:
            x, m = make(torch, shape, inner, getattr(torch, dname))
            # a ring that is not zero, so that the periodic wrap matters
            x = x + 0.25 * (1 - m)
            for k in ks:
                ref = stencil.blur_k_plain(x, m, k_passes=k)
                for band, windows in ((b, n) for b in bands for n in windows_list):
                    stencil.K_WINDOWS = windows
                    out = stencil.blur_k(x, m, k_passes=k, band=band)
                    torch.cuda.synchronize()
                    equal = bool(torch.equal(out, ref))
                    err = float((out.float() - ref.float()).abs().max())
                    bad += not equal
                    print(f"B9 {dname} {'x'.join(map(str, shape))} k={k} band={band} "
                          f"windows={windows}: {stencil.last_path} path, "
                          + ("bit-equal" if equal else f"DIFFERS, max abs err {err:.3e}"))
    stencil.K_WINDOWS = default_windows
    res = {}
    for dname in DTYPE_NAMES:
        x, m = make(torch, SHAPE, INNER, getattr(torch, dname))
        res[dname] = {"copy": time_ms(torch, lambda: x.clone(), args.launches),
                      "B10": time_ms(torch, lambda: stencil.blur_step(x, m), args.launches)}
        for k in args.ks:
            res[dname][f"B9 k={k}"] = time_ms(
                torch, lambda: stencil.blur_k(x, m, k_passes=k), args.launches)
        print(f"{dname} at {'x'.join(map(str, SHAPE))}, ms a launch (bound "
              f"{bound_ms(x.element_size()):.5f}):",
              {name: round(ms, 5) for name, ms in res[dname].items()}, flush=True)
        del x, m
    print("probe:", "every case held" if not bad else f"{bad} cases FAILED")
    return 1 if bad else 0


def shown(root: str) -> str:
    path = Path(root).resolve()
    return str(path.relative_to(REPO)) if path.is_relative_to(REPO) else root


def worker_cmd(args, root: str, build_only: bool = False) -> list:
    cmd = [sys.executable, __file__, "--a", args.a, "--b", args.b, "--worker", root,
           "--ks", *map(str, args.ks), "--launches", str(args.launches), "--repeats",
           str(args.repeats)]
    return cmd + ["--build-only"] if build_only else cmd


def finish(proc) -> dict:
    out, err = proc.communicate()
    if proc.returncode:
        print(out, err, file=sys.stderr)
        raise SystemExit(1)
    return json.loads(out.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="directory of copy A (the reference)")
    ap.add_argument("--b", help="directory of copy B (the change)")
    ap.add_argument("--ks", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--launches", type=int, default=30)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--probe", action="store_true", help="ptxas, parity, one round of timings")
    ap.add_argument("--sass", action="store_true", help="B9's instructions by opcode")
    ap.add_argument("--out", default=str(Path(__file__).with_name("results_ab_blur.csv")))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.ks, args.launches, args.repeats, args.build_only)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    if args.sass:
        sys.path.insert(0, str(REPO))
        return sass_report()
    if args.probe:
        return probe(args)
    if not (args.a and args.b):
        ap.error("--a and --b are needed unless --probe")
    builds = [subprocess.Popen(worker_cmd(args, root, build_only=True), stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
              for root in dict.fromkeys((args.a, args.b))]
    for proc in builds:  # both copies' kernels, built side by side before any timing
        finish(proc)
    rows = []
    for order, (label, root) in enumerate((("A", args.a), ("B", args.b), ("B", args.b),
                                           ("A", args.a))):
        res = finish(subprocess.Popen(worker_cmd(args, root), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
        for key, ms_list in res["times"].items():
            dname, kernel = key.split(" ", 1)
            for rep, ms in enumerate(ms_list):
                rows.append(dict(copy=label, root=shown(root), process=order, dtype=dname,
                                 kernel=kernel, path=res["paths"][key], repeat=rep,
                                 ms_per_launch=round(ms, 6)))
        print(f"process {order} ({label}, {shown(root)}):",
              {k: round(statistics.median(v), 5) for k, v in res["times"].items()}, flush=True)
    with open(args.out, "w", newline="") as fh:
        fh.write(f"# {card}; {'x'.join(map(str, SHAPE))}, {args.launches} launches a timing; "
                 f"A = {shown(args.a)}, B = {shown(args.b)}; "
                 "experiments/cuda-kstep-tiles/ab_blur.py\n")
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    kernels = ["copy", "B10"] + [f"B9 k={k}" for k in args.ks]
    for dname, kernel in ((d, n) for d in DTYPE_NAMES for n in kernels):
        med = {}
        for label in ("A", "B"):
            sel = [r for r in rows if r["copy"] == label and r["dtype"] == dname
                   and r["kernel"] == kernel]
            ms = [r["ms_per_launch"] for r in sel]
            med[label] = statistics.median(ms)
            share = (f", {100 * bound_ms(4 if dname == 'float32' else 2) / med[label]:.1f}% "
                     "of the byte bound" if kernel.startswith("B9") else "")
            print(f"{dname} {kernel} {label} ({sel[0]['path'] or '-'} path): median "
                  f"{med[label]:.5f} ms ({min(ms):.5f}-{max(ms):.5f}, {len(ms)} timings){share}")
        print(f"{dname} {kernel}: B against A {100 * (med['B'] / med['A'] - 1):+.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
