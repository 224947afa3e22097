"""The D2Q9 overlap probes: the wrappers of CUDA kernel B11.

The counterparts of the builders of experiments/d2q9-overlap/probe.py. A
probe moves the bytes of a D2Q9 pass, a (9, ny, nx) float32 state read once
and written once, and runs R dependent rounds of `x * 1.0001 + 0.0001` on
every value in place of the LBM arithmetic. Timing wall(R) shows whether the
copy and the arithmetic overlap; `analyze` turns a CSV of such times into
overlap fractions (experiments/cuda-kstep-tiles/overlap_probe.py times them).

Each `build_*` returns a `Probe`, a callable on a (9, ny, nx) float32
tensor. On a CUDA tensor it launches its kernel (csrc/overlap_probe.cu) or
raises; on a CPU tensor it runs its plain version; any other device is
refused. Every instance rounds the product and the sum of a round apart, as
eager PyTorch does (`work_plain`), so a kernel equals its plain version bit
for bit.

On the card the band survives as the unit of the halo rows, of the smem
partials and of the refusals. The unit of the copies is the (9, 16, 32) tile
(`TILE`): a (9, 64, 4096) band is 9.4 MB, forty times a block's shared
memory. The strided manual engines (`STRIDED`) take another tile, `tile=`:
`ROW_TILE`, (9, 1, 512), holds as many values and makes a stage 9 copies of
2 KB, one a plane, as the TPU's (9, band, nx) stage is 9 strided descriptors;
the (9, 16, 32) tile makes it 144 copies of 128 B.

- `auto` engines: one block a tile, the overlap left to the other blocks
  resident on the SM (the TPU's grid pipeline). The tile moves by TMA where
  `auto_path` says the layout allows it (B12's tile copy,
  csrc/tile_copy.cuh), else one value at a time. `par` changes nothing
  there: a CUDA grid's blocks are always independent. It stays a flag so
  that the CSV keeps the TPU's rows.
- `manual` engines: a persistent grid whose blocks walk their tiles through a
  ring of `depth` shared-memory stages filled and drained asynchronously. A
  strided stage moves as one TMA box each way where `choose_path` says the
  shape allows it ("box"), else as one Hopper bulk copy a row segment
  ("bulk": the (9, 1, 512) row tile, whose 512 columns no box takes);
  `manual_flat` makes one bulk copy a stage. `last_path` names the path of
  the last launch ("tma" or "values" for `auto`, "box" or "bulk" for
  `manual`).
- Aliased engines (`build_manual_alias`, `build_auto_alias`,
  `build_manual_alias_safe`) update their input in place and return it, on
  the card and on the CPU alike: the port's form of
  `input_output_aliases={0: 0}`.
"""

from __future__ import annotations

import csv
import functools
from collections import defaultdict

import torch

# Launches of kernel B11 (one per probe call, two with the smem trait:
# the tiles, then the sum of the partials); callers may reset it.
launches = 0
# The path of the last launch: "tma" or "values" (auto), "box" or "bulk"
# (manual).
last_path = None

# (by, bx) of a tile of both kernel families: 9 x 16 x 32 float32 values,
# 18,432 bytes, so that a depth-6 ring of input and output slots (221,184 B)
# still fits one block's shared memory.
TILE = (16, 32)
ROW_TILE = (1, 512)  # as many values: 9 row segments of 2 KB a stage
DEPTHS = (2, 3, 4, 6)
MAX_SMEM = 227 * 1024  # a block's shared memory on sm_90
MAX_BOX = 256  # TMA's longest side of a box, in values
SMEM_COLS = 128  # the smem trait sums f[0, band_start, :128]


def work_plain(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """`rounds` dependent rounds of x * 1.0001 + 0.0001, the product and the
    sum each rounded (eager `probe._work`, and what the TPU's VPU computes)."""
    for _ in range(rounds):
        x = x * 1.0001 + 0.0001
    return x


def halo_plain(out: torch.Tensor, f: torch.Tensor, band: int) -> torch.Tensor:
    """out with f's rows band_start - 1 and band_end (mod ny) added to each
    band's first and last rows: the `halo` trait."""
    ny = f.shape[1]
    starts = torch.arange(0, ny, band, device=f.device)
    ends = starts + band - 1
    out = out.clone()
    out[:, starts] = out[:, starts] + f[:, (starts - 1) % ny]
    out[:, ends] = out[:, ends] + f[:, (ends + 1) % ny]
    return out


def smem_partials_plain(f: torch.Tensor, band: int) -> torch.Tensor:
    """The partial of each band, sum(f[0, band_start, :128]), in the kernel's
    order: four values a lane in order over 32 lanes, then a halving tree."""
    s = f[0, ::band, :SMEM_COLS].reshape(-1, 32, SMEM_COLS // 32)
    s = ((s[..., 0] + s[..., 1]) + s[..., 2]) + s[..., 3]
    off = 16
    while off:
        s = s[:, :off] + s[:, off:2 * off]
        off //= 2
    return s[:, 0]


def smem_total_plain(f: torch.Tensor, band: int) -> torch.Tensor:
    """The `smem` trait's total: the partials summed in band order from 0."""
    total = torch.zeros((), dtype=f.dtype, device=f.device)
    for p in smem_partials_plain(f, band):
        total = total + p
    return total


def alias_plain(f: torch.Tensor, rounds: int) -> torch.Tensor:
    """The aliased engines: f updated in place, each round rounded as in
    `work_plain`; returns f."""
    for _ in range(rounds):
        f.mul_(1.0001).add_(0.0001)
    return f


def auto_path(nx: int, aligned: bool) -> str:
    """How an `auto` kernel moves its tiles: `tma` where rows are whole
    16-byte pieces and both buffers start on 16 bytes (`aligned`), `values`
    (one at a time) otherwise. TILE's width is a multiple of 4 already."""
    return "tma" if aligned and nx % 4 == 0 else "values"


def manual_smem_bytes(depth: int, tile: tuple) -> int:
    """Dynamic shared memory of the manual kernel: 2 x depth stage slots of
    9 x by x bx float32 values, each on 128 bytes, 128 bytes of slack to
    align the first, and the mbarriers (mirrors manual_smem in
    csrc/overlap_probe.cu)."""
    by, bx = tile
    slot = -(-9 * by * bx * 4 // 128) * 128
    return 128 + 2 * depth * slot + 8 * depth


def choose_path(ny: int, nx: int, tile: tuple, flat: bool, aligned: bool) -> str:
    """How a manual kernel moves a stage (mirrors manual_box_fits in
    csrc/overlap_probe.cu): "box", one TMA box of the strided (9, by, bx)
    tile each way, where TMA takes the shape: rows of the state and of the
    tile whole 16-byte pieces (nx, bx multiples of 4), both buffers on 16
    bytes (`aligned`), sides of at most MAX_BOX and no larger than the grid;
    "bulk", a bulk copy a row segment, otherwise, and always for the flat
    view (one copy a stage already)."""
    by, bx = tile
    fits = (not flat and aligned and nx % 4 == 0 and bx % 4 == 0 and 1 <= by <= min(MAX_BOX, ny)
            and 1 <= bx <= min(MAX_BOX, nx))
    return "box" if fits else "bulk"


def check_build(ny: int, nx: int, band: int, *, min_bands: int = 1, halo: bool = False,
                smem: bool = False, bulk: bool = False, tile: tuple = TILE,
                depth: int = 2) -> None:
    """The refusals of probe.py's builders, and those of the card's kernels
    (`bulk`: the manual kernel's copies and ring of `depth` stages of `tile`)."""
    if ny < 1 or nx < 1 or band < 1:
        raise ValueError(f"ny, nx and band must be positive, got {ny}, {nx}, {band}")
    by, bx = tile
    if by < 1 or bx < 1:
        raise ValueError(f"the tile must be positive, got {tile}")
    if ny % band:
        raise ValueError(f"ny = {ny} is not a multiple of the band ({band}): the TPU grid "
                         "would drop the tail rows")
    nb = ny // band
    if nb < min_bands:
        raise ValueError(f"the pipeline needs >= {min_bands} bands, got {nb}")
    if halo and band % 8:
        raise ValueError(f"the halo trait needs band % 8 == 0, got {band}")
    if smem and nx < SMEM_COLS:
        raise ValueError(f"the smem trait needs nx >= {SMEM_COLS}, got {nx}")
    if bulk and (nx % 4 or bx % 4):
        raise ValueError(f"bulk copies need nx % 4 == 0 and bx % 4 == 0, got nx = {nx}, "
                         f"bx = {bx}")
    ring = manual_smem_bytes(depth, tile)
    if bulk and ring > MAX_SMEM:
        raise ValueError(f"a ring of {depth} stages of a {tile} tile takes {ring} B of shared "
                         f"memory, more than a block's {MAX_SMEM}")


class Probe:
    """A built probe over a (9, ny, nx) float32 state (see the module doc).

    Call it as probe(f) or probe(f, out=buffer); an aliased probe writes f.
    A probe with the smem trait leaves its total, a 0-d tensor on f's
    device, in `total` after each call.
    """

    def __init__(self, kind: str, ny: int, nx: int, band: int, rounds: int, *,
                 features: frozenset = frozenset(), depth: int = 2, flat: bool = False,
                 alias: bool = False, safe: bool = False, tile: tuple = TILE):
        if rounds < 0:
            raise ValueError(f"rounds must be >= 0, got {rounds}")
        unknown = set(features) - {"smem", "halo", "par"}
        if unknown:
            raise ValueError(f"unknown features {sorted(unknown)}")
        self.kind, self.ny, self.nx, self.band, self.rounds = kind, ny, nx, band, rounds
        self.features = frozenset(features)
        self.halo, self.smem = "halo" in features, "smem" in features
        self.depth, self.flat, self.alias, self.safe = depth, flat, alias, safe
        self.tile = tuple(tile)
        self.total = None
        self._blocks = {}

    def __repr__(self):
        return (f"Probe({self.kind}, {self.ny}x{self.nx}, band {self.band}, R={self.rounds}, "
                f"features={sorted(self.features)}, depth={self.depth}, flat={self.flat}, "
                f"alias={self.alias}, safe={self.safe}, tile={self.tile})")

    def plain(self, f: torch.Tensor) -> torch.Tensor:
        """The plain version of this probe on f's device."""
        self._check(f, None)
        if self.alias:
            return alias_plain(f, self.rounds)
        out = work_plain(f, self.rounds) if self.rounds else f.clone()
        if self.halo:
            out = halo_plain(out, f, self.band)
        if self.smem:
            self.total = smem_total_plain(f, self.band)
        return out

    def __call__(self, f: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        global launches, last_path
        self._check(f, out)
        if f.device.type == "cpu":
            res = self.plain(f)
            if out is None or out is res:
                return res
            return out.copy_(res)
        if f.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on {f.device}")
        if self.kind == "manual" and f.data_ptr() % 16:
            raise ValueError("bulk copies need a 16-byte aligned state")
        from . import _build

        lib = _build.load("overlap_probe")
        stream = torch.cuda.current_stream(f.device).cuda_stream
        if self.alias:
            out = f
        elif out is None:
            out = torch.empty_like(f)
        elif self.kind == "manual" and out.data_ptr() % 16:
            raise ValueError("bulk copies need a 16-byte aligned output")
        by, bx = self.tile
        if self.kind == "auto":
            partials = total = None
            if self.smem:
                partials = torch.empty(self.ny // self.band, dtype=f.dtype, device=f.device)
                total = torch.empty((), dtype=f.dtype, device=f.device)
            planes, ny, tile_h = (1, 9 * self.ny, 9 * by) if self.flat else (9, self.ny, by)
            last_path = auto_path(self.nx, f.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
            tma = last_path == "tma"
            launches += 2 if self.smem else 1
            rc = lib.overlap_auto(f.data_ptr(), out.data_ptr(),
                                  partials.data_ptr() if self.smem else None,
                                  total.data_ptr() if self.smem else None, planes, ny, self.nx,
                                  tile_h, bx, self.band, self.rounds, int(self.halo),
                                  int(self.smem), int(tma), stream)
            self.total = total
        else:
            # the buffers of a manual probe were held to 16 bytes above
            last_path = choose_path(self.ny, self.nx, self.tile, self.flat, aligned=True)
            launches += 1
            rc = lib.overlap_manual(f.data_ptr(), out.data_ptr(), self.ny, self.nx, by, bx,
                                    self.rounds, self.depth, int(self.flat), int(self.safe),
                                    int(last_path == "box"), self.grid_blocks(f.device), stream)
        if rc != 0:
            raise RuntimeError(f"overlap_probe ({self!r}): CUDA error {rc} at launch")
        return out

    def blocks_per_sm(self) -> int:
        """Blocks of this probe's kernel resident on one SM of the current card,
        on the path it takes on an aligned state."""
        from . import _build

        lib = _build.load("overlap_probe")
        if self.kind == "auto":
            by, bx = min(self.tile[0], self.ny), min(self.tile[1], self.nx)
            n = lib.overlap_auto_blocks(int(self.halo), int(self.smem),
                                        int(auto_path(self.nx, True) == "tma"), 9 * by * bx)
        else:
            box = choose_path(self.ny, self.nx, self.tile, self.flat, aligned=True) == "box"
            n = lib.overlap_manual_blocks(self.depth, int(self.flat), int(self.safe), int(box),
                                          *self.tile)
        if n <= 0:
            raise RuntimeError(f"overlap_probe ({self!r}): no block fits the card")
        return n

    def tiles(self) -> int:
        """Tiles of the manual kernel: (9, by, bx) blocks of the state, or
        chunks of 9 x by x bx values of the flat view."""
        by, bx = self.tile
        if self.flat:
            return -(-9 * self.ny * self.nx // (9 * by * bx))
        return -(-self.ny // by) * -(-self.nx // bx)

    def grid_blocks(self, device) -> int:
        """Blocks of the manual kernel's persistent grid: as many as are
        resident at once, at most one per tile."""
        key = str(device)
        if key not in self._blocks:
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            self._blocks[key] = min(self.tiles(), self.blocks_per_sm() * sms)
        return self._blocks[key]

    def _check(self, f: torch.Tensor, out: torch.Tensor | None) -> None:
        if tuple(f.shape) != (9, self.ny, self.nx):
            raise ValueError(f"state must have shape (9, {self.ny}, {self.nx}), "
                             f"got {tuple(f.shape)}")
        if f.dtype != torch.float32:
            raise ValueError(f"the probes take float32, got {f.dtype}")
        if not f.is_contiguous():
            raise ValueError("state must be contiguous")
        if out is None:
            return
        if self.alias and out is not f:
            raise ValueError("an aliased probe writes its input: pass no out")
        if not self.alias:
            if out.shape != f.shape or out.dtype != f.dtype or out.device != f.device:
                raise ValueError("out must match the state's shape, type and device")
            if not out.is_contiguous():
                raise ValueError("out must be contiguous")
            if out.data_ptr() == f.data_ptr():
                raise ValueError("a two-stream probe needs an out apart from its input")


def build_auto(ny: int, nx: int, band: int, rounds: int,
               features: frozenset = frozenset()) -> Probe:
    """The automatic pipeline (probe.py `build_auto`); `features` adds back
    `smem` (a per-band partial summed over the bands), `halo` (the rows just
    outside each band) or `par` (no effect on the card)."""
    check_build(ny, nx, band, halo="halo" in features, smem="smem" in features)
    return Probe("auto", ny, nx, band, rounds, features=features)


def build_manual(ny: int, nx: int, band: int, rounds: int, tile: tuple = TILE) -> Probe:
    """The explicit pipeline with two stages (probe.py `build_manual`), in
    (9, *tile) tiles."""
    check_build(ny, nx, band, min_bands=2, bulk=True, tile=tile)
    return Probe("manual", ny, nx, band, rounds, tile=tile)


def build_manual_depth(ny: int, nx: int, band: int, rounds: int, depth: int = 2,
                       tile: tuple = TILE) -> Probe:
    """The explicit pipeline with a ring of `depth` stages (probe.py
    `build_manual_depth`)."""
    if depth not in DEPTHS:
        raise ValueError(f"depth must be one of {DEPTHS}, got {depth}")
    check_build(ny, nx, band, min_bands=depth, bulk=True, tile=tile, depth=depth)
    return Probe("manual", ny, nx, band, rounds, depth=depth, tile=tile)


def build_manual_flat(ny: int, nx: int, band: int, rounds: int) -> Probe:
    """The explicit pipeline over the flat (9 ny, nx) view, one contiguous
    copy a stage, two stages (probe.py `build_manual_flat` at its default
    depth, the only one its table uses)."""
    check_build(ny, nx, band, min_bands=2, bulk=True)
    return Probe("manual", ny, nx, band, rounds, flat=True)


def build_auto_flat(ny: int, nx: int, band: int, rounds: int) -> Probe:
    """The automatic pipeline over the flat (9 ny, nx) view (probe.py
    `build_auto_flat`)."""
    check_build(ny, nx, band)
    return Probe("auto", ny, nx, band, rounds, flat=True)


def build_manual_alias(ny: int, nx: int, band: int, rounds: int, tile: tuple = TILE) -> Probe:
    """`build_manual` writing its input in place (probe.py
    `build_manual_alias`)."""
    check_build(ny, nx, band, min_bands=2, bulk=True, tile=tile)
    return Probe("manual", ny, nx, band, rounds, alias=True, tile=tile)


def build_auto_alias(ny: int, nx: int, band: int, rounds: int) -> Probe:
    """The automatic pipeline writing its input in place (probe.py
    `build_auto_alias`)."""
    check_build(ny, nx, band)
    return Probe("auto", ny, nx, band, rounds, alias=True)


def build_manual_alias_safe(ny: int, nx: int, band: int, rounds: int,
                            tile: tuple = TILE) -> Probe:
    """The aliased explicit pipeline in the write-after-read order an LBM
    stencil needs: tile i's write starts only after tile i+1's fetch has
    landed (probe.py `build_manual_alias_safe`)."""
    check_build(ny, nx, band, min_bands=3, bulk=True, tile=tile)
    return Probe("manual", ny, nx, band, rounds, alias=True, safe=True, tile=tile)


def build_torch(ny: int, nx: int, band: int, rounds: int):
    """The library baseline (probe.py `build_xla`): eager PyTorch over the
    whole state, max(rounds, 1) rounds (one at R = 0, as build_xla does). No
    kernel of this repository."""
    check_build(ny, nx, band)

    def call(f: torch.Tensor) -> torch.Tensor:
        return work_plain(f, max(rounds, 1))
    return call


# probe.py's table of engines, `xla` -> `torch`
ENGINES = {
    "auto": build_auto,
    "auto_par": functools.partial(build_auto, features=frozenset({"par"})),
    "auto_smem": functools.partial(build_auto, features=frozenset({"smem"})),
    "auto_halo": functools.partial(build_auto, features=frozenset({"halo"})),
    "auto_full": functools.partial(build_auto, features=frozenset({"smem", "halo"})),
    "manual": build_manual,
    "manual3": functools.partial(build_manual_depth, depth=3),
    "manual4": functools.partial(build_manual_depth, depth=4),
    "manual6": functools.partial(build_manual_depth, depth=6),
    "manual_flat": build_manual_flat,
    "auto_flat": build_auto_flat,
    "manual_alias": build_manual_alias,
    "manual_alias_safe": build_manual_alias_safe,
    "auto_alias": build_auto_alias,
    "torch": build_torch,
}
# the engines that copy strided (9, by, bx) tiles, and so take `tile=`
STRIDED = ("manual", "manual3", "manual4", "manual6", "manual_alias", "manual_alias_safe")


def analyze(path) -> None:
    """Overlap fractions from a probe CSV (probe.py `analyze`): for each
    engine, copy = wall(0) of `auto`; compute(R) = auto's wall(R) - copy,
    taking the auto engine as fully serialized; overlap_frac(R) = (copy +
    compute_R - wall_R) / min(copy, compute_R). 0 = serialized, 1 = perfect
    overlap."""
    rows = defaultdict(dict)
    with open(path) as fh:
        for row in csv.DictReader(fh):
            rows[row["engine"]][int(row["rounds"])] = float(row["us_per_iter"])
    if "auto" not in rows or 0 not in rows.get("auto", {}):
        print("need auto R=0 rows as the serial baseline")
        return
    auto = rows["auto"]
    copy_us = auto[0]
    for eng, vals in sorted(rows.items()):
        for r in sorted(vals):
            if r == 0:
                print(f"{eng:10s} R={r:<3d} wall={vals[r]:8.1f}us "
                      f"(copy floor {vals[r] / copy_us:.2f}x auto)")
                continue
            compute = auto.get(r, float("nan")) - copy_us  # serial auto
            denom = min(copy_us, compute)
            frac = (copy_us + compute - vals[r]) / denom if denom > 0 else 0
            print(f"{eng:10s} R={r:<3d} wall={vals[r]:8.1f}us "
                  f"compute~{compute:7.1f}us overlap_frac={frac:+.2f}")
