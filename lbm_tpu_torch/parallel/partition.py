"""Grid partitioning planner & introspection: the port's copy of
`lbm_tpu.parallel.partition` (numpy only, apart from `mesh`).

The recast of the reference's partitioning library (`grids::` in
main/include/StructuredGridUtils.hpp): the three-level IPU hierarchy
(IPU -> tile -> worker) becomes (device -> band -> lane), and the planner
answers the same questions — who owns which slice, how even is the load, how
much hardware is wasted — with the same JSON dump schema for tooling
(`grids::serializeToJson`, StructuredGridUtils.hpp:135-158). Its numbers
(8 x 128 register tiles) are the reference's, kept so that both packages
plan and serialise the same partitions byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

from . import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class Slice2D:
    """Half-open 2-D slice [row_start, row_end) x [col_start, col_end)
    (reference: grids::Slice2D, StructuredGridUtils.hpp:52-88)."""

    row_start: int
    row_end: int
    col_start: int
    col_end: int

    @property
    def height(self) -> int:
        return self.row_end - self.row_start

    @property
    def width(self) -> int:
        return self.col_end - self.col_start

    @property
    def area(self) -> int:
        return self.height * self.width

    def to_dict(self) -> dict:
        return {
            "rows": {"from": self.row_start, "upto": self.row_end},
            "cols": {"from": self.col_start, "upto": self.col_end},
        }


@dataclasses.dataclass(frozen=True)
class Target:
    """Placement of a slice: device in the mesh, band within the device
    (reference: grids::PartitioningTarget, StructuredGridUtils.hpp:96-119)."""

    device_row: int
    device_col: int
    band: int = 0

    def name(self) -> str:
        return f"dev({self.device_row},{self.device_col})-band{self.band}"


GridPartitioning = dict[Target, Slice2D]

VPU_SUBLANES = 8   # f32 register tile height
VPU_LANES = 128    # register tile width


def _split_even(n: int, parts: int) -> list[tuple[int, int]]:
    """Round-robin even split of [0, n) into `parts` contiguous ranges
    (reference: grids::roundRobinFill, StructuredGridUtils.hpp:161-165)."""
    base, extra = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        size = base + (1 if i < extra else 0)
        out.append((start, start + size))
        start += size
    return out


def partition_for_devices(ny: int, nx: int, n_devices: int) -> GridPartitioning:
    """Device-level block decomposition over the best rows x cols mesh shape
    (reference: grids::partitionForIpus, StructuredGridUtils.hpp:472-561)."""
    r, c = mesh_lib.best_factorisation(n_devices, ny, nx, require_even=False)
    rows = _split_even(ny, r)
    cols = _split_even(nx, c)
    return {
        Target(i, j): Slice2D(rs, re, cs, ce)
        for i, (rs, re) in enumerate(rows)
        for j, (cs, ce) in enumerate(cols)
    }


def to_band_partitions(partitioning: GridPartitioning, band: int) -> GridPartitioning:
    """Split each device slice into Pallas row-bands — the analogue of the
    reference's tile-level overlay (grids::toTilePartitions,
    StructuredGridUtils.hpp:568-587)."""
    out: GridPartitioning = {}
    for tgt, sl in partitioning.items():
        n_bands = max(1, sl.height // band)
        for b, (rs, re) in enumerate(_split_even(sl.height, n_bands)):
            out[Target(tgt.device_row, tgt.device_col, b)] = Slice2D(
                sl.row_start + rs, sl.row_start + re, sl.col_start, sl.col_end
            )
    return out


def _overlay_slice(tgt: Target, sl: Slice2D, r: int, c: int,
                   out: GridPartitioning) -> None:
    """R x C even grid overlay of one slice; band index = br * c + bc."""
    for br, (rs, re) in enumerate(_split_even(sl.height, r)):
        for bc, (cs, ce) in enumerate(_split_even(sl.width, c)):
            out[Target(tgt.device_row, tgt.device_col, br * c + bc)] = \
                Slice2D(sl.row_start + rs, sl.row_start + re,
                        sl.col_start + cs, sl.col_start + ce)


def dispatch_strategy(sl: Slice2D, blocks: int, *, min_rows: int = VPU_SUBLANES,
                      min_cols: int = VPU_LANES) -> str:
    """Pick a per-slice block strategy — the TPU recast of the reference's
    strategy dispatch `toTilePartitionsForSingleIpu` (StructuredGridUtils
    .hpp:568-587: singleTile / longAndNarrow / shortAndWide /
    generalTileGrid chosen by slice shape).

    Units are VPU register tiles (min_rows x min_cols = 8 x 128 for f32),
    the shape below which further splitting only manufactures lane waste —
    the analogue of the reference's min-6x6-cells-per-tile rule.
    Returns 'single' | 'rows' | 'cols' | 'grid'.
    """
    r_units = max(1, sl.height // min_rows)
    c_units = max(1, sl.width // min_cols)
    if blocks <= 1 or r_units * c_units == 1:
        return "single"
    if c_units == 1:
        return "rows"        # long-and-narrow: strips along the rows
    if r_units == 1:
        return "cols"        # short-and-wide: strips along the columns
    return "grid"            # both axes splittable: aspect-ratio overlay


def to_block_partitions(partitioning: GridPartitioning, blocks: int, *,
                        strategy: str = "auto",
                        min_rows: int = VPU_SUBLANES,
                        min_cols: int = VPU_LANES) -> GridPartitioning:
    """Subdivide each device slice into ~`blocks` Pallas-block slices using
    a per-slice strategy (the reference's four-strategy tile family).

    strategy='auto' dispatches per slice via `dispatch_strategy`; 'rows' /
    'cols' / 'grid' / 'single' force one. Production kernels use the
    measured `d2q9_pallas.choose_band` heuristic instead (bands won the
    measurements, experiments/min-band-size); this planner family exists
    for introspection/viz parity and for exploring non-band layouts.
    """
    out: GridPartitioning = {}
    for tgt, sl in partitioning.items():
        s = strategy if strategy != "auto" else dispatch_strategy(
            sl, blocks, min_rows=min_rows, min_cols=min_cols)
        if s == "single":
            out[Target(tgt.device_row, tgt.device_col, 0)] = sl
        elif s == "rows":
            n = min(blocks, max(1, sl.height // min_rows))
            _overlay_slice(tgt, sl, n, 1, out)
        elif s == "cols":
            n = min(blocks, max(1, sl.width // min_cols))
            _overlay_slice(tgt, sl, 1, n, out)
        elif s == "grid":
            # aspect-ratio-driven R x C overlay (generalTileGridStrategy,
            # StructuredGridUtils.hpp:309-412), in register-tile units
            r_units = max(1, sl.height // min_rows)
            c_units = max(1, sl.width // min_cols)
            # clamp r to the requested block count too: tall slices would
            # otherwise overshoot (r x 1 blocks >> blocks)
            r = max(1, min(r_units, blocks,
                           round((blocks * r_units / c_units) ** 0.5)))
            c = max(1, min(c_units, blocks // r))
            _overlay_slice(tgt, sl, r, c, out)
        else:
            raise ValueError(f"unknown strategy {s!r}")
    return out


def fixed_overlay_partitions(partitioning: GridPartitioning, rows: int,
                             cols: int) -> GridPartitioning:
    """Fixed rows x cols overlay of every device slice — the analogue of the
    reference's `newTilePartitions` fixed 38x32 per-IPU overlay
    (StructuredGridUtils.hpp:606-645), with the remainder distributed by
    the same round-robin rule."""
    out: GridPartitioning = {}
    for tgt, sl in partitioning.items():
        _overlay_slice(tgt, sl, min(rows, sl.height), min(cols, sl.width),
                       out)
    return out


def serialize_to_json(partitioning: GridPartitioning, path: str | Path | None = None) -> str:
    """Same shape as grids::serializeToJson (StructuredGridUtils.hpp:135-158):
    a mapping of target-name -> slice bounds."""
    doc = {t.name(): s.to_dict() for t, s in sorted(
        partitioning.items(), key=lambda kv: (kv[0].device_row, kv[0].device_col, kv[0].band)
    )}
    text = json.dumps(doc, indent=2)
    if path is not None:
        Path(path).write_text(text)
    return text


@dataclasses.dataclass
class PartitionStats:
    """Load-balance + wasted-hardware metrics (reference:
    VisualiseTileMapping.cpp:174-199, which prints load balance, wasted
    tiles, wasted workers and max speedup). The TPU recast of "wasted
    hardware": idle targets (devices/bands assigned no cells) and VPU-tile
    padding (cells short of full 8x128 f32 register tiles, the lane-level
    analogue of the reference's wasted workers)."""

    num_targets: int
    min_cells: int
    max_cells: int
    mean_cells: float
    load_balance: float  # mean/max: 1.0 = perfectly even
    total_cells: int
    max_speedup: float   # total/max: achievable parallel speedup
    wasted_targets: int = 0       # targets holding zero cells
    wasted_lane_cells: int = 0    # padding cells to fill 8x128 VPU tiles
    lane_utilisation: float = 1.0  # total / (total + wasted_lane_cells)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def stats(partitioning: GridPartitioning) -> PartitionStats:
    areas = [s.area for s in partitioning.values()]
    total = sum(areas)
    mx = max(areas)
    nonzero = [a for a in areas if a > 0]
    waste = sum(
        (-(-s.height // VPU_SUBLANES) * VPU_SUBLANES)
        * (-(-s.width // VPU_LANES) * VPU_LANES) - s.area
        for s in partitioning.values() if s.area > 0
    )
    return PartitionStats(
        num_targets=len(areas),
        min_cells=min(areas),
        max_cells=mx,
        mean_cells=total / len(areas),
        load_balance=(total / len(areas)) / mx,
        total_cells=total,
        max_speedup=total / mx,
        wasted_targets=len(areas) - len(nonzero),
        wasted_lane_cells=waste,
        lane_utilisation=total / (total + waste) if total else 0.0,
    )
