"""CLI: render a grid partitioning as a PNG and print load-balance stats.

The counterpart of `python -m lbm_tpu.cli.viz_partition`, on the port's
`parallel/partition.py` (its `render` arrays equal the reference's). The
analogue of the reference's viz_tile_map (main/VisualiseTileMapping.cpp):
device blocks drawn as shaded rectangles (shade = relative load), band
boundaries as lighter lines, plus the load balance / waste / max-speedup
summary (VisualiseTileMapping.cpp:174-199). A host tool: numpy, and PIL to
write the PNG (through `utils/image.py`).

Usage:
    python -m lbm_tpu_torch.cli.viz_partition --ny 1024 --nx 1024 --num-devices 8 \
        [--band 64] [-o partitioning.png] [--json partitioning.json]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..parallel import partition


def render(part: partition.GridPartitioning, ny: int, nx: int,
           scale: int = 1, lanes: bool = False) -> np.ndarray:
    """Shaded RGBA rendering of a partitioning.

    With lanes=True adds the third level of the reference's render
    (VisualiseTileMapping.cpp:174-199 draws IPU / tile / worker boxes):
    the 8x128 register-tile grid of the reference's planner inside each
    slice, with the cells of partial tiles — the source of
    ``stats().wasted_lane_cells`` — tinted red so lane-level padding is
    visible."""
    img = np.zeros((ny, nx, 4), dtype=np.uint8)
    img[..., 3] = 255
    max_area = max(s.area for s in part.values())
    for tgt, sl in part.items():
        shade = int(64 + 160 * (sl.area / max_area))
        # colour varies with device for visual separation
        hue = (tgt.device_row * 7 + tgt.device_col * 13 + tgt.band * 3) % 6
        rgb = [(shade, shade // 2, 40), (40, shade, shade // 2),
               (shade // 2, 40, shade), (shade, shade, 40),
               (40, shade, shade), (shade, 40, shade)][hue]
        img[sl.row_start : sl.row_end, sl.col_start : sl.col_end, :3] = rgb
        if lanes and sl.area > 0:
            blk = img[sl.row_start : sl.row_end,
                      sl.col_start : sl.col_end, :3]
            # partial-tile cells first (red tint), gridlines on top
            hpart = sl.height % partition.VPU_SUBLANES
            wpart = sl.width % partition.VPU_LANES
            if hpart:
                edge = blk[-hpart:, :]
                edge[..., 0] = np.minimum(edge[..., 0].astype(int) + 120, 255)
            if wpart:
                edge = blk[:, -wpart:]
                edge[..., 0] = np.minimum(edge[..., 0].astype(int) + 120, 255)
            blk[:: partition.VPU_SUBLANES, :] = np.maximum(
                blk[:: partition.VPU_SUBLANES, :], 110)
            blk[:, :: partition.VPU_LANES] = np.maximum(
                blk[:, :: partition.VPU_LANES], 110)
        # 1-px border
        img[sl.row_start, sl.col_start : sl.col_end, :3] = 255
        img[sl.row_end - 1, sl.col_start : sl.col_end, :3] = 255
        img[sl.row_start : sl.row_end, sl.col_start, :3] = 255
        img[sl.row_start : sl.row_end, sl.col_end - 1, :3] = 255
    if scale > 1:
        img = np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)
    return img


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="visualise a grid partitioning")
    parser.add_argument("--ny", type=int, required=True)
    parser.add_argument("--nx", type=int, required=True)
    parser.add_argument("--num-devices", type=int, required=True)
    parser.add_argument("--band", type=int, default=None,
                        help="also subdivide into row-bands")
    parser.add_argument("--blocks", type=int, default=None,
                        help="subdivide each device slice into ~N blocks "
                             "via the strategy family (reference: "
                             "toTilePartitionsForSingleIpu)")
    parser.add_argument("--strategy", default="auto",
                        choices=["auto", "rows", "cols", "grid", "single"],
                        help="block strategy for --blocks (auto = per-slice "
                             "shape dispatch)")
    parser.add_argument("--overlay", type=int, nargs=2, metavar=("R", "C"),
                        default=None,
                        help="fixed RxC overlay per device slice "
                             "(newTilePartitions analogue)")
    parser.add_argument("--lanes", action="store_true",
                        help="overlay the 8x128 register-tile grid and "
                             "tint partial-tile (wasted-lane) cells")
    parser.add_argument("-o", "--output", default="partitioning.png")
    parser.add_argument("--json", default=None, help="also dump JSON mapping")
    parser.add_argument("--scale", type=int, default=1)
    args = parser.parse_args(argv)

    part = partition.partition_for_devices(args.ny, args.nx, args.num_devices)
    if args.overlay:
        part = partition.fixed_overlay_partitions(part, *args.overlay)
    elif args.blocks:
        part = partition.to_block_partitions(part, args.blocks,
                                             strategy=args.strategy)
    elif args.band:
        part = partition.to_band_partitions(part, args.band)

    st = partition.stats(part)
    print(f"targets:       {st.num_targets}")
    print(f"cells/target:  min {st.min_cells}  max {st.max_cells}  "
          f"mean {st.mean_cells:.1f}")
    print(f"load balance:  {100 * st.load_balance:.1f}%")
    print(f"max speedup:   {st.max_speedup:.2f}x over {st.num_targets} targets")
    # wasted-hardware metrics (reference: VisualiseTileMapping.cpp:174-199)
    print(f"wasted targets: {st.wasted_targets} (assigned zero cells)")
    print(f"lane util:     {100 * st.lane_utilisation:.1f}% "
          f"({st.wasted_lane_cells} padding cells to fill 8x128 tiles)")

    from ..utils import image as img_lib

    img_lib.save_png(args.output,
                     render(part, args.ny, args.nx, args.scale,
                            lanes=args.lanes))
    print(f"wrote {args.output}")
    if args.json:
        partition.serialize_to_json(part, args.json)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
