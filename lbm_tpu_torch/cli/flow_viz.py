"""CLI: render a final_state.dat flow field as a PNG heatmap.

The counterpart of `python -m lbm_tpu.cli.flow_viz` (its `render_field`
arrays equal the reference's). A beyond-reference utility (the reference visualises tile mappings but not
flow fields): reads the standard `final_state.dat` written by any engine
(columns: x y u_x u_y |u| pressure obstacle — LatticeBoltzmannUtils.hpp
format) and renders |u|, u_x, u_y, pressure or vorticity as a colour-mapped
image, obstacles drawn black. Pure numpy + PIL, no matplotlib.

Usage:
    python -m lbm_tpu_torch.cli.flow_viz final_state.dat -o flow.png
        [--field speed|ux|uy|pressure|vorticity] [--scale N]
"""

from __future__ import annotations

import argparse


# a compact viridis-like colormap (8 anchor points, linearly interpolated)
_ANCHORS = [
    (0.267, 0.005, 0.329), (0.283, 0.141, 0.458), (0.254, 0.265, 0.530),
    (0.207, 0.372, 0.553), (0.164, 0.471, 0.558), (0.128, 0.567, 0.551),
    (0.135, 0.659, 0.518), (0.267, 0.749, 0.441), (0.478, 0.821, 0.318),
    (0.741, 0.873, 0.150), (0.993, 0.906, 0.144),
]


def colormap(v):
    """v in [0,1] (any shape) -> float RGB via the anchor ramp."""
    import numpy as np

    anchors = np.asarray(_ANCHORS)
    pos = np.clip(v, 0.0, 1.0) * (len(anchors) - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, len(anchors) - 1)
    t = (pos - lo)[..., None]
    return anchors[lo] * (1 - t) + anchors[hi] * t


def render_field(state_cols, ny, nx, field="speed"):
    """(N,7) final_state columns -> (ny, nx, 4) uint8 RGBA."""
    import numpy as np

    x = state_cols[:, 0].astype(int)
    y = state_cols[:, 1].astype(int)

    def grid(col):
        g = np.zeros((ny, nx))
        g[y, x] = col
        return g

    u_x, u_y = grid(state_cols[:, 2]), grid(state_cols[:, 3])
    obstacle = grid(state_cols[:, 6]) > 0.5
    if field == "speed":
        data = np.hypot(u_x, u_y)
    elif field == "ux":
        data = u_x
    elif field == "uy":
        data = u_y
    elif field == "pressure":
        data = grid(state_cols[:, 5])
    elif field == "vorticity":
        # dv/dx - du/dy on the periodic grid
        data = ((np.roll(u_y, -1, axis=1) - np.roll(u_y, 1, axis=1))
                - (np.roll(u_x, -1, axis=0) - np.roll(u_x, 1, axis=0))) / 2.0
    else:
        raise ValueError(f"unknown field {field!r}")

    lo, hi = float(data.min()), float(data.max())
    norm = (data - lo) / (hi - lo) if hi > lo else np.zeros_like(data)
    rgb = colormap(norm)
    rgb[obstacle] = 0.0  # obstacles black
    img = np.empty((ny, nx, 4), np.uint8)
    img[..., :3] = (rgb * 255 + 0.5).astype(np.uint8)
    img[..., 3] = 255
    return img[::-1]  # row 0 is the grid's south — draw it at the bottom


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="flow-field PNG renderer")
    parser.add_argument("final_state", help="final_state.dat file")
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--field", default="speed",
                        choices=["speed", "ux", "uy", "pressure", "vorticity"])
    parser.add_argument("--scale", type=int, default=1,
                        help="integer upscale factor for small grids")
    args = parser.parse_args(argv)

    import numpy as np

    from ..core import io
    from ..utils import image as img_lib

    cols = io.read_final_state(args.final_state)
    ny = int(cols[:, 1].max()) + 1
    nx = int(cols[:, 0].max()) + 1
    img = render_field(cols, ny, nx, args.field)
    if args.scale > 1:
        img = np.repeat(np.repeat(img, args.scale, 0), args.scale, 1)
    img_lib.save_png(args.output, img)
    print(f"wrote {args.output} ({args.field}, {ny}x{nx})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
