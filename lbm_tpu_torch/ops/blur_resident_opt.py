"""The resident-blur variants v0-v7: the wrappers of CUDA kernel B13.

The counterpart of experiments/blur-resident-opt/run.py, whose one
`pl.pallas_call` site (`_vmem_call`) serves eight kernel bodies. Each runs a
whole sequence of 3x3 blur passes, (1 2 1; 2 4 2; 1 2 1)/16 with periodic
edges, on an image held in fast memory throughout, and they differ in how a
pass is written:

  v0-roll        B8's pass: rows = (below + 2 mid) + above, then the same
                 across columns, x 1/16, x interior mask; float32 state
  v1-concat      v0 with shifts by slice+concat (the same values)
  v2-rank2       v0 on the (h, w*C) layout: horizontal neighbours are C
                 flat columns away, the mask is repeated C times a row
  v3-bf16        v0 on a bfloat16 state, rounded at the end of every pass
  v4-folded      rows = 0.25 (below + above) + 0.5 mid, then the same across
                 columns, x interior mask
  v5-ringzero    v4 with the pad ring set to zero instead of the mask
  v6-bf16-fold   v5 on a bfloat16 state, rounded at the end of every pass
  v7-bf16-arith  v6 with every operation rounded to bfloat16

On the card the image does not fit one SM, so every variant is one instance
of the resident template that B8 is an instance of too
(csrc/blur_resident.cuh; the entries in csrc/blur_resident_opt.cu): one
cooperative launch, one tile per SM with a halo `depth` cells deep in shared
memory for the whole run, `depth` passes a block between two exchanges of
tile edges, and no grid barrier: a block polls its neighbours' edge words,
each tagged with its exchange (`exchange` keeps the words and the tags). The
tile comes from `tiling`, the depth from `choose_depth`. v0 and v1 differ
on the TPU only in how a shift is lowered; on the card both are the same
index arithmetic, so they share one instance (`SPECS[...].instance`), which
is B8's own: `stencil.resident_tiling` is v0's `tiling`.

`build(variant, img, hw0)` returns (call, layout) as run.py's `build` does
(a harness may name the depth, to sweep it);
call(n, img, interior) runs `n // 2` pairs of passes (run.py's `_pingpong`:
an odd n runs n - 1 passes, where `stencil.blur_resident` raises), on the
(C, h, w) image or, for layout "rank2", on its (h, w*C) form (`to_rank2`).
On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
the variant's plain version (`plain`: eager PyTorch, op by op, in the
variant's own order and types); any other device is refused. A variant
whose tiles do not fit the SMs' shared memory raises ValueError at build.
`launches` counts the kernel's launches by variant.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .stencil import DTYPES, H100_SMS, REFUSALS, RESIDENT_THREADS, SMEM_PER_BLOCK, device_limits

# run.py's `variants` list (main), in its order
VARIANTS = ("v0-roll", "v1-concat", "v2-rank2", "v3-bf16", "v4-folded", "v5-ringzero",
            "v6-bf16-fold", "v7-bf16-arith")


@dataclass(frozen=True)
class Spec:
    """What a variant's pass is: its instance in csrc/blur_resident_opt.cu,
    the state's type, folded coefficients (0.25/0.5) or B8's (1 2 1, 1/16),
    the pad ring zeroed instead of a mask multiply, the (h, w*C) layout, and
    bfloat16 arithmetic."""
    instance: str
    state: torch.dtype
    folded: bool = False
    ring: bool = False
    rank2: bool = False
    bf16_arith: bool = False


F32, BF16 = torch.float32, torch.bfloat16
SPECS = {
    "v0-roll": Spec("v0", F32),
    "v1-concat": Spec("v0", F32),
    "v2-rank2": Spec("v2", F32, rank2=True),
    "v3-bf16": Spec("v3", BF16),
    "v4-folded": Spec("v4", F32, folded=True),
    "v5-ringzero": Spec("v5", F32, folded=True, ring=True),
    "v6-bf16-fold": Spec("v6", BF16, folded=True, ring=True),
    "v7-bf16-arith": Spec("v7", BF16, folded=True, ring=True, bf16_arith=True),
}
# the widest row a block's index arithmetic takes, halo included (div_small)
MAX_ROW = 1023
# the deepest halo the kernel takes: passes a block per exchange (kMaxDepth)
MAX_DEPTH = 8
# What an exchange of tile edges costs a block, in cells of a pass: fits of
# t(k) = t_cell * mean cells + t_exchange / k to ab_resident.py --probe
# --depth 1..8 on an H100 (80GB HBM3, 700 W) give 2,180-3,320 (v0, v5, v6
# at bricks, v6 at leaf; PERF.md section 6)
EXCHANGE_CELLS = 3000

# Launches of kernel B13, by variant; callers may reset the counts.
launches = dict.fromkeys(VARIANTS, 0)


def to_rank2(img: torch.Tensor) -> torch.Tensor:
    """(C, h, w) -> (h, w*C), a pixel's channels side by side (run.py's
    `transpose(1, 2, 0).reshape(h, w * c)`)."""
    c, h, w = img.shape
    return img.permute(1, 2, 0).reshape(h, w * c)


def from_rank2(x: torch.Tensor, c: int) -> torch.Tensor:
    """(h, w*C) -> (C, h, w), the inverse of `to_rank2`."""
    h, wc = x.shape
    return x.reshape(h, wc // c, c).permute(2, 0, 1).contiguous()


def rank2_interior(interior: torch.Tensor, c: int) -> torch.Tensor:
    """The (h, w*C) mask of the rank-2 layout (run.py's `repeat(interior, c,
    axis=1)`)."""
    return interior.repeat_interleave(c, dim=1)


# ------------------------------------------------------------ plain versions

def _sh(x: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    """out[i] = x[i + d], periodic: run.py's `sh`, and its `pltpu.roll(x, n - d)`."""
    return torch.roll(x, -d, dims=dim)


def ring_mask(h: int, w: int, h0: int, w0: int, device=None) -> torch.Tensor:
    """run.py's `_ring_mask`: True on row 0, rows past h0, column 0 and
    columns past w0; shape (1, h, w)."""
    rr = torch.arange(h, device=device).view(1, h, 1)
    cc = torch.arange(w, device=device).view(1, 1, w)
    return (rr == 0) | (rr > h0) | (cc == 0) | (cc > w0)


def _pass(spec: Spec, x: torch.Tensor, edge: torch.Tensor, step: int) -> torch.Tensor:
    """One pass of a variant on its state x: rows along dim -2, then columns
    `step` apart along dim -1; `edge` is the float32 mask, or the ring of the
    ring variants."""
    if spec.bf16_arith:  # v7: every operation in bfloat16
        quarter = torch.tensor(0.25, dtype=BF16, device=x.device)
        half = torch.tensor(0.5, dtype=BF16, device=x.device)
        rows = quarter * (_sh(x, 1, -2) + _sh(x, -1, -2)) + half * x
        acc = quarter * (_sh(rows, step, -1) + _sh(rows, -step, -1)) + half * rows
        return torch.where(edge, torch.zeros((), dtype=BF16, device=x.device), acc)
    xf = x.float()
    if spec.folded:
        rows = 0.25 * (_sh(xf, 1, -2) + _sh(xf, -1, -2)) + 0.5 * xf
        acc = 0.25 * (_sh(rows, step, -1) + _sh(rows, -step, -1)) + 0.5 * rows
    else:
        rows = _sh(xf, 1, -2) + 2.0 * xf + _sh(xf, -1, -2)
        acc = _sh(rows, step, -1) + 2.0 * rows + _sh(rows, -step, -1)
        acc = acc * (1.0 / 16.0)
    if spec.ring:
        return torch.where(edge, torch.zeros((), dtype=x.dtype, device=x.device),
                           acc.to(x.dtype))
    return (acc * edge).to(x.dtype)


def plain(variant: str, n: int, img: torch.Tensor, interior: torch.Tensor,
          hw0: tuple[int, int], c: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of a variant: run.py's `_pingpong` around
    its pass, eager and op by op in the variant's order and types. `img` is
    (C, h, w), or (h, w*C) for v2, whose channel count `c` then sets the
    column step."""
    spec = SPECS[variant]
    x = img.to(spec.state)
    if spec.rank2:
        edge, step = interior.float(), c
    elif spec.ring:
        edge, step = ring_mask(img.shape[-2], img.shape[-1], *hw0, device=img.device), 1
    else:
        edge, step = interior.float()[None], 1
    for _ in range(2 * (int(n) // 2)):
        x = _pass(spec, x, edge, step)
    return x.to(img.dtype)


# ------------------------------------------------------------------- tiling

def halo_cols(variant: str, c: int) -> int:
    """Columns of a tile's halo on each side: C for the rank-2 layout, else 1."""
    return c if SPECS[variant].rank2 else 1


def resident_bytes(variant: str, tile: tuple[int, int], c: int = 1, depth: int = 1) -> int:
    """Dynamic shared memory of one block: two state buffers of the tile
    plus a halo of `depth` rows and `depth` x `halo_cols` columns a side,
    and, except for the ring variants, the mask in the state's type over the
    tile and a halo one cell less deep, every cell a pass computes (mirrors
    resident_smem_bytes in csrc/blur_resident.cuh). `c` only matters for
    v2. At depth 1: the tile's mask, the bytes the tiling rule counts."""
    spec = SPECS[variant]
    th, tw = tile
    hw = halo_cols(variant, c)
    plane = (th + 2 * depth) * (tw + 2 * depth * hw)
    mask = 0 if spec.ring else (th + 2 * depth - 2) * (tw + 2 * (depth - 1) * hw)
    return spec.state.itemsize * (2 * plane + mask)


def _tiles(variant: str, c: int, h: int, w: int, sms: int):
    """Every (tile, block bytes) the kernel takes for a (c, h, w) image with
    at most one block per SM (the rank-2 layout is one (h, w*C) plane)."""
    hw = halo_cols(variant, c)
    planes, width = (1, w * c) if SPECS[variant].rank2 else (c, w)
    per_plane = sms // planes
    for rows in range(1, min(h, per_plane) + 1):
        th = -(-h // rows)
        nty = -(-h // th)
        for cols in range(1, min(width, per_plane // nty) + 1):
            tw = -(-width // cols)
            ntx = -(-width // tw)
            # the index arithmetic's range, and a last tile that holds the halo
            if (tw + 2 * hw > MAX_ROW or (th + 2) * (tw + 2 * hw) >= 65536
                    or width - (ntx - 1) * tw < hw):
                continue
            yield (th, tw), resident_bytes(variant, (th, tw), c)


def _fewest_cells(tiles) -> tuple[int, int] | None:
    best = None
    for (th, tw), _ in tiles:
        key = (th * tw, th + tw)
        if best is None or key < best[0]:
            best = (key, (th, tw))
    return None if best is None else best[1]


@functools.lru_cache(maxsize=256)
def tiling(variant: str, c: int, h: int, w: int, sms: int = H100_SMS,
           smem: int = SMEM_PER_BLOCK) -> tuple[int, int] | None:
    """The tile (rows, columns) of a variant for a (c, h, w) image on a
    device of `sms` SMs with `smem` bytes of shared memory a block:
    `stencil.resident_tiling`'s rule (one block per SM at most; the fewest
    cells a block, then the shortest edges) at the variant's bytes a value
    and halo. For v2 the tile is one of the (h, w*C) plane. None when no
    tile fits."""
    return _fewest_cells(t for t in _tiles(variant, c, h, w, sms) if t[1] <= smem)


def needed_bytes(variant: str, c: int, h: int, w: int, sms: int = H100_SMS) -> int:
    """The bytes a block would need at the tile the rule picks with no limit
    of shared memory: what a variant that does not fit asks for."""
    tile = _fewest_cells(_tiles(variant, c, h, w, sms))
    if tile is None:
        raise ValueError(f"{variant}: no tile of the kernel covers a {c}x{h}x{w} image")
    return resident_bytes(variant, tile, c)


def _layout(variant: str, c: int, h: int, w: int) -> tuple[int, int, int]:
    """(planes, rows, columns) the kernel sees: (C, h, w), or v2's one
    (h, w*C) plane."""
    return (1, h, w * c) if SPECS[variant].rank2 else (c, h, w)


def max_depth(variant: str, c: int, h: int, w: int, tile: tuple[int, int],
              smem: int = SMEM_PER_BLOCK) -> int:
    """The deepest halo the kernel takes at this tile: at most MAX_DEPTH;
    as many rows as the last tile row has and `halo_cols` x depth columns
    within the last tile column (a halo comes from the next tile alone); the
    index ranges of `_tiles`; the block's bytes within `smem`. 0 when even
    depth 1 does not fit."""
    hw = halo_cols(variant, c)
    _, hh, ww = _layout(variant, c, h, w)
    th, tw = tile
    last_h, last_w = hh - (-(-hh // th) - 1) * th, ww - (-(-ww // tw) - 1) * tw
    best = 0
    for k in range(1, MAX_DEPTH + 1):
        if (k > last_h or k * hw > last_w or tw + 2 * k * hw > MAX_ROW
                or (th + 2 * k) * (tw + 2 * k * hw) >= 65536
                or resident_bytes(variant, tile, c, k) > smem):
            break
        best = k
    return best


def depth_cost(variant: str, c: int, tile: tuple[int, int], depth: int) -> float:
    """A pass's cost at `depth`, in cells: the mean region a block computes
    over its group of passes (the tile and a halo that shrinks from depth -
    1 cells to none) and its share of one exchange."""
    th, tw = tile
    hw = halo_cols(variant, c)
    cells = sum((th + 2 * d) * (tw + 2 * d * hw) for d in range(depth))
    return (cells + EXCHANGE_CELLS) / depth


def choose_depth(variant: str, c: int, h: int, w: int, tile: tuple[int, int],
                 smem: int = SMEM_PER_BLOCK) -> int:
    """The passes a block runs between two exchanges at a tile the tiling
    rule gave: of the depths the tile takes (`max_depth`), the one of the
    least `depth_cost`; at least 1, which holds what the tiling rule
    counted."""
    deepest = max(1, max_depth(variant, c, h, w, tile, smem))
    return min(range(1, deepest + 1), key=lambda k: depth_cost(variant, c, tile, k))


def exchange_words(variant: str, c: int, h: int, w: int, tile: tuple[int, int],
                   depth: int) -> tuple[int, int]:
    """Exchange words (unsigned 64-bit) of a launch, rows and columns, in
    the kernel's layout (csrc/blur_resident.cuh): two parities x planes x
    tile rows x 2 sides x depth rows x the width, and two parities x planes
    x tile columns x 2 sides x depth x `halo_cols` columns x the height."""
    planes, hh, ww = _layout(variant, c, h, w)
    th, tw = tile
    k, hw = depth, halo_cols(variant, c)
    return (2 * planes * -(-hh // th) * 2 * k * ww, 2 * planes * -(-ww // tw) * 2 * k * hw * hh)


def exchanges(num_passes: int, depth: int) -> int:
    """Exchanges of a launch: one between two groups of `depth` passes."""
    return max(0, -(-int(num_passes) // depth) - 1)


# the tags of an exchange word are 32-bit; 0 is a word never written
TAG_LIMIT = 2**32 - 1
# Exchange words by (device, stream), with the last tag given out on them.
_EXCHANGE: dict = {}


def exchange(device, stream: int, row_words: int, col_words: int,
             count: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(xrow, xcol, tag0) for a launch on `stream` that makes `count`
    exchanges: its tags are tag0 + 1 .. tag0 + count.

    The kernel polls a word until its tag is the one it waits for, so no
    word may carry such a tag before the launch writes it. The words of a
    stream are kept from launch to launch and zeroed when made (tag 0 is
    never given out), and each launch continues the count of tags where the
    last one on them stopped: a word left by an earlier launch, whatever its
    layout, carries a lower tag. Before the count would pass 32 bits the
    words are zeroed again, in stream order. Launches on one stream run in
    turn, so they may share the words; another stream gets its own."""
    key = (str(torch.device(device)), stream)
    words, used = _EXCHANGE.get(key, (None, 0))
    if words is None or words.numel() < row_words + col_words:
        words, used = torch.zeros(row_words + col_words, dtype=torch.int64, device=device), 0
    elif used + count > TAG_LIMIT:
        words.zero_()
        used = 0
    _EXCHANGE[key] = (words, used + count)
    return words[:row_words], words[row_words:row_words + col_words], used


# ------------------------------------------------------------------ kernel

class Resident:
    """A built variant for one image shape (see the module doc); call it as
    run.py's kernel: call(n, img, interior)."""

    def __init__(self, variant: str, shape: tuple[int, int, int], hw0: tuple[int, int],
                 tile: tuple[int, int], depth: int):
        self.variant, self.spec = variant, SPECS[variant]
        self.c, self.h, self.w = shape
        self.hw0 = tuple(int(v) for v in hw0)
        self.tile, self.depth = tile, depth
        self.layout = "rank2" if self.spec.rank2 else None
        self.shape = (self.h, self.w * self.c) if self.spec.rank2 else tuple(shape)
        self.block_bytes = resident_bytes(variant, tile, self.c, depth)
        th, tw = tile
        # the grid (planes, tile rows, tile columns)
        self.grid = (1 if self.spec.rank2 else self.c, -(-self.shape[-2] // th),
                     -(-self.shape[-1] // tw))
        self.blocks = self.grid[0] * self.grid[1] * self.grid[2]

    def __repr__(self):
        return (f"Resident({self.variant}, {self.c}x{self.h}x{self.w}, hw0={self.hw0}, "
                f"tile={self.tile}, depth={self.depth})")

    def plain(self, n: int, img: torch.Tensor, interior: torch.Tensor) -> torch.Tensor:
        self._check(img, interior)
        return plain(self.variant, n, img, interior, self.hw0, self.c)

    def __call__(self, n: int, img: torch.Tensor, interior: torch.Tensor) -> torch.Tensor:
        self._check(img, interior)
        if img.device.type == "cpu":
            return plain(self.variant, n, img, interior, self.hw0, self.c)
        if img.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs a CUDA tensor, got one on {img.device}")
        from . import _build

        th, tw = self.tile
        hh, ww = self.shape[-2], self.shape[-1]
        passes = 2 * (int(n) // 2)
        stream = torch.cuda.current_stream(img.device).cuda_stream
        xrow, xcol, tag0 = exchange(
            img.device, stream, *exchange_words(self.variant, self.c, self.h, self.w, self.tile,
                                                self.depth), exchanges(passes, self.depth))
        out = torch.empty_like(img)
        suffix = "f32" if img.dtype == F32 else "bf16"
        entry = getattr(_build.load("blur_resident_opt"),
                        f"blur_resident_opt_{self.spec.instance}_{suffix}")
        launches[self.variant] += 1
        rc = entry(img.data_ptr(), interior.data_ptr(), out.data_ptr(), xrow.data_ptr(),
                   xcol.data_ptr(), self.c, hh, ww, th, tw, *self.hw0, passes,
                   self.depth, tag0, RESIDENT_THREADS, stream)
        if rc != 0:
            raise RuntimeError(f"blur_resident_opt ({self!r}): "
                               + (REFUSALS.get(rc) or f"CUDA error {rc} at launch"))
        return out

    def _check(self, img: torch.Tensor, interior: torch.Tensor) -> None:
        if tuple(img.shape) != self.shape:
            raise ValueError(f"{self.variant}: image must have shape {self.shape}, "
                             f"got {tuple(img.shape)}")
        if img.dtype not in DTYPES:
            raise ValueError(f"the kernel takes float32 or bfloat16, got {img.dtype}")
        if (tuple(interior.shape) != self.shape[-2:] or interior.dtype != img.dtype
                or interior.device != img.device):
            raise ValueError(f"interior must be {self.shape[-2:]} {img.dtype} on {img.device}")
        if not img.is_contiguous() or not interior.is_contiguous():
            raise ValueError("image and interior must be contiguous")


def build(variant: str, img: torch.Tensor, hw0: tuple[int, int], depth: int | None = None):
    """run.py's `build`: (call, layout) for a (C, h, w) image whose interior
    is rows 1..h0 and columns 1..w0 (the ring variants zero the rest). The
    call takes the image in the layout: (C, h, w), or (h, w*C) for "rank2".
    Raises ValueError when the variant's tiles cannot be resident on the
    image's device (the H100's 132 SMs x 232,448 B for a CPU tensor).
    `depth`, the passes a block runs between two exchanges, is the rule's
    (`choose_depth`) unless a harness names one the tile takes (`max_depth`)."""
    if variant not in SPECS:
        raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")
    if img.dim() != 3:
        raise ValueError(f"image must have shape (C, H, W), got {tuple(img.shape)}")
    c, h, w = img.shape
    sms, smem = device_limits(img.device)
    tile = tiling(variant, c, h, w, sms, smem)
    if tile is None:
        raise ValueError(
            f"{variant}: a {c}x{h}x{w} image needs {needed_bytes(variant, c, h, w, sms):,} B "
            f"of shared memory a block with one tile per SM, more than the {smem:,} B a "
            f"block may use on this device ({sms} SMs)")
    deepest = max_depth(variant, c, h, w, tile, smem)
    if depth is None:
        depth = choose_depth(variant, c, h, w, tile, smem)
    elif not 1 <= depth <= deepest:
        raise ValueError(f"{variant}: depth {depth} at tile {tile} of a {c}x{h}x{w} image; "
                         f"the tile takes 1..{deepest}")
    call = Resident(variant, (c, h, w), hw0, tile, depth)
    return call, call.layout
