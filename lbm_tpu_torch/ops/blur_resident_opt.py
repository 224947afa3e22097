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
cooperative launch, one tile per SM in shared memory for the whole run, an
exchange of tile edges and a grid barrier after each pass. v0 and v1 differ
on the TPU only in how a shift is lowered; on the card both are the same
index arithmetic, so they share one instance (`SPECS[...].instance`), which
is B8's own: `stencil.resident_tiling` is v0's `tiling`.

`build(variant, img, hw0)` returns (call, layout) as run.py's `build` does;
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


def resident_bytes(variant: str, tile: tuple[int, int], c: int = 1) -> int:
    """Dynamic shared memory of one block: two state buffers of the tile
    plus a halo of one row and `halo_cols` columns a side, and, except for
    the ring variants, the tile's mask in the state's type (mirrors
    resident_smem_bytes in csrc/blur_resident.cuh). `c` only matters for v2."""
    spec = SPECS[variant]
    th, tw = tile
    plane = (th + 2) * (tw + 2 * halo_cols(variant, c))
    return spec.state.itemsize * (2 * plane + (0 if spec.ring else th * tw))


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


# ------------------------------------------------------------------ kernel

class Resident:
    """A built variant for one image shape (see the module doc); call it as
    run.py's kernel: call(n, img, interior)."""

    def __init__(self, variant: str, shape: tuple[int, int, int], hw0: tuple[int, int],
                 tile: tuple[int, int]):
        self.variant, self.spec = variant, SPECS[variant]
        self.c, self.h, self.w = shape
        self.hw0 = tuple(int(v) for v in hw0)
        self.tile = tile
        self.layout = "rank2" if self.spec.rank2 else None
        self.shape = (self.h, self.w * self.c) if self.spec.rank2 else tuple(shape)
        self.block_bytes = resident_bytes(variant, tile, self.c)
        th, tw = tile
        # the grid (planes, tile rows, tile columns) and the column halo
        self.grid = (1 if self.spec.rank2 else self.c, -(-self.shape[-2] // th),
                     -(-self.shape[-1] // tw))
        self.halo = halo_cols(variant, self.c)
        self.blocks = self.grid[0] * self.grid[1] * self.grid[2]

    def __repr__(self):
        return (f"Resident({self.variant}, {self.c}x{self.h}x{self.w}, hw0={self.hw0}, "
                f"tile={self.tile})")

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
        planes, nty, ntx = self.grid
        # the tiles' edge rows and columns, two copies alternating by pass
        xrow = torch.empty(2 * planes * nty * 2 * ww, dtype=self.spec.state, device=img.device)
        xcol = torch.empty(2 * planes * ntx * 2 * self.halo * hh, dtype=self.spec.state,
                           device=img.device)
        out = torch.empty_like(img)
        suffix = "f32" if img.dtype == F32 else "bf16"
        entry = getattr(_build.load("blur_resident_opt"),
                        f"blur_resident_opt_{self.spec.instance}_{suffix}")
        launches[self.variant] += 1
        rc = entry(img.data_ptr(), interior.data_ptr(), out.data_ptr(), xrow.data_ptr(),
                   xcol.data_ptr(), self.c, hh, ww, th, tw, *self.hw0,
                   2 * (int(n) // 2), RESIDENT_THREADS,
                   torch.cuda.current_stream(img.device).cuda_stream)
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


def build(variant: str, img: torch.Tensor, hw0: tuple[int, int]):
    """run.py's `build`: (call, layout) for a (C, h, w) image whose interior
    is rows 1..h0 and columns 1..w0 (the ring variants zero the rest). The
    call takes the image in the layout: (C, h, w), or (h, w*C) for "rank2".
    Raises ValueError when the variant's tiles cannot be resident on the
    image's device (the H100's 132 SMs x 232,448 B for a CPU tensor)."""
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
    call = Resident(variant, (c, h, w), hw0, tile)
    return call, call.layout
