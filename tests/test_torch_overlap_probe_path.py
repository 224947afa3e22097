"""How the manual engines of kernel B11 (lbm_tpu_torch.ops.overlap_probe) move
a stage: `choose_path`, a mirror of manual_box_fits in csrc/overlap_probe.cu,
by tile, width and alignment, and the shared memory of the ring whose stage
slots lie on 128 bytes (`manual_smem_bytes`, a mirror of manual_smem). The
kernel itself is held to its plain version on both paths on the card
(experiments/cuda-kstep-tiles/overlap_probe.py `check_box_paths`, run by
chip_smoke.py).
"""

import pytest

from lbm_tpu_torch.ops import overlap_probe as op


@pytest.mark.parametrize("ny, nx, tile, flat, aligned, path", [
    (4096, 4096, op.TILE, False, True, "box"),       # the sweep's strided stage: one box
    (256, 256, op.TILE, False, True, "box"),
    (72, 100, op.TILE, False, True, "box"),           # edge tiles: zeros in, clipped out
    (4096, 4096, op.ROW_TILE, False, True, "bulk"),  # 512 columns: no box takes them
    (4096, 4096, (1, 256), False, True, "box"),      # ... 256 do
    (4096, 4096, (300, 4), False, True, "bulk"),     # a side over 256
    (4096, 4096, op.TILE, True, True, "bulk"),       # the flat view: one copy a stage already
    (4096, 4096, op.TILE, False, False, "bulk"),     # a buffer off 16 bytes
    (4096, 4098, op.TILE, False, True, "bulk"),      # rows off 16 bytes
    (4096, 4096, (16, 30), False, True, "bulk"),     # tile rows off 16 bytes
    (8, 4096, op.TILE, False, True, "bulk"),         # a tile taller than the grid
    (256, 16, op.TILE, False, True, "bulk"),         # ... wider
])
def test_choose_path(ny, nx, tile, flat, aligned, path):
    assert op.choose_path(ny, nx, tile, flat, aligned) == path


@pytest.mark.parametrize("depth, tile, smem", [
    (2, op.TILE, 73_872), (3, op.TILE, 110_744), (4, op.TILE, 147_616),
    (6, op.TILE, 221_360), (2, op.ROW_TILE, 73_872),
    (2, (3, 4), 128 + 4 * 512 + 16),  # a slot of 432 B takes 512
])
def test_manual_smem_puts_each_slot_on_128_bytes(depth, tile, smem):
    assert op.manual_smem_bytes(depth, tile) == smem
    assert smem <= op.MAX_SMEM


@pytest.mark.parametrize("name", op.STRIDED)
def test_every_strided_engine_takes_the_box_path_at_the_sweep(name):
    """At probe.csv's case (4096^2, band 64) every strided engine in its
    (9, 16, 32) tiles moves a stage as one box, and in (9, 1, 512) tiles as
    bulk copies."""
    for tile, path in ((op.TILE, "box"), (op.ROW_TILE, "bulk")):
        probe = op.ENGINES[name](4096, 4096, 64, 0, tile=tile)
        assert op.choose_path(4096, 4096, probe.tile, probe.flat, aligned=True) == path


def test_a_ring_over_a_block_is_refused():
    with pytest.raises(ValueError, match="shared memory"):
        op.build_manual_depth(4096, 4096, 64, 0, depth=6, tile=(16, 64))
    assert op.manual_smem_bytes(6, (16, 64)) > op.MAX_SMEM
