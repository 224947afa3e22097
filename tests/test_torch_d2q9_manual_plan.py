"""The box path of the pipelined D2Q9 kernel B3 (manual_box_kernel in
lbm_tpu_torch/csrc/d2q9_manual.cu) as a plan, on the CPU.

`box_schedule` mirrors the kernel's bookkeeping: the persistent grid's blocks
walk the tiles in rounds, three region buffers rotate (the tile's region,
the previous dense tile that becomes the work buffer, a free one that
receives the next region's box) and each buffer's mbarrier is waited on at
the parity of its next phase. An independent model of the buffers then runs
every block's rounds and holds the plan to the kernel's hazards: a box lands
only in a buffer that no step of its round touches and that no unfinished
box store still reads; a step writes only a buffer whose store has been
waited on and into which no box is in flight; each wait is on the phase its
box completes; the last round issues nothing. Also the box path's shared
memory (every offset on 128 bytes, against `box_smem_layout` and
`box_smem_bytes`) and B3's `choose_path` on the shapes chip_smoke.py runs.
The kernel itself is held to B2 bit for bit on the card by chip_smoke.py.
"""

import pytest
import torch

from lbm_tpu_torch.ops import d2q9_kstep, d2q9_kstep_manual

SMS = 132  # an H100's SMs
SM_SHARED = 233472  # shared memory of an H100 SM; each block reserves 1,024 more
MODES = ("full", "stream_only", "copy")


def blocks_an_sm(tile, k, itemsize):
    """Blocks an SM holds by shared memory alone (registers allow two of
    B3's box kernel in float32 at 16x32, K=4, as the card's occupancy
    calculator reports: PERF.md)."""
    return SM_SHARED // (d2q9_kstep_manual.box_smem_bytes(*tile, k, itemsize) + 1024)


def box_schedule(ntiles: int, blocks: int, k: int, mode: str) -> list:
    """Per block, one entry a round, as manual_box_kernel runs it: the tile;
    `region`, the buffer its box landed in, and the wait's `parity`; `work`,
    the buffer the steps write first (the previous dense tile's, once its
    store has read it); `issue`, (buffer, tile) of the next region's box or
    None on the last round; `steps`, (source, destination) buffer of each
    step; `dense`, the buffer of the dense tile that the box store reads;
    the mask plane the round reads and the one it fills."""
    plan = []
    for block in range(blocks):
        reg, dns, fre, phases = 0, 1, 2, 0
        rounds, tile, r = [], block, 0
        while tile < ntiles:
            nxt = tile + blocks
            entry = dict(round=r, tile=tile, region=reg, work=dns,
                         issue=(fre, nxt) if nxt < ntiles else None,
                         parity=(phases >> reg) & 1, mask=r & 1, next_mask=(r + 1) & 1)
            phases ^= 1 << reg
            if mode == "copy":
                steps, dense = [(reg, dns)], dns
            else:
                steps, src, dst = [], reg, dns
                for _ in range(k):
                    steps.append((src, dst))
                    src, dst = dst, src
                dense = src
            entry.update(steps=steps, dense=dense)
            rounds.append(entry)
            reg, fre, dns = fre, 3 - fre - dense, dense
            tile, r = nxt, r + 1
        plan.append(rounds)
    return plan


def check_schedule(plan, ntiles: int, blocks: int) -> None:
    """Run every block's rounds on a model of its three buffers and hold the
    plan to the hazards of the kernel."""
    seen = []
    for block, rounds in enumerate(plan):
        in_flight = {0: block}  # buffer -> tile whose box is landing there (the prologue)
        completions = [0, 0, 0]  # phases each buffer's mbarrier has completed
        store_reads = None  # buffer an unfinished box store reads
        holds = {}  # buffer -> what it holds
        for e in rounds:
            assert e["tile"] == block + e["round"] * blocks  # tiles b, b + grid, ...
            seen.append(e["tile"])
            touched = {s for step in e["steps"] for s in step}
            assert touched == {e["region"], e["work"]} and len(touched) == 2
            # 1. the next region's box, at the top of the round
            if e["issue"] is None:
                assert e["tile"] + blocks >= ntiles  # only the last round issues nothing
            else:
                target, nxt = e["issue"]
                assert nxt == e["tile"] + blocks
                assert target not in touched  # no step of this round reads or writes it
                assert target != store_reads  # no unfinished store reads it
                assert target not in in_flight
                in_flight[target] = nxt
            assert e["next_mask"] != e["mask"]  # the next mask never lands in this one's plane
            # 2. the wait on this tile's box: the phase it completes
            assert in_flight.pop(e["region"]) == e["tile"]
            assert e["parity"] == completions[e["region"]] % 2
            completions[e["region"]] += 1
            holds[e["region"]] = ("region", e["tile"])
            # 3. the previous store's read is waited on before the steps
            store_reads = None
            # 4. the steps
            for j, (src, dst) in enumerate(e["steps"], start=1):
                assert src != dst and dst not in in_flight and src not in in_flight
                assert holds[src][1] == e["tile"]
                holds[dst] = ("step", e["tile"], j)
            assert e["dense"] == e["steps"][-1][1]
            # 5. the box store of the dense tile, read until the next round's wait
            store_reads = e["dense"]
        assert not in_flight  # every box that was issued was waited on
    assert sorted(seen) == list(range(ntiles))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ny, nx, k, itemsize", [
    (1024, 1024, 4, 4),  # the flagship: 2,048 tiles over 264 blocks, 7.76 rounds
    (4096, 4096, 4, 4),
    (1024, 1024, 8, 4),
    (1024, 1024, 2, 8),
    (64, 64, 3, 4),      # fewer tiles than blocks: one round each
])
def test_the_rotation_keeps_every_hazard(ny, nx, k, itemsize, mode):
    tile = (16, 32)
    ntiles = (ny // 16) * (nx // 32)
    blocks = min(blocks_an_sm(tile, k, itemsize) * SMS, ntiles)
    check_schedule(box_schedule(ntiles, blocks, k, mode), ntiles, blocks)


def test_the_flagship_schedule():
    """1024^2 at 16x32, K=4, f32: 264 blocks, 8 rounds for the first 200
    blocks and 7 for the rest; the dense tile stays in the region's buffer
    (K even), so the region walks 0, 2, 1, 0, 2, ... and each buffer's
    mbarrier is waited on at parities 0, 1, 0, ..."""
    blocks = blocks_an_sm((16, 32), 4, 4) * SMS
    assert blocks == 264
    plan = box_schedule(2048, blocks, 4, "full")
    assert [len(r) for r in plan].count(8) == 2048 - 7 * 264
    rounds = plan[0]
    assert [e["tile"] for e in rounds] == [264 * r for r in range(8)]
    assert [e["region"] for e in rounds] == [0, 2, 1, 0, 2, 1, 0, 2]
    assert [e["work"] for e in rounds] == [1, 0, 2, 1, 0, 2, 1, 0]
    assert [e["parity"] for e in rounds] == [0, 0, 0, 1, 1, 1, 0, 0]
    assert [e["dense"] for e in rounds] == [e["region"] for e in rounds]
    assert rounds[-1]["issue"] is None and rounds[0]["issue"] == (2, 264)
    # K odd (and the copy mode): the dense tile lands in the work buffer,
    # which stays; the region alternates between the other two
    odd = box_schedule(2048, blocks, 3, "full")[0]
    assert [e["work"] for e in odd] == [1] * 8
    assert [e["region"] for e in odd] == [0, 2, 0, 2, 0, 2, 0, 2]
    assert [e["parity"] for e in odd] == [0, 0, 1, 1, 0, 0, 1, 1]


@pytest.mark.parametrize("tile, k, itemsize", [((16, 32), 4, 4), ((16, 32), 8, 4),
                                               ((16, 32), 2, 8), ((8, 32), 6, 8),
                                               ((16, 16), 8, 8), ((32, 32), 4, 4)])
def test_box_smem_layout(tile, k, itemsize):
    rh, rw = tile[0] + 2 * k, tile[1] + 2 * k
    lay = d2q9_kstep_manual.box_smem_layout(*tile, k, itemsize)
    buf = lay["buffers"][1]
    offsets = [*lay["buffers"], *lay["masks"], lay["bars"], lay["red"], lay["flags"]]
    assert all(o % 128 == 0 for o in offsets) and offsets == sorted(offsets)
    assert buf >= 9 * rh * rw * itemsize and lay["buffers"] == (0, buf, 2 * buf)
    assert lay["masks"][0] == 3 * buf and lay["masks"][1] - lay["masks"][0] >= rh * rw
    assert lay["bars"] - lay["masks"][1] >= rh * rw
    assert lay["red"] - lay["bars"] >= 3 * 8  # three mbarriers
    assert lay["flags"] - lay["red"] >= 2 * d2q9_kstep.WARPS_PER_BLOCK * itemsize
    assert lay["total"] - 128 - lay["flags"] >= rh + rw  # 128 bytes align the base
    assert lay["total"] % 128 == 0
    assert d2q9_kstep_manual.box_smem_bytes(*tile, k, itemsize) == lay["total"]


def test_the_flagship_block():
    # three buffers of 9 x 24 x 40 float32 (34,560 B, on 128), two mask
    # planes of 1,024, the mbarriers, reduction scratch and flags on 128
    # each, and 128 of slack: 106,240 B, two blocks an SM (B2: three)
    assert d2q9_kstep_manual.box_smem_bytes(16, 32, 4, 4) == 3 * 34560 + 2 * 1024 + 4 * 128
    assert d2q9_kstep_manual.box_smem_bytes(16, 32, 4, 4) == 106240
    assert blocks_an_sm((16, 32), 4, 4) == 2
    assert SM_SHARED // (d2q9_kstep.box_smem_bytes(16, 32, 4, 4) + 1024) == 3
    # the thread path's block, a little smaller (no 128-byte offsets)
    assert d2q9_kstep_manual.smem_bytes(16, 32, 4, 4) == 105728


@pytest.mark.parametrize("k, itemsize, path", [
    (1, 4, "thread"), (2, 4, "thread"), (3, 4, "thread"), (4, 4, "box"), (5, 4, "thread"),
    (6, 4, "thread"), (7, 4, "thread"), (8, 4, "box"),
    (1, 8, "thread"), (2, 8, "box"), (3, 8, "thread"), (4, 8, "box"), (5, 8, "thread"),
    (6, 8, "box"), (7, 8, "thread"), (8, 8, "box"),
])
def test_choose_path_on_chip_smokes_parity_cases(k, itemsize, path):
    """phase_parity of chip_smoke.py: 1024^2 at K = 1..8 at B3's tile; B3
    runs on both paths in each type. K values of a whole 16 bytes take the
    box (as B2's rule) where the three buffers fit."""
    tile = d2q9_kstep_manual.choose_tile(1024, 1024, itemsize, k)
    assert d2q9_kstep_manual.choose_path(1024, 1024, tile, k, itemsize) == path
    assert d2q9_kstep.choose_path(1024, 1024, tile, k, itemsize, False) == path
    # the launch's shared memory is the path's, and fits
    smem = d2q9_kstep_manual.launch_smem(1024, 1024)(*tile, k, itemsize)
    expected = (d2q9_kstep_manual.box_smem_bytes if path == "box"
                else d2q9_kstep_manual.smem_bytes)(*tile, k, itemsize)
    assert smem == expected <= d2q9_kstep.SMEM_PER_BLOCK


@pytest.mark.parametrize("ny, nx, path", [
    (1024, 1024, "box"), (4096, 4096, "box"), (8192, 8192, "box"),  # flagship, bench, breakdown
    (64, 1001, "thread"), (72, 130, "thread"),  # edge tiles
    (1024, 1008, "box"), (1000, 1008, "box"), (1024, 1000, "box"),  # narrower tiles
])
def test_choose_path_on_chip_smokes_grids(ny, nx, path):
    for itemsize in (4, 8):
        tile = d2q9_kstep_manual.choose_tile(ny, nx, itemsize, 4)
        assert d2q9_kstep_manual.choose_path(ny, nx, tile, 4, itemsize) == path
    # a state off 16 bytes always takes the thread path
    assert d2q9_kstep_manual.choose_path(ny, nx, (16, 32), 4, 4, aligned=False) == "thread"


def test_choose_path_refuses_what_the_box_cannot_hold():
    # 32x32 at K=8 in float64: three buffers of 9 x 48 x 48 doubles overflow
    assert d2q9_kstep_manual.box_smem_bytes(32, 32, 8, 8) > d2q9_kstep.SMEM_PER_BLOCK
    assert d2q9_kstep_manual.choose_path(1024, 1024, (32, 32), 8, 8) == "thread"
    # B2 holds two of them, and takes its box
    assert d2q9_kstep.choose_path(1024, 1024, (32, 32), 8, 8, False) == "thread"
    assert d2q9_kstep.choose_path(1024, 1024, (16, 32), 8, 4, False) == "box"
    assert d2q9_kstep_manual.choose_path(1024, 1024, (16, 32), 8, 4) == "box"
    assert d2q9_kstep_manual.choose_path(1024, 1024, (16, 64), 8, 4) == "thread"


def test_the_wrapper_reports_no_path_on_the_cpu():
    f = torch.zeros((9, 16, 32), dtype=torch.float64)
    mask = torch.zeros((16, 32), dtype=torch.bool)
    before = d2q9_kstep_manual.last_path
    d2q9_kstep_manual.stepk(f, mask, k_steps=4, omega=1.0, accel_w1=0.0, accel_w2=0.0,
                            accel_row=14)
    assert d2q9_kstep_manual.last_path == before  # only a launch on the card sets it
    assert d2q9_kstep_manual.PATHS == d2q9_kstep.PATHS == ("thread", "box")
