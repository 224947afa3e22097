"""The inputs a run makes from its seed: the flagship's compact mask and the
seeded block offset, the 3-D start state."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from benchmark import harness

from conftest import REPO

CONFIGS = REPO / "benchmark" / "configs"
GOLDEN = REPO / "check" / "1024x1024.final_state.dat.gz"


def driver(name):
    return harness.driver(REPO / "benchmark", name)


def flagship():
    cfg = json.loads((CONFIGS / "d2q9-cavity-1024.json").read_text())
    return driver("d2q9_job").load_mask(CONFIGS / cfg["mask"], cfg["ny"], cfg["nx"]), cfg


def test_the_compact_mask_is_the_golden_files_obstacle_column():
    mask, cfg = flagship()
    assert hashlib.sha256(GOLDEN.read_bytes()).hexdigest() == cfg["mask_source_sha256"]
    cols = np.loadtxt(GOLDEN, usecols=(0, 1, 6))
    golden = np.zeros((cfg["ny"], cfg["nx"]), bool)
    golden[cols[:, 1].astype(int), cols[:, 0].astype(int)] = cols[:, 2] != 0
    assert np.array_equal(mask, golden)
    assert mask.sum() == cfg["mask_cells_blocked"] == 5114


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, 2**31 + 11, 2**33 + 5, 2**62 + 3])
def test_every_seed_keeps_the_block_inside_the_walls(seed):
    mask, _ = flagship()
    moved = driver("d2q9_job").move_block(mask, seed)
    ring = np.zeros_like(mask)
    ring[0] = ring[-1] = True
    ring[:, 0] = ring[:, -1] = True
    assert (moved & ring).sum() == ring.sum()
    assert moved.sum() == mask.sum()
    inner, moved_inner = mask & ~ring, moved & ~ring
    ys, xs = np.nonzero(inner)
    ys2, xs2 = np.nonzero(moved_inner)
    dy, dx = ys2.min() - ys.min(), xs2.min() - xs.min()
    assert np.array_equal(np.roll(inner, (dy, dx), axis=(0, 1)), moved_inner)


def test_seeds_move_the_block_and_repeat():
    mask, _ = flagship()
    move = driver("d2q9_job").move_block
    assert np.array_equal(move(mask, 2**31 + 9), move(mask, 2**31 + 9))
    assert len({move(mask, s).tobytes() for s in range(2**31, 2**31 + 8)}) > 4


def test_the_3d_start_state_is_small_beside_the_density_and_repeats():
    start = driver("d3q19_job").start_state
    a = start(4, 6, 8, 0.1, 0.01, 2**31 + 3, "cpu")
    b = start(4, 6, 8, 0.1, 0.01, 2**31 + 3, "cpu")
    c = start(4, 6, 8, 0.1, 0.01, 2**31 + 4, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.double().sum(0).sub(0.1).abs().max()) < 0.1 * 0.01 * 1.01
