"""Judging an answer as large as the program's state on a card, on the CPU:
the comparison in blocks of planes gives the numbers of the whole answer to
the bit; the slab reference on 1, 2 and 4 gloo ranks, its ghost planes
exchanged, steps as `solve` on the whole domain; and a job that declares
`last_state_only` keeps one state, holding the other jobs to it by their
digests."""

from __future__ import annotations

import math
import time
import weakref

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import compare, d2q9, d3q19

from conftest import ranks_cell

SEED = 2**31 + 41
CPU = torch.device("cpu")
NZ, NY, NX = 8, 4, 6
KW = dict(omega=1.85, density=0.1, accel=0.005)


def whole_parts(f, av, ref_f, ref_av, speed, obstacle):
    """compare.parts as it was before blocks: each part of the whole answer,
    made float64 at once."""
    def part(x, ref):
        if x.shape != ref.shape:
            return compare.MISMATCH
        return (x - ref).abs().max(), ref.abs().max()

    def tensor(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return t.to(dtype=torch.float64)

    fp, fr = tensor(f), ref_f.double()
    pairs = [part(fp, fr),
             part(speed(fp, obstacle), speed(fr, obstacle)) if fp.shape == fr.shape
             else compare.MISMATCH,
             part(tensor(av), ref_av.double())]
    out = torch.stack([torch.stack([a, b]) for a, b in pairs])
    out[~torch.isfinite(out).all(dim=1), 0] = math.inf
    return out.flatten()


def _answer(kind, dims):
    gen = torch.Generator().manual_seed(11)
    q, speed = (19, d3q19.speed) if dims == 3 else (9, d2q9.speed)
    shape = (q, NZ, NY, NX) if dims == 3 else (q, NZ, NX)
    ref_f = torch.rand(shape, generator=gen, dtype=torch.float64) + 0.5
    ref_av = torch.rand(10, generator=gen, dtype=torch.float64)
    f = (ref_f + 1e-6 * torch.rand(shape, generator=gen, dtype=torch.float64)).float()
    av = ref_av.numpy() + 1e-9
    obstacle = torch.zeros(shape[1:], dtype=torch.bool)
    obstacle[0] = obstacle[-1] = True
    obstacle[3, 1] = True
    if kind == "altered":
        f[4, 5, 1] *= 2
    elif kind in ("nan", "inf"):
        f[2, 6, 0] = math.nan if kind == "nan" else math.inf
    elif kind == "short":
        f = f[:, 1:]
    elif kind == "av_short":
        av = av[:-1]
    elif kind == "numpy":
        f = f.numpy()
    return f, av, ref_f, ref_av, speed, obstacle


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("kind", ["close", "altered", "nan", "inf", "short", "av_short",
                                  "numpy"])
@pytest.mark.parametrize("depth", [1, 3, NZ, None])
def test_blocked_parts_are_the_whole_parts_to_the_bit(depth, kind, dims):
    """Blocks of 1 and 3 planes (3 does not divide 8), the whole, and the
    depth the free memory gives: equal to the bit to the whole answer's
    parts, for a close answer, one altered, not finite, of the wrong shape,
    and a numpy answer."""
    f, av, ref_f, ref_av, speed, obstacle = _answer(kind, dims)
    blocked = compare.parts(f, av, ref_f, ref_av, speed, obstacle, depth)
    assert torch.equal(blocked, whole_parts(f, av, ref_f, ref_av, speed, obstacle))
    gaps = compare.ratios(blocked)
    if kind in ("nan", "inf", "short"):
        assert gaps["state_gap"] == gaps["velocity_gap"] == math.inf
    if kind == "av_short":
        assert gaps["av_vels_gap"] == math.inf


def test_the_block_depth_follows_the_free_memory(monkeypatch):
    shape = (19, 512, 1024, 1024)
    plane = 19 * 1024 * 1024 * 8 * compare.FLOAT64_PER_VALUE
    monkeypatch.setattr(compare, "free_bytes", lambda device: 10 * plane)
    assert compare.block_depth(shape, CPU) == 5
    monkeypatch.setattr(compare, "free_bytes", lambda device: plane // 3)
    assert compare.block_depth(shape, CPU) == 1
    monkeypatch.setattr(compare, "free_bytes", lambda device: 10**15)
    assert compare.block_depth(shape, CPU) == 512


def _slab_inputs(storage):
    gen = torch.Generator().manual_seed(5)
    w = torch.tensor(d3q19.W, dtype=torch.float64)[:, None, None, None]
    r = torch.rand((19, NZ, NY, NX), generator=gen, dtype=torch.float64)
    f0 = (0.1 * w * (1 + 0.01 * (2 * r - 1))).to(storage)
    mask = np.zeros((NZ, NY, NX), bool)
    mask[0] = mask[-1] = True
    mask[2:5, 1:3, 2:5] = True  # across the slabs of 2 and 4 ranks
    return f0, mask


def _slab_rank(rank, size, init, storage, depth, out):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=size)
    try:
        f0, mask = _slab_inputs(storage)
        lo, hi = NZ * rank // size, NZ * (rank + 1) // size
        f, av = d3q19.solve_slab(f0[:, lo:hi].clone(), torch.from_numpy(mask[lo:hi]), nz=NZ,
                                 lo=lo, steps=16, storage=storage, store_every=4, depth=depth,
                                 **KW)
        torch.save({"f": f, "av": av}, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size,depth", [(1, 3), (2, 1), (4, 1)])
def test_the_slab_reference_on_ranks_steps_as_solve_on_the_whole_domain(tmp_path, size, depth,
                                                                         storage):
    """Slabs of 8, 4 and 2 planes in blocks of 3, 1 and 1, the wall z = 0 on
    rank 0, the forced plane z = 6 and the wall z = 7 on the last rank, an
    obstacle block across slabs; bfloat16 storage rounded every 4 steps.
    The slabs put together are `solve`'s state to the bit; av_vels agrees
    within 1e-6 of itself: the float32 sums of Sum|u| over 192 cells are
    taken in another order (a block's sum, then the blocks' and the ranks'
    in float64), some 1e-7 of the total."""
    ctx = torch.multiprocessing.start_processes(
        _slab_rank, args=(size, tmp_path / "init", storage, depth, tmp_path), nprocs=size,
        join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    parts = [torch.load(tmp_path / f"rank{r}.pt") for r in range(size)]
    f0, mask = _slab_inputs(storage)
    f, av = d3q19.solve(f0, mask, steps=16, storage=storage, store_every=4, device="cpu", **KW)
    assert torch.equal(torch.cat([p["f"] for p in parts], dim=1), f)
    for p in parts:
        assert float(((p["av"] - av).abs() / av.abs()).max()) <= 1e-6


class Count:
    """Stands in for the ranks' Group in `harness.window`: exactly `n` jobs."""

    def __init__(self, n):
        self.left = n

    def decide(self, go):
        self.left -= 1
        return self.left >= 0

    def barrier(self):
        pass


class Watched:
    """A job that records, as each of its jobs starts, how many states of
    its earlier jobs are still held."""

    def __init__(self, job):
        self.job, self.refs, self.held = job, [], []

    def __getattr__(self, name):
        return getattr(self.job, name)

    def run(self):
        self.held.append(sum(r() is not None for r in self.refs))
        f, av = self.job.run()
        self.refs.append(weakref.ref(f))
        return f, av


def _last_state_job(root, **config):
    cell = ranks_cell(root, "last1", 1, engine="cuda-inplace", last_state_only=True, **config)
    c = harness.cell(harness.load_spec(root), cell, root)
    job = harness.driver(c.bench, c.config["driver"]).Job(c.config, c.config_dir, c.traffic,
                                                          SEED, CPU)
    return Watched(job), c.limits


@pytest.mark.parametrize("altered", [None, 0, 1, 2])
def test_a_last_state_only_window_keeps_one_state_and_digests_the_others(root, altered):
    """Three jobs: one state is held at a time and the last one kept; an
    unaltered run passes; a value altered in an earlier job fails that job
    alone (its digest differs); one altered in the last job fails every job
    (the kept state in full, the others by their digests)."""
    fault = {} if altered is None else {"fault": {"kind": "alter", "rank": 0, "job": altered}}
    job, limits = _last_state_job(root, **fault)
    assert job.last_state_only
    outputs, digests, spans, _ = harness.window(job, 1e9, CPU, False, Count(3))
    assert len(spans) == len(digests) == len(outputs) == 3
    assert job.held == [0, 0, 0]
    assert [f is None for f, _ in outputs] == [True, True, False]
    rows = harness.judge(job, outputs, digests=digests)
    failed = [any(not row[n] <= limits[n] for n in limits) for row in rows]
    expect = {None: [False] * 3, 0: [True, False, False], 1: [False, True, False],
              2: [True] * 3}[altered]
    assert failed == expect, rows
    for row, bad in zip(rows, failed):
        assert row["av_vels_gap"] <= limits["av_vels_gap"]
        assert (row["state_gap"] > limits["state_gap"]) == bad


def test_a_last_state_only_cell_runs_correct_through_the_harness(root):
    cell = ranks_cell(root, "last1", 1, engine="cuda-inplace", last_state_only=True)
    result = harness.run(root, cell, SEED, 0.3, False, CPU, time.perf_counter())
    assert result["correct"] and result["attempted"] >= 1, result["checks"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_digest_is_of_the_bits_and_not_of_the_chunks(monkeypatch, dtype):
    gen = torch.Generator().manual_seed(2)
    f = torch.rand((19, 5, 3, 7), generator=gen).to(dtype)
    d = harness.digest(f)
    assert d == harness.digest(f.clone())
    monkeypatch.setattr(harness, "DIGEST_VALUES", 5)
    assert harness.digest(f) == d
    altered = f.clone()
    altered[3, 1, 2, 4] *= 2
    assert harness.digest(altered)[0] != d[0]
    swapped = f.clone()
    swapped[0, 0, 0, 0], swapped[18, 4, 2, 6] = f[18, 4, 2, 6], f[0, 0, 0, 0]
    assert f[0, 0, 0, 0] != f[18, 4, 2, 6]
    assert harness.digest(swapped)[0] == d[0] and harness.digest(swapped)[1] != d[1]
