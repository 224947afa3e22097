"""The wave path of the one-step D3Q19 kernels B4 and B6 (csrc/d3q19_kstep.cu
`wave_kernel`), modelled in Python and held to what the kernel relies on.
No card is needed: this is the plan, not the kernel.

`d3q19_kstep.WavePlan` mirrors the kernel's plan: the work items (stage,
position, chunk of step-path blocks), the order of their tickets, the
(stage, plane) counters each waits on, and the step each stage takes (B4:
the AA pattern's A and B in turn in place, and the swap after an odd K; B6:
A and B from in into out, after a two-stream step first for an odd K; B4's
rounded pass of a bfloat16 lattice, K > 1: a two-stream step from the
lattice into a scratch lattice, A and B there, and last a two-stream step
or a step B back into the lattice).
Held here, on grids of 3, 4, 5 and 7 planes (rows and columns that no block
divides) at K = 1..4, lags 2 and 3 and chunks of one and two blocks:
  * every item waits only on items of smaller tickets, so a launch cannot
    deadlock whatever blocks are resident;
  * the items run through a numpy emulator of the kernel's slot accesses
    (the pull from in or out, the swapped and natural stores, the swap), in
    ticket order and in seeded interleavings of a few blocks that respect
    the waits (an item loads all its values, then stores them, while other
    items run between the two), give `stepk_plain`'s state bit for bit and
    its Sum|u| within 1e-12 (float64): B4 in place, B6 into out, B6 into its
    own input at an even K, B4's rounded pass through its scratch (here
    float64, so the emulated pass rounds nowhere), and B6's diagnostic modes;
  * the lag rule (`wave_lag`), the path rule (`choose_path`) and the refusal
    of a forced path that cannot run.
"""

import itertools

import numpy as np
import pytest
import torch

from lbm_tpu_torch.ops import d3q19, d3q19_kstep
from lbm_tpu_torch.ops.d3q19_kstep import WavePlan
from lbm_tpu_torch.ops.d3q19_lattice import E, OPPOSITE, initial_distributions

KW = dict(omega=1.85, density=0.1, accel=0.005)
# (nz, ny, nx): 3, 4, 5 and 7 planes; a block of (32, 1, 1) threads is one
# row, wider than the grid (edge blocks), so a plane is ny step-path blocks
SHAPES = ((3, 3, 8), (4, 5, 12), (5, 3, 8), (7, 4, 8))
BLOCK = (32, 1, 1)
PLANS = ((1, 2), (2, 3))  # (chunk, lag)
# the blocks of a float32 wave launch on an H100: 3 resident an SM, 132 SMs
H100_BLOCKS = 3 * 132


def make_case(shape, seed=0):
    rng = np.random.default_rng(seed)
    f = initial_distributions(*shape, 0.1, np.float64)
    f = f * (1.0 + 0.2 * rng.uniform(-1.0, 1.0, f.shape))
    mask = rng.uniform(size=shape) < 0.1
    mask[0] = True
    return f, mask


def window_of(shape):
    nz, ny, _ = shape
    return dict(plane_offset=2, valid_planes=(1, nz), valid_rows=(1, ny), global_nz=nz + 4,
                accel_plane=3)


def block_cells(shape, block, b):
    """(ys, xs) of step-path block b of a plane, cut to the grid."""
    _, ny, nx = shape
    bx, by, _ = block
    gx = -(-nx // bx)
    ys, xs = np.meshgrid((b // gx) * by + np.arange(by), (b % gx) * bx + np.arange(bx),
                         indexing="ij")
    keep = (ys < ny) & (xs < nx)
    return ys[keep], xs[keep]


# the pull's displacement of speed q in each of B6's modes
DISPLACEMENT = {"full": (1, 1, 1), "stream_only": (1, 1, 1), "collide_no_roll": (1, 0, 0),
                "copy": (0, 0, 0)}


class Emulator:
    """The slot accesses of wave_kernel on numpy arrays, one item at a time:
    `load(t)` reads what ticket t's item reads and steps, `store(t)` writes
    what it writes and records its partial Sum|u|s. B4 steps `f` in place;
    B6 reads its first stage from `f` and writes `out` (f itself when
    `alias`); a rounded plan reads its first stage from `f`, steps in `mid`
    and writes its last stage to `f`."""

    def __init__(self, plan, shape, block, chunk, f, mask, *, alias, window, mode="full"):
        self.plan, self.shape, self.block, self.chunk = plan, shape, block, chunk
        self.mask, self.window, self.mode = mask, window, mode
        nz, ny, nx = shape
        self.per_plane = -(-nx // block[0]) * -(-ny // block[1])
        self.f = f.copy()
        self.out = self.f if alias or plan.inplace else np.full_like(f, np.nan)
        self.mid = np.full_like(f, np.nan) if plan.rounded else self.out
        self.partials = np.zeros((plan.k, nz * self.per_plane))
        self.pending = {}

    def blocks_of(self, c):
        return range(c * self.chunk, min((c + 1) * self.chunk, self.per_plane))

    def step(self, vals, z, ys, xs):
        """The cell's step in the emulator's mode: (values out, |u|)."""
        w = self.window
        if self.mode in ("stream_only", "copy"):
            u = vals[0].copy() if self.mode == "stream_only" else np.zeros_like(vals[0])
            out = np.stack(vals)
        else:
            amask = float((z + w["plane_offset"]) % w["global_nz"] == w["accel_plane"])
            obstacle = torch.from_numpy(self.mask[z, ys, xs])
            o, ut = d3q19.collide_fields([torch.from_numpy(v) for v in vals], obstacle,
                                         torch.full(ys.shape, amask, dtype=torch.float64), **KW)
            out, u = o.numpy(), ut.numpy().copy()
        counted = (w["valid_planes"][0] <= z < w["valid_planes"][1])
        u[~(counted & (ys >= w["valid_rows"][0]) & (ys < w["valid_rows"][1]))] = 0.0
        return out, u

    def load(self, t):
        plan = self.plan
        s, i, c = plan.item(t)
        kind = plan.kind(s)
        nz, ny, nx = self.shape
        z = plan.plane(s, i)
        src = self.f if s == 0 else self.mid
        dst = self.out if s == plan.stages - 1 else self.mid
        pz, py, px = DISPLACEMENT[self.mode]
        stores, sums = [], []
        for b in self.blocks_of(c):
            ys, xs = block_cells(self.shape, self.block, b)
            if kind == "swap":
                for q in range(19):
                    qb = int(OPPOSITE[q])
                    if q >= qb:
                        continue
                    dz, dy, dx = (int(v) for v in E[q])
                    a = (q, z, ys, xs)
                    bb = (qb, (z + dz) % nz, (ys + dy) % ny, (xs + dx) % nx)
                    stores += [(dst, a, dst[bb].copy()), (dst, bb, dst[a].copy())]
                continue
            vals, addrs = [], []
            for q in range(19):
                if kind == "B":  # the swapped own slot
                    vals.append(src[int(OPPOSITE[q]), z, ys, xs].copy())
                    continue
                dz, dy, dx = (int(v) for v in E[q])
                addr = (q, (z - pz * dz) % nz, (ys - py * dy) % ny, (xs - px * dx) % nx)
                vals.append(src[addr].copy())
                addrs.append(addr)
            o, u = self.step(vals, z, ys, xs)
            for q in range(19):
                if kind == "A":  # to the pulled slots, swapped
                    stores.append((dst, addrs[q], o[int(OPPOSITE[q])]))
                else:
                    stores.append((dst, (q, z, ys, xs), o[q]))
            sums.append((z * self.per_plane + b, u.sum()))
        self.pending[t] = (s, stores, sums)

    def store(self, t):
        s, stores, sums = self.pending.pop(t)
        for arr, idx, v in stores:
            arr[idx] = v
        for bid, u in sums:
            self.partials[s, bid] = u

    def result(self):
        return self.out, self.partials.sum(axis=1)


def execute(plan, emu, blocks=1, seed=None):
    """Run every item: in ticket order (seed None), or with `blocks` blocks
    that take tickets in order and, at each turn, one seeded choice among
    taking a ticket, loading an item whose waits are met, and storing a
    loaded one. Returns the tickets in the order their items completed."""
    rng = None if seed is None else np.random.default_rng(seed)
    done = {}
    held = [None] * blocks  # (ticket, loaded)
    nxt, completed = 0, []
    while len(completed) < plan.items:
        moves = []
        for b, h in enumerate(held):
            if h is None:
                if nxt < plan.items:
                    moves.append(("take", b))
            elif not h[1]:
                s, i, _ = plan.item(h[0])
                if all(done.get(w, 0) >= plan.chunks for w in plan.waits(s, i)):
                    moves.append(("load", b))
            else:
                moves.append(("store", b))
        assert moves, f"deadlock after {len(completed)} of {plan.items} items"
        if rng is None:
            order = {"store": 0, "load": 1, "take": 2}
            move, b = min(moves, key=lambda m: order[m[0]])
        else:
            move, b = moves[rng.integers(len(moves))]
        if move == "take":
            held[b] = (nxt, False)
            nxt += 1
        elif move == "load":
            emu.load(held[b][0])
            held[b] = (held[b][0], True)
        else:
            t = held[b][0]
            emu.store(t)
            s, i, _ = plan.item(t)
            key = (s, plan.plane(s, i))
            done[key] = done.get(key, 0) + 1
            completed.append(t)
            held[b] = None
    return completed


# the plans of each kernel: (inplace, rounded)
KERNELS = {"b4": (True, False), "b6": (False, False), "b4-rounded": (True, True)}


def plans(kernel):
    inplace, rounded = KERNELS[kernel]
    for shape, k, (chunk, lag) in itertools.product(SHAPES, (1, 2, 3, 4), PLANS):
        if rounded and k == 1:
            continue  # a rounded pass of one step runs in the lattice itself
        yield shape, k, chunk, lag, WavePlan.of(*shape, k, inplace=inplace, block=BLOCK,
                                                chunk=chunk, lag=lag, blocks=H100_BLOCKS,
                                                rounded=rounded)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_items_wait_only_on_smaller_tickets(kernel):
    inplace, rounded = KERNELS[kernel]
    for shape, k, chunk, lag, plan in plans(kernel):
        tickets = {plan.item(t): t for t in range(plan.items)}
        assert len(tickets) == plan.items  # every (stage, position, chunk) once
        assert plan.stages == (k + k % 2 if inplace and not rounded else k)
        for (s, i, c), t in tickets.items():
            for ws, wz in plan.waits(s, i):
                wi = plan.position(ws, wz)
                assert all(tickets[(ws, wi, cc)] < t for cc in range(plan.chunks)), (
                    shape, k, chunk, lag, (s, i, c), (ws, wz))


@pytest.mark.parametrize("k, b4, b6, rounded", [
    (1, "A swap", "two-stream", None), (2, "A B", "A B", "two-stream two-stream"),
    (3, "A B A swap", "two-stream A B", "two-stream A B"),
    (4, "A B A B", "A B A B", "two-stream A B two-stream")])
def test_the_steps_of_the_stages(k, b4, b6, rounded):
    """Every pass ends in the natural layout: A and B in pairs, after a swap
    of an odd A (B4) or a two-stream step (B6). B4's rounded pass (a
    bfloat16 lattice) has no swap: it enters its scratch by a two-stream
    step and leaves it by one after an even K, by a step B after an odd K;
    of one step it has no plan."""
    for inplace, want in ((True, b4), (False, b6)):
        plan = WavePlan.of(8, 4, 32, k, inplace=inplace, block=BLOCK, blocks=H100_BLOCKS)
        assert " ".join(plan.kind(s) for s in range(plan.stages)) == want
    if rounded is None:
        with pytest.raises(ValueError, match="rounded pass of one step"):
            WavePlan.of(8, 4, 32, k, inplace=True, block=BLOCK, blocks=H100_BLOCKS, rounded=True)
        return
    plan = WavePlan.of(8, 4, 32, k, inplace=True, block=BLOCK, blocks=H100_BLOCKS, rounded=True)
    assert " ".join(plan.kind(s) for s in range(plan.stages)) == rounded
    assert plan.stages == k and not plan.swap and plan.two_stream


def run_emulated(kernel, shape, k, mode="full"):
    """Every plan and schedule of `kernel` ("b4", "b6", "b6-aliased" or
    "b4-rounded") at K against `stepk_plain` in `mode`."""
    inplace, alias = kernel.startswith("b4"), kernel == "b6-aliased"
    rounded = kernel == "b4-rounded"
    f, mask = make_case(shape)
    window = window_of(shape)
    ref_f, ref_t = d3q19_kstep.stepk_plain(torch.from_numpy(f), torch.from_numpy(mask),
                                           k_steps=k, mode=mode, **KW, **window)
    for chunk, lag in PLANS:
        plan = WavePlan.of(*shape, k, inplace=inplace, block=BLOCK, chunk=chunk, lag=lag,
                           blocks=H100_BLOCKS, rounded=rounded)
        for blocks, seed in ((1, None), (3, 0), (5, 1), (8, 2)):
            emu = Emulator(plan, shape, BLOCK, chunk, f, mask, alias=alias, window=window,
                           mode=mode)
            completed = execute(plan, emu, blocks, seed)
            got_f, got_t = emu.result()
            assert sorted(completed) == list(range(plan.items))
            what = (kernel, mode, shape, k, chunk, lag, blocks, seed)
            np.testing.assert_array_equal(got_f, ref_f.numpy(), err_msg=str(what))
            np.testing.assert_allclose(got_t, ref_t.numpy(), rtol=1e-12, atol=0, err_msg=str(what))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kernel", ["b4", "b6", "b6-aliased", "b4-rounded"])
def test_emulated_schedule_equals_stepk_plain(kernel, shape):
    for k in (1, 2, 3, 4):
        if kernel == "b6-aliased" and k % 2:
            continue  # the first stage reads in after others wrote out: out needs its own
        if kernel == "b4-rounded" and k == 1:
            continue  # one step runs in the lattice itself, on the step path
        run_emulated(kernel, shape, k)


@pytest.mark.parametrize("mode", ["stream_only", "copy", "collide_no_roll"])
def test_emulated_modes_equal_stepk_plain(mode):
    """B6's diagnostic modes take the same stages with the pull along e_q,
    along z only or not at all."""
    for k in (1, 2, 3, 4):
        run_emulated("b6", (5, 3, 8), k, mode)


def test_the_plan_of_the_bench_grids():
    """64x128x256 at the default block (one 256-wide row a step-path block):
    128 blocks a plane; the plan's items and its lag for an H100's blocks."""
    plan = WavePlan.of(64, 128, 256, 2, inplace=False, chunk=2, lag=3, blocks=H100_BLOCKS)
    assert (plan.chunks, plan.stages, plan.items) == (64, 2, 8192)
    # the lag from an H100's 396 blocks: lag - 2 rounds of 2 x 64 items hold them
    plan = WavePlan.of(64, 128, 256, 2, inplace=True, blocks=H100_BLOCKS)
    assert (plan.blocks, plan.lag) == (396, 2 + 4)
    # 4 x 128 items a round
    assert WavePlan.of(32, 256, 256, 4, inplace=False, blocks=H100_BLOCKS).lag == 2 + 1
    # a launch of more blocks than items takes as many as there are items
    # (1 stage x 3 planes x 1 chunk)
    assert WavePlan.of(3, 2, 256, 1, inplace=False, blocks=H100_BLOCKS).blocks == 3
    plan = WavePlan.of(64, 128, 256, 3, inplace=True, chunk=1, lag=3, blocks=H100_BLOCKS)
    assert (plan.stages, plan.items) == (4, 4 * 64 * 128)
    # a round holds every stage whose position lies in [0, nz), in order
    assert [plan.item(t)[:2] for t in range(0, 3 * 128 + 1, 128)] == [(0, 0), (0, 1), (0, 2),
                                                                      (0, 3)]
    # round 3 (= lag) holds stage 0 at position 3, then stage 1 at position 0
    assert plan.item(4 * 128) == (1, 0, 0)
    with pytest.raises(ValueError, match="lag must be >= 2"):
        WavePlan.of(64, 128, 256, 2, inplace=False, lag=1, blocks=H100_BLOCKS)


@pytest.mark.parametrize("nz, block, fits", [(64, (256, 1, 1), True), (3, (32, 8, 1), True),
                                             (2, (256, 1, 1), False), (8, (64, 2, 2), False)])
def test_wave_fits_and_choose_path(nz, block, fits):
    assert d3q19_kstep.wave_fits(nz, block) is fits
    for kernel, k, dtype in itertools.product(("b4", "b6"), (1, 2, 3, 4),
                                              (torch.float32, torch.float64)):
        path = d3q19_kstep.choose_path(nz, 16, 256, k, dtype, kernel=kernel, block=block)
        ms = d3q19_kstep.PATH_MS[dtype][kernel]
        want = "wave" if fits and ms["wave"][k - 1] <= ms["step"][k - 1] else "step"
        assert path == want
        # the modes run on the wave path wherever it takes the shape
        assert d3q19_kstep.choose_path(nz, 16, 256, k, dtype, kernel=kernel, block=block,
                                       mode="copy") == ("wave" if fits else "step")
    if not fits:
        with pytest.raises(ValueError, match="does not take block"):
            WavePlan.of(nz, 16, 256, 2, inplace=True, block=block, blocks=H100_BLOCKS)


def test_a_forced_path_that_cannot_run_raises():
    f = torch.empty((19, 2, 8, 256), device="meta")
    with pytest.raises(ValueError, match="wave path does not take"):
        d3q19_kstep.resolve_path("wave", f, 2)
    g = torch.empty((19, 8, 8, 256), device="meta")
    with pytest.raises(ValueError, match="runs on the wave path only"):
        d3q19_kstep.resolve_path("step", g, 2, mode="stream_only")
    with pytest.raises(ValueError, match="path must be one of"):
        d3q19_kstep.resolve_path("box", g, 2)
    assert d3q19_kstep.resolve_path("step", g, 2) == "step"
    assert d3q19_kstep.resolve_path("wave", g, 2, kernel="b4") == "wave"
    assert d3q19_kstep.resolve_path(None, f, 2) == "step"  # two planes: the step path


@pytest.mark.parametrize("blocks, stages, chunks, lag", [(396, 2, 64, 6), (396, 2, 128, 4),
                                                         (396, 4, 64, 4), (396, 4, 128, 3),
                                                         (264, 2, 64, 5), (7, 2, 64, 3)])
def test_wave_lag(blocks, stages, chunks, lag):
    """lag - 2 rounds of stages x chunks items hold the launch's blocks."""
    assert d3q19_kstep.wave_lag(blocks, stages, chunks) == lag
    assert (lag - 2) * stages * chunks >= blocks > (lag - 3) * stages * chunks
