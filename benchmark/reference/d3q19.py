"""Plain PyTorch D3Q19 BGK: the reference of the 3-D cells.

A channel between wall planes (bounce-back on the obstacle cells), periodic
elsewhere, driven by a body force on the plane z = nz-2: each step a
periodic pull stream, bounce-back, the BGK collision and the force, and
Sum|u| over the free cells; av_vels is Sum|u| over the number of free cells.
The collision takes the paired grouping of the JAX package's D3Q19 step,
which the serial C++ oracle and the committed float64 traces carry: each
pair of opposite speeds shares e.u, the quadratic term and the weight's
omega * rho product.

State (19, nz, ny, nx), axes (z, y, x); speed k moves by E[k] = (dz, dy,
dx). Weights 1/3 (rest), 1/18 (axes), 1/36 (edges).

FLOP per cell update of `step`, counted line by line in its code (one for
each add, subtract, negation, multiply, divide and square root; the Sum|u| reduction
as one add a cell):

    rho                         18 adds                         18
    u_x, u_y, u_z               9 adds or subtracts, 1 divide   30
    u_sq                        3 multiplies, 2 adds            5
    c_sq                        1 multiply, 1 subtract          2
    (w omega) rho               1 multiply a weight class       3
    out0                        2 multiplies, 1 add             3
    3 axis pairs                e.u none; 12 each               36
    6 edge pairs                e.u 1 (3 of them 2: a negation  81
                                and an add); 12 each
      (quad 3, lin 1, out_k 4, out_kb 4)
    |u|, Sum|u|                 1 square root, 1 add            2
                                                                ---
                                                                180

plus PLANE_FLOP on each cell of the accelerated plane (the force on the
five pairs that move along x), which the roofline leaves out.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lattice

E = ((0, 0, 0),
     (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0), (1, 0, 0), (-1, 0, 0),
     (0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1),
     (1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1),
     (1, 1, 0), (1, -1, 0), (-1, 1, 0), (-1, -1, 0))
W = (1 / 3,) + (1 / 18,) * 6 + (1 / 36,) * 12
OPPOSITE = tuple(E.index(tuple(-c for c in e)) for e in E)
FLOP_PER_UPDATE = 180
PLANE_FLOP = 10


def _signed_sum(terms):
    """+-t0 +- t1 +- ... in order, from (sign, tensor) pairs."""
    acc = terms[0][1] if terms[0][0] > 0 else -terms[0][1]
    for sign, t in terms[1:]:
        acc = acc + t if sign > 0 else acc - t
    return acc


def make_collide(*, omega: float, density: float, accel: float, dtype: torch.dtype, device):
    """The collision of `dtype` states on `device`: a function of (the 19
    streamed speeds s, each (planes, ny, nx); the obstacle cells of those
    planes; the index among them of the accelerated plane, or None; g, a
    (19, planes, ny, nx) tensor) that writes the next state into g and
    returns Sum|u| over the planes' free cells."""
    def c(x):
        return torch.tensor(x, dtype=dtype, device=device)

    omm, one, k15, k45, k3 = c(1.0 - omega), c(1.0), c(1.5), c(4.5), c(3.0)
    wo = {w: c(w * omega) for w in (W[0], W[1], W[7])}
    force = {k: c(E[k][2] * (density * accel * W[k])) for k in range(19) if E[k][2]}
    zero = c(0.0)
    pairs = [k for k in range(1, 19) if OPPOSITE[k] > k]
    axis = {a: [(E[k][a], k) for k in range(19) if E[k][a]] for a in range(3)}

    def collide(s, obstacle, plane, g):
        rho = s[0]
        for k in range(1, 19):
            rho = rho + s[k]
        u = [_signed_sum([(sg, s[k]) for sg, k in axis[a]]) / rho for a in range(3)]
        u_z, u_y, u_x = u
        u_sq = u_x * u_x + u_y * u_y + u_z * u_z
        c_sq = one - u_sq * k15
        wro = {w: wo[w] * rho for w in wo}
        out = [None] * 19
        out[0] = s[0] * omm + wro[W[0]] * c_sq
        for k in pairs:
            kb = OPPOSITE[k]
            comps = [(E[k][2], u_x), (E[k][1], u_y), (E[k][0], u_z)]
            eu = _signed_sum([(sg, t) for sg, t in comps if sg])
            quad = (k45 * eu) * eu + c_sq
            lin = k3 * eu
            w = wro[W[k]]
            out[k] = s[k] * omm + w * (quad + lin)
            out[kb] = s[kb] * omm + w * (quad - lin)
            if k in force and plane is not None:
                out[k][plane] = out[k][plane] + force[k]
                out[kb][plane] = out[kb][plane] - force[k]
        for k in range(19):
            torch.where(obstacle, s[OPPOSITE[k]], out[k], out=g[k])
        speed = torch.where(obstacle, zero, torch.sqrt(u_sq))
        return speed.sum()

    return collide


def make_step(obstacle: torch.Tensor, *, omega: float, density: float, accel: float,
              plane: int, dtype: torch.dtype):
    """The step of `dtype` states on the grid of `obstacle` (bool): a
    function of a (19, nz, ny, nx) state to (the next state, Sum|u|)."""
    collide = make_collide(omega=omega, density=density, accel=accel, dtype=dtype,
                           device=obstacle.device)

    def step(f):
        s = [f[k] if not any(E[k]) else
             torch.roll(f[k], tuple(d for d in E[k] if d),
                        dims=tuple(a for a in range(3) if E[k][a]))
             for k in range(19)]
        g = torch.empty_like(f)
        return g, collide(s, obstacle, plane, g)

    return step


def solve(f0: torch.Tensor, mask: np.ndarray, *, steps: int, omega: float, density: float,
          accel: float, storage: torch.dtype, store_every: int, device):
    """A whole job from its host inputs: the start state `f0` (a host
    tensor, rounded to `storage`) and the obstacle mask, `steps` steps with
    the force on plane nz-2. Returns (the final state as `storage`, av_vels
    as float64), on `device`."""
    obstacle = torch.as_tensor(np.ascontiguousarray(mask, dtype=np.bool_), device=device)
    f = f0.to(device=device).to(storage)
    nz = f.shape[1]
    step = make_step(obstacle, omega=omega, density=density, accel=accel, plane=nz - 2,
                     dtype=lattice.compute_dtype(storage))
    f, tots = lattice.run(step, f, steps=steps, storage=storage, store_every=store_every)
    free = int((~obstacle).sum())
    return f, tots.double() / free


def speed(f: torch.Tensor, obstacle: torch.Tensor) -> torch.Tensor:
    """|u| of each cell of a state, in float64, 0 on obstacle cells: sums
    over the speeds in their order, cell by cell, so a cell's |u| does not
    depend on the cells around it (`compare` takes blocks of planes)."""
    f = f.double()
    rho = f[0]
    for k in range(1, 19):
        rho = rho + f[k]
    comps = [_signed_sum([(E[k][a], f[k]) for k in range(19) if E[k][a]]) / rho
             for a in range(3)]
    return torch.where(obstacle, 0.0, torch.sqrt(sum(u * u for u in comps)))


# cells of one block of `solve_slab`: on an H100, blocks of 2 and 4 planes of
# 1024x1024 step 0.96 and 0.97 G cells/s, 1 plane 0.79 (the kernels grow
# short beside their launches), 16 planes 0.90 (temporaries outgrow the L2)
BLOCK_CELLS = 1 << 21


def _exchange(f: torch.Tensor, ghosts: torch.Tensor):
    """ghosts[0] := the plane below the slab f, ghosts[1] := the plane above
    it, as they stand before the step: from the z-neighbour ranks of the
    default process group (rank r holds the r-th slab in z; periodic over
    the ranks), or from f itself on one rank."""
    import torch.distributed as dist

    if not (dist.is_initialized() and dist.get_world_size() > 1):
        ghosts[0].copy_(f[:, -1])
        ghosts[1].copy_(f[:, 0])
        return
    rank, size = dist.get_rank(), dist.get_world_size()
    up, down = (rank + 1) % size, (rank - 1) % size
    top, bottom = f[:, -1].contiguous(), f[:, 0].contiguous()
    # a plane that goes up is tagged 1, one that goes down 2; on two ranks
    # both go to one peer, matched in this order
    ops = [dist.P2POp(dist.isend, top, up, tag=1), dist.P2POp(dist.isend, bottom, down, tag=2),
           dist.P2POp(dist.irecv, ghosts[0], down, tag=1),
           dist.P2POp(dist.irecv, ghosts[1], up, tag=2)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def _sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(t)
    return t


def solve_slab(f0: torch.Tensor, obstacle: torch.Tensor, *, nz: int, lo: int, steps: int,
               omega: float, density: float, accel: float, storage: torch.dtype,
               store_every: int, depth: int | None = None):
    """`solve` of one rank's planes [lo, lo + planes) of a grid of `nz`
    planes, from the slab's start state `f0` (19, planes, ny, nx) and its
    obstacle cells, both on the reference's device: the same per-cell
    arithmetic as `make_step`, so the same state to the bit.

    Each step the ghost planes are exchanged with the z-neighbour ranks
    (`_exchange`), then the slab is stepped in place, in blocks of `depth`
    planes (default BLOCK_CELLS a block) in z order: a block and the planes
    on either side are copied into a buffer of depth + 2 planes, the old
    plane below the next block kept in it, the block's next state written
    back over it. The force acts on plane nz-2, wherever it lies, and a
    state stored below the compute type is rounded to `storage` every
    `store_every` steps, as `lattice.run` does. On the card each block's
    step is recorded once as a CUDA graph of its shape and replayed.

    `f0` is overwritten where it is already the compute type. Returns (the
    final slab as `storage`, av_vels as float64): Sum|u| of the slab's free
    cells, summed in float64 over the blocks and then over the ranks, over
    the free cells of every rank; so av_vels is `solve`'s up to the order of
    the float32 sums."""
    if steps % store_every:
        raise ValueError(f"{steps} steps are not a whole number of passes of {store_every}")
    compute = lattice.compute_dtype(storage)
    dev = f0.device
    f = f0.to(compute)
    _, n, ny, nx = f.shape
    depth = min(n, depth or max(1, BLOCK_CELLS // (ny * nx)))
    collide = make_collide(omega=omega, density=density, accel=accel, dtype=compute, device=dev)
    plane = nz - 2 - lo
    ghosts = torch.empty((2, 19, ny, nx), dtype=compute, device=dev)
    ext = torch.empty((19, depth + 2, ny, nx), dtype=compute, device=dev)
    obs = torch.empty((depth, ny, nx), dtype=torch.bool, device=dev)
    out = torch.empty((19, depth, ny, nx), dtype=compute, device=dev)
    graphs = {}

    def block(m, p):
        """Sum|u| of the block in ext[:, 1:m+1] (planes on either side
        around it), its next state into out[:, :m]; p: the accelerated
        plane's index in it, or None."""
        e = ext[:, :m + 2]
        s = [e[k, 1 - dz:1 - dz + m] if not (dy or dx) else
             torch.roll(e[k, 1 - dz:1 - dz + m], tuple(d for d in (dy, dx) if d),
                        dims=tuple(a for a, d in ((1, dy), (2, dx)) if d))
             for k, (dz, dy, dx) in enumerate(E)]
        return collide(s, obs[:m], p, out[:, :m])

    def run_block(m, p):
        # a shape's first block runs eagerly (it warms up), its second is
        # recorded, every later one replayed
        if dev.type != "cuda" or graphs.get((m, p), 0) == 0:
            graphs[(m, p)] = graphs.get((m, p), 0) + 1
            return block(m, p)
        if graphs[(m, p)] == 1:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                tot = block(m, p)
            graphs[(m, p)] = (graph, tot)
        graph, tot = graphs[(m, p)]
        graph.replay()
        return tot

    tots = torch.zeros(steps, dtype=torch.float64, device=dev)
    for i in range(steps):
        _exchange(f, ghosts)
        for a in range(0, n, depth):
            b = min(a + depth, n)
            m = b - a
            ext[:, 0].copy_(ext[:, depth] if a else ghosts[0])
            ext[:, 1:m + 1].copy_(f[:, a:b])
            ext[:, m + 1].copy_(f[:, b] if b < n else ghosts[1])
            obs[:m].copy_(obstacle[a:b])
            tot = run_block(m, plane - a if a <= plane < b else None)
            f[:, a:b].copy_(out[:, :m])
            tots[i] += tot
        if storage != compute and (i + 1) % store_every == 0:
            for a in range(0, n, depth):
                f[:, a:a + depth].copy_(f[:, a:a + depth].to(storage))
    del graphs
    free = _sum_over_ranks((~obstacle).sum().to(torch.float64))
    return f.to(storage), _sum_over_ranks(tots) / free
