"""The comparison that decides `correct`: each job's final state and av_vels
series against the reference's, as three numbers.

  state_gap     max |f - f_ref| over every value of the final state, over
                max |f_ref|;
  velocity_gap  max ||u| - |u_ref|| over the cells of the final state, over
                max |u_ref| (the column the original checker reads);
  av_vels_gap   max |av - av_ref| over the steps, over max |av_ref|.

Each number is a ratio of two maxima (`parts`), so the numbers of an answer
held in parts (one a rank) are the ratios (`ratios`) of the parts' maxima
taken over the parts: the same, to the bit, as those of the whole answer.
A number that is not finite, or an answer of the wrong shape, fails any
limit.

The state is compared in blocks of planes (its axis 1: z of a 3-D state,
y of a 2-D one; `state_parts`): each block of the answer and of the
replay is brought to the reference's device and made float64 there, and
the maxima are taken over the blocks. A maximum is exact and |u| is a
function of each cell alone, so the numbers do not depend on the block's
depth; the depth is what the memory free on the reference's device holds
(`block_depth`), so that an answer as large as the program's state on a
card is never on the card whole twice, nor whole in float64.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

NAMES = ("state_gap", "velocity_gap", "av_vels_gap")
# float64 values a state value of a block needs on the reference's device,
# with the temporaries of the difference and of |u|, rounded up
FLOAT64_PER_VALUE = 6
# the share of the free memory that a block may take
FREE_SHARE = 0.5

# the parts of a number whose answer has the wrong shape
MISMATCH = (torch.tensor(math.inf, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64))


def free_bytes(device) -> int:
    """The memory free on `device`: the card's, or the host's available."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def block_depth(shape, device) -> int:
    """The planes of a state of `shape` (q, planes, ...) that one block of
    the comparison takes: as many as FREE_SHARE of the memory free on
    `device` holds, at least one."""
    plane = math.prod(shape) // max(1, shape[1]) * 8 * FLOAT64_PER_VALUE
    return max(1, min(shape[1], int(free_bytes(device) * FREE_SHARE) // max(1, plane)))


def _tensor(a, device) -> torch.Tensor:
    """`a` on `device` in float64 (brought there in its own type)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device).to(torch.float64)


def state_parts(f, ref_f: torch.Tensor, speed, obstacle: torch.Tensor, depth: int | None = None
                ) -> torch.Tensor:
    """(max |x - ref|, max |ref|) of the state and of |u|, a float64 CPU
    tensor of four, from blocks of `depth` planes (default `block_depth`).
    `f` is a numpy array or a tensor on any device; `ref_f` and `obstacle`
    are on the reference's device."""
    if tuple(f.shape) != tuple(ref_f.shape):
        return torch.stack([*MISMATCH, *MISMATCH])
    dev = ref_f.device
    planes = ref_f.shape[1]
    depth = depth or block_depth(ref_f.shape, dev)
    out = None
    for a in range(0, planes, depth):
        b = min(a + depth, planes)
        x, r = _tensor(f[:, a:b], dev), ref_f[:, a:b].double()
        ux, ur = speed(x, obstacle[a:b]), speed(r, obstacle[a:b])
        block = torch.stack([(x - r).abs().max(), r.abs().max(),
                             (ux - ur).abs().max(), ur.abs().max()]).cpu()
        del x, r, ux, ur
        # torch.maximum keeps a maximum that is not a number
        out = block if out is None else torch.maximum(out, block)
    return out


def av_parts(av, ref_av: torch.Tensor) -> torch.Tensor:
    """(max |av - ref|, max |ref|) of the av_vels series, float64 CPU."""
    x, r = _tensor(av, ref_av.device), ref_av.double()
    pair = MISMATCH if x.shape != r.shape else ((x - r).abs().max(), r.abs().max())
    return torch.stack([t.cpu() for t in pair])


def finish(p: torch.Tensor) -> torch.Tensor:
    """The parts of three numbers with max |x - ref| made inf where a
    number's pair is not finite."""
    p = p.clone().view(3, 2)
    p[~torch.isfinite(p).all(dim=1), 0] = math.inf
    return p.flatten()


def parts(f, av, ref_f: torch.Tensor, ref_av: torch.Tensor, speed, obstacle: torch.Tensor,
          depth: int | None = None) -> torch.Tensor:
    """The parts of one job's three numbers: a float64 CPU tensor of
    (max |x - ref|, max |ref|) for the state, |u| and av_vels, in turn, with
    max |x - ref| inf where a part is not finite. `ref_f`, `ref_av` and
    `obstacle` are on the reference's device; `speed(f, obstacle)` is the
    lattice's |u| of each cell; the state is compared in blocks of `depth`
    planes (`state_parts`)."""
    return finish(torch.cat([state_parts(f, ref_f, speed, obstacle, depth),
                             av_parts(av, ref_av)]))


def ratios(p: torch.Tensor) -> dict:
    """The three numbers of `parts` (or of their maxima over the parts of
    an answer), inf where a ratio is not finite."""
    gaps = p[0::2] / p[1::2]
    return {n: (float(g) if math.isfinite(g) else math.inf) for n, g in zip(NAMES, gaps)}


def gaps(f, av, ref_f: torch.Tensor, ref_av: torch.Tensor, speed, obstacle: torch.Tensor) -> dict:
    """The three numbers of one job's (final state, av_vels) against the
    reference's (on the reference's device)."""
    return ratios(parts(f, av, ref_f, ref_av, speed, obstacle))
