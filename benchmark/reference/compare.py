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
"""

from __future__ import annotations

import math

import numpy as np
import torch

NAMES = ("state_gap", "velocity_gap", "av_vels_gap")


# the parts of a number whose answer has the wrong shape
MISMATCH = (torch.tensor(math.inf, dtype=torch.float64), torch.tensor(1.0, dtype=torch.float64))


def _part(x: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max |x - ref|, max |ref|), float64."""
    if x.shape != ref.shape:
        return MISMATCH
    return (x - ref).abs().max(), ref.abs().max()


def _tensor(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=torch.float64)


def parts(f, av, ref_f: torch.Tensor, ref_av: torch.Tensor, speed, obstacle: torch.Tensor
          ) -> torch.Tensor:
    """The parts of one job's three numbers: a float64 CPU tensor of
    (max |x - ref|, max |ref|) for the state, |u| and av_vels, in turn, with
    max |x - ref| inf where a part is not finite. `ref_f`, `ref_av` and
    `obstacle` are on the reference's device; `speed(f, obstacle)` is the
    lattice's |u| of each cell."""
    dev = ref_f.device
    fp = _tensor(f, dev)
    fr = ref_f.double()
    pairs = [_part(fp, fr),
             _part(speed(fp, obstacle), speed(fr, obstacle)) if fp.shape == fr.shape
             else MISMATCH,
             _part(_tensor(av, dev), ref_av.double())]
    out = torch.stack([torch.stack([a.cpu(), b.cpu()]) for a, b in pairs])
    out[~torch.isfinite(out).all(dim=1), 0] = math.inf
    return out.flatten()


def ratios(p: torch.Tensor) -> dict:
    """The three numbers of `parts` (or of their maxima over the parts of
    an answer), inf where a ratio is not finite."""
    gaps = p[0::2] / p[1::2]
    return {n: (float(g) if math.isfinite(g) else math.inf) for n, g in zip(NAMES, gaps)}


def gaps(f, av, ref_f: torch.Tensor, ref_av: torch.Tensor, speed, obstacle: torch.Tensor) -> dict:
    """The three numbers of one job's (final state, av_vels) against the
    reference's (on the reference's device)."""
    return ratios(parts(f, av, ref_f, ref_av, speed, obstacle))
