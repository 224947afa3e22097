"""The comparison that decides `correct`: each job's final state and av_vels
series against the reference's, as three numbers.

  state_gap     max |f - f_ref| over every value of the final state, over
                max |f_ref|;
  velocity_gap  max ||u| - |u_ref|| over the cells of the final state, over
                max |u_ref| (the column the original checker reads);
  av_vels_gap   max |av - av_ref| over the steps, over max |av_ref|.

A number that is not finite, or an answer of the wrong shape, fails any
limit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

def _gap(x: torch.Tensor, ref: torch.Tensor) -> float:
    if x.shape != ref.shape:
        return math.inf
    return float((x - ref).abs().max() / ref.abs().max())


def _tensor(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=torch.float64)


def gaps(f, av, ref_f: torch.Tensor, ref_av: torch.Tensor, speed, obstacle: torch.Tensor) -> dict:
    """The three numbers of one job's (final state, av_vels) against the
    reference's (on the reference's device); `speed(f, obstacle)` is the
    lattice's |u| of each cell."""
    dev = ref_f.device
    fp = _tensor(f, dev)
    fr = ref_f.double()
    same = fp.shape == fr.shape
    out = {"state_gap": _gap(fp, fr),
           "velocity_gap": _gap(speed(fp, obstacle), speed(fr, obstacle)) if same else math.inf,
           "av_vels_gap": _gap(_tensor(av, dev), ref_av.double())}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}
